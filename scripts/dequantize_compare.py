#!/usr/bin/env python3
"""Time the fp8 / int8 wire's dequantize kernel (``csrc/dequantize.cu``)
against an earlier version of its source, on one NVIDIA GPU, on the same
inputs.

    git show <commit>:src/repro_torch/csrc/dequantize.cu > build/old_dq.cu
    python3 scripts/dequantize_compare.py --other old=build/old_dq.cu [--sass]

(``build/`` is ignored by git.)  The current kernel ("new") comes from the
package's build; each ``--other NAME=PATH`` compiles that source out of
tree (``compare_common.py``) under the same C entry point, and the
package's wrapper launches it (``using_library``).  Shapes: qwen2-moe's
dispatch at ``chip_smoke.py``'s served shape, (4096 slots, 2048), which the
HT prefill and the LL decode step both receive (the LL slots past their
counts are zero bytes with zero scales), and a quarter of it, (1024,
2048), where the launch's ramp weighs more; each in both wire dtypes, its
bytes those of seeded N(0, 1) rows quantized by the plain codec, with the
LL case's empty slots as the decode step leaves them (64 of 4096
occupied).  First each
version's output against ``dequantize_plain``, bit for bit (int32 views,
so NaN encodings compare too); then each timed in turns (others, new, new,
others reversed): CUDA-event medians and profiler device times, beside
``chip_smoke.bound``; and cold, each call on one of
``chip_smoke.COLD_CACHES`` input sets (8 x 42 MB at 4096 rows, past the 50
MB L2).  ``--sass`` prints ptxas's register and spill report for the new
kernel.  One JSON line per result, the card's name and power limit from
nvidia-smi among them.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import compare_common as cc

D_MODEL = 2048
# (name, rows, occupied rows): the served dispatch (HT), the decode step's
# (LL: 64 occupied slots), and a quarter of the slots
CASES = (("ht", 4096, 4096), ("ll", 4096, 64), ("ll_1024", 1024, 1024))
ENTRIES = ["dequantize_launch"]


def wire_inputs(gen, rows: int, occupied: int, wire: str):
    """(q, scales): ``occupied`` seeded N(0, 1) rows quantized by the plain
    codec, the rest zero bytes with zero scales."""
    import torch

    from repro_torch.core.transport.codec import quantize_blocked
    x = torch.randn((rows, D_MODEL), generator=gen, device=gen.device)
    x[occupied:] = 0
    return quantize_blocked(x, wire)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=PATH", help="another dequantize.cu")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("dequantize_compare: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import quantize_pack as qp

    cc.emit(cc.device_line())
    if args.sass:
        cc.emit({"sass": cc.sass_report([build.CSRC / "dequantize.cu"],
                                        ("dequantize",))})
    dev = torch.device("cuda")
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"new": None}
        for other in args.other:
            name, path = other.split("=", 1)
            libs[name] = cc.load_other([Path(path)], Path(tmp), name,
                                       ENTRIES)
        gen = torch.Generator(device=dev).manual_seed(0)

        def call(lib, q, s):
            with cc.using_library(lib):
                return qp.dequantize_cuda(q, s)
        for wire in ("fp8", "int8"):
            for case, rows, occupied in CASES:
                q, s = wire_inputs(gen, rows, occupied, wire)
                ref = qp.dequantize_plain(q, s).view(torch.int32)
                line = {"wire": wire, "case": case, "shape": [rows, D_MODEL],
                        "occupied_rows": occupied}
                for kn, lib in libs.items():
                    same = torch.equal(call(lib, q, s).view(torch.int32), ref)
                    line[f"{kn}_bit_exact"] = same
                    ok &= same
                bound_ms, bound_by, work = cs.bound("dequantize", (q, s), {})
                times, devt = cc.in_turns(libs, lambda fn: call(fn, q, s))
                line.update(bound_ms=bound_ms, bound_by=bound_by, work=work)
                line.update({f"{kn}_ms": times[kn] for kn in libs})
                line.update({f"{kn}_device_ms": devt[kn] for kn in libs})
                for kn in libs:
                    line[f"{kn}_device_bound_share"] = bound_ms / min(
                        t for t in devt[kn] if t)
                sets = [wire_inputs(gen, rows, occupied, wire)
                        for _ in range(cs.COLD_CACHES)]
                line.update({f"{kn}_cold_device_ms": cc.cold(
                    lambda lib=lib: [call(lib, *qs) for qs in sets])
                    for kn, lib in libs.items()})
                cc.emit(line)
    cc.emit({"ok": ok})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
