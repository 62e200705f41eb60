#!/usr/bin/env python3
"""Time the fp8 / int8 wire's table-gradient kernel, gather_quantize_bwd
(``csrc/wire_bwd.cu``), against an earlier version of its source, on one
NVIDIA GPU, on the same inputs.

    git show <commit>:src/repro_torch/csrc/wire_bwd.cu > build/old_wire_bwd.cu
    python3 scripts/wire_bwd_compare.py --other old=build/old_wire_bwd.cu [--sass]

(``build/`` is ignored by git.)  The current kernel ("new") is launched by
the package's wrapper; each ``--other NAME=PATH`` compiles that source out
of tree (``compare_common.py``) and is launched through the C signature it
had before its fold buffer was added (``OLD_SIGNATURES``: the table's
gradient zero-filled by the caller, then one launch that adds into it),
by its wrapper's code, checks and allocations included.  Cases, at qwen2-moe's d_model 2048
with a seeded top-4 routing over 60 experts of an EP world of 4:
"train_ht", the shape of chip_smoke's train-qwen2moe-ep fp8 steps (HT, 1,024
tokens a rank, 16,384 slots over a 4,097-row table, each token in one slot
of every rank its choices reach, the unfilled slots on the zero scratch
row); "ll_train", LL training's buckets (64 experts x 256 slots a rank,
65,536 slots with counts, a token in 4 slots); "serve_ht", the HT
dispatch of the served prefill (256 tokens a rank, 4,096 slots, 1,025
rows).  The scale gradients are seeded N(0, 1), 0 on slots of the
scratch row (dequantize_bwd gives 0 there: its bytes are 0).  Each
version is first held to ``gather_quantize_bwd_plain`` (the same nonzero
elements, values within 1e-6 of the range); then timed in turns (others,
new, new, others reversed): the whole call by CUDA events and by the
profiler's device time (the zero fills included), and the kernels alone
(the device time of the wire_bwd.cu kernels, ``KERNEL_NAMES``), beside
``chip_smoke.bound``, and the host's time to issue a call; and cold, each call on one of
``chip_smoke.COLD_CACHES`` tables.  ``--sass`` prints ptxas's register and
spill report.  One JSON line per result, the card's name and power limit
from nvidia-smi among them.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
import tempfile
from pathlib import Path

import numpy as np

import compare_common as cc

D_MODEL, RANKS, EXPERTS, E_PAD, TOP_K = 2048, 4, 60, 64, 4
LL_C = 256
# name: (tokens a rank, LL buckets or not)
CASES = {"train_ht": (1024, False), "ll_train": (1024, True),
         "serve_ht": (256, False)}
ENTRIES = ["gather_quantize_bwd_launch"]
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
OLD_SIGNATURES = {"gather_quantize_bwd_launch": [_P] * 5 + [_I] * 5
                  + [_F, _P]}
# the wire_bwd.cu kernels a version launches (the earlier source's one, the
# current source's two passes)
KERNEL_NAMES = ("gather_quantize_bwd_kernel", "fold_scales_kernel",
                "table_grad_kernel")


def dispatch(rng, case: str):
    """(table rows, src (slots,) int32, counts (buckets,) int32 or None)
    of one fp8 dispatch over the EP world."""
    T, ll = CASES[case]
    rows = RANKS * T
    if ll:
        counts = np.zeros((RANKS, E_PAD), np.int32)
        src = np.full((RANKS, E_PAD, LL_C), rows, np.int32)
        for r in range(RANKS):
            for t in range(T):
                for e in rng.choice(EXPERTS, TOP_K, replace=False):
                    if counts[r, e] < LL_C:
                        src[r, e, counts[r, e]] = r * T + t
                        counts[r, e] += 1
        return rows + 1, src.reshape(-1), counts.reshape(-1)
    src = np.full((RANKS, RANKS, T), rows, np.int32)
    for r in range(RANKS):
        fill = np.zeros(RANKS, int)
        for t in range(T):
            choices = rng.choice(EXPERTS, TOP_K, replace=False)
            for g in np.unique(choices // (E_PAD // RANKS)):
                src[r, g, fill[g]] = r * T + t
                fill[g] += 1
    return rows + 1, src.reshape(-1), None


def table(gen, rows: int):
    """(rows, D) fp32 N(0, 1) rows at magnitudes 1e-2..1e2, the last the
    zero scratch row."""
    import torch
    x = torch.randn((rows, D_MODEL), generator=gen, device=gen.device)
    x *= 10.0 ** (4 * torch.rand((rows, 1), generator=gen,
                                 device=gen.device) - 2)
    x[-1] = 0
    return x


def old_call(lib, x_ext, src_of_slot, counts, d_scales, wire_dtype):
    """The earlier source through its own C signature, by its wrapper's
    code (the same checks; the caller zero-fills the table's gradient,
    one launch adds into it)."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import quantize_pack as qp
    name = "gather_quantize_bwd"
    C, src, cnt, tensors = qp._check_gather(name, x_ext, src_of_slot,
                                            counts, wire_dtype)
    Tp1, D = x_ext.shape
    n_slots = src.shape[0]
    nb = qp.wire_layout(D, wire_dtype).n_blocks
    if tuple(d_scales.shape) != (n_slots, nb):
        raise ValueError(f"{name}: d_scales must be ({n_slots}, {nb})")
    ds = d_scales.to(torch.float32).contiguous()
    qp._check_cuda(name, d_scales=ds, **tensors)
    dx = torch.zeros_like(x_ext)
    with torch.cuda.device(x_ext.device):
        stream = torch.cuda.current_stream(x_ext.device).cuda_stream
        err = lib.gather_quantize_bwd_launch(
            x_ext.data_ptr(), src.data_ptr(),
            None if cnt is None else cnt.data_ptr(), ds.data_ptr(),
            dx.data_ptr(), Tp1, n_slots, C, D, nb,
            float(qp._QINV[wire_dtype]), stream)
    build.check(err, name + " (earlier source)")
    return dx


def kernels_alone(fn) -> tuple:
    """(device time of one ``fn()``'s wire_bwd.cu kernels, the zero fills
    left out; its device time by activity).  A trace that lost the
    kernels' records is taken again with twice the calls, up to three
    times; then the time is None (not measured)."""
    n = 10
    for _ in range(3):
        by = cc.device_ms_by_kernel(fn, n=n)
        t = sum(v for k, v in by.items() if any(m in k for m in KERNEL_NAMES))
        if t > 0:
            return t, by
        n *= 2
    return None, by


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=PATH", help="an earlier wire_bwd.cu")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("wire_bwd_compare: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import quantize_pack as qp

    cc.emit(cc.device_line())
    if args.sass:
        cc.emit({"sass": cc.sass_report([build.CSRC / "wire_bwd.cu"],
                                        ("fold_scales", "table_grad"))})
    dev = torch.device("cuda")
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"new": None}
        for other in args.other:
            name, path = other.split("=", 1)
            libs[name] = cc.load_other([Path(path)], Path(tmp), name,
                                       ENTRIES, OLD_SIGNATURES)
        rng = np.random.default_rng(0)
        gen = torch.Generator(device=dev).manual_seed(0)

        def call(lib, x, src, cnt, ds, wire):
            if lib is None:
                return qp.gather_quantize_bwd_cuda(x, src, cnt, ds,
                                                   wire_dtype=wire)
            return old_call(lib, x, src, cnt, ds, wire)
        for case in CASES:
            rows, src_np, cnt_np = dispatch(rng, case)
            src = torch.from_numpy(src_np).to(dev)
            cnt = None if cnt_np is None else torch.from_numpy(cnt_np).to(dev)
            x = table(gen, rows)
            nb = -(-D_MODEL // 128)
            ds = torch.randn((src.shape[0], nb), generator=gen, device=dev)
            ds[src == rows - 1] = 0
            for wire in ("fp8", "int8"):
                ref = qp.gather_quantize_bwd_plain(x, src, cnt, ds,
                                                   wire_dtype=wire)
                line = {"wire": wire, "case": case,
                        "slots": int(src.shape[0]), "table_rows": rows}
                for kn, lib in libs.items():
                    got = call(lib, x, src, cnt, ds, wire)
                    torch.cuda.synchronize()
                    err = float((got - ref).abs().max()) / float(
                        ref.abs().max())
                    good = bool(torch.equal(got != 0, ref != 0)) and err <= 1e-6
                    line[f"{kn}_rel_err"] = err
                    line[f"{kn}_same_nonzeros"] = good
                    ok &= good
                    del got
                bound_ms, bound_by, work = cs.bound(
                    "gather_quantize_bwd", (x, src, cnt, ds),
                    {"wire_dtype": wire})
                times, devt = cc.in_turns(
                    libs, lambda lib: call(lib, x, src, cnt, ds, wire))
                line.update(bound_ms=bound_ms, bound_by=bound_by, work=work)
                for kn, lib in libs.items():
                    line[f"{kn}_ms"] = times[kn]
                    line[f"{kn}_device_ms"] = devt[kn]
                    kt, by = kernels_alone(
                        lambda lib=lib: call(lib, x, src, cnt, ds, wire))
                    line[f"{kn}_kernel_device_ms"] = kt
                    line[f"{kn}_device_by_activity"] = by
                    line[f"{kn}_device_bound_share"] = bound_ms / min(
                        t for t in devt[kn] if t)
                    line[f"{kn}_kernel_bound_share"] = kt and bound_ms / kt
                    line[f"{kn}_host_ms"] = cc.host_ms(
                        lambda lib=lib: call(lib, x, src, cnt, ds, wire))
                sets = [table(gen, rows) for _ in range(cs.COLD_CACHES)]
                line.update({f"{kn}_cold_device_ms": cc.cold(
                    lambda lib=lib: [call(lib, xs, src, cnt, ds, wire)
                                     for xs in sets])
                    for kn, lib in libs.items()})
                del sets
                cc.emit(line)
    cc.emit({"ok": ok})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
