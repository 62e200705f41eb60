#!/usr/bin/env python3
"""Time the fp8 / int8 wire's gather-quantize kernel
(``csrc/gather_quantize.cu``) against an earlier version of its source, on
one NVIDIA GPU, on the same inputs.

    git show <commit>:src/repro_torch/csrc/gather_quantize.cu > build/old_gq.cu
    python3 scripts/quantize_compare.py --other old=build/old_gq.cu [--sass]

(``build/`` is ignored by git.)  The current kernel ("new") comes from the
package's build; each ``--other NAME=PATH`` compiles that source out of
tree (``compare_common.py``) under the same C entry point, and the
package's wrapper launches it (``using_library``).  Cases, at qwen2-moe's
d_model 2048 and the dispatch shapes ``chip_smoke.py`` serves (EP world of
4, 60 experts, top 4): "ht", the HT prefill's 4096 slots, 1024 tokens
each sent once to every rank its seeded top-4 choices reach (256 slots a
(rank, destination), no counts: the unfilled slots name the zero scratch
row); "ll", the LL decode step's 4096 slots in 256 buckets of 16, 64
occupied by 16 tokens x top 4; "ht_1024", the HT dispatch of 256 tokens
(1024 slots), where the launch's ramp weighs more.  Each in both wire
dtypes, the token tables seeded N(0, 1) rows at seeded magnitudes.  First
each version's bytes and scales against ``gather_quantize_plain``, bit for
bit; then each timed in turns (others, new, new, others reversed):
CUDA-event medians and profiler device times, beside ``chip_smoke.bound``;
and cold, each call on one of ``chip_smoke.COLD_CACHES`` token tables (8 x
8.4 MB at 1024 tokens).  ``--sass`` prints ptxas's register and spill
report for the new kernel.  One JSON line per result, the card's name and
power limit from nvidia-smi among them.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

import compare_common as cc

D_MODEL, RANKS, EXPERTS, TOP_K = 2048, 4, 60, 4
LL_BUCKETS, LL_C, LL_TOKENS = 256, 16, 16
# name: tokens a rank (HT) or None (LL)
CASES = {"ht": 256, "ll": None, "ht_1024": 64}
ENTRIES = ["gather_quantize_launch"]


def dispatch(rng, case: str):
    """(table rows, src (slots,) int32, counts (buckets,) int32 or None)."""
    T = CASES[case]
    if T is None:
        counts = np.zeros(LL_BUCKETS, np.int32)
        for _ in range(LL_TOKENS):
            for b in rng.choice(LL_BUCKETS, TOP_K, replace=False):
                counts[b] += 1
        occ = np.arange(LL_C)[None, :] < counts[:, None]
        src = np.full((LL_BUCKETS, LL_C), LL_TOKENS, np.int32)
        src[occ] = rng.integers(0, LL_TOKENS, int(occ.sum()))
        return LL_TOKENS + 1, src.reshape(-1), counts
    src = np.full((RANKS, RANKS, T), RANKS * T, np.int32)
    for r in range(RANKS):
        fill = np.zeros(RANKS, int)
        for t in range(T):
            choices = rng.choice(EXPERTS, TOP_K, replace=False)
            for g in np.unique(choices // (EXPERTS // RANKS)):
                src[r, g, fill[g]] = r * T + t
                fill[g] += 1
    return RANKS * T + 1, src.reshape(-1), None


def table(gen, rows: int):
    """(rows, D) fp32 N(0, 1) rows at magnitudes 1e-2..1e2, the last the
    zero scratch row."""
    import torch
    x = torch.randn((rows, D_MODEL), generator=gen, device=gen.device)
    x *= 10.0 ** (4 * torch.rand((rows, 1), generator=gen,
                                 device=gen.device) - 2)
    x[-1] = 0
    return x


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=PATH", help="another gather_quantize.cu")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("quantize_compare: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import quantize_pack as qp

    cc.emit(cc.device_line())
    if args.sass:
        cc.emit({"sass": cc.sass_report([build.CSRC / "gather_quantize.cu"],
                                        ("gather_quantize",))})
    dev = torch.device("cuda")
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"new": None}
        for other in args.other:
            name, path = other.split("=", 1)
            libs[name] = cc.load_other([Path(path)], Path(tmp), name,
                                       ENTRIES)
        rng = np.random.default_rng(0)
        gen = torch.Generator(device=dev).manual_seed(0)

        def call(lib, x, src, cnt, wire):
            with cc.using_library(lib):
                return qp.gather_quantize_cuda(x, src, cnt, wire_dtype=wire)
        for case in CASES:
            rows, src_np, cnt_np = dispatch(rng, case)
            src = torch.from_numpy(src_np).to(dev)
            cnt = None if cnt_np is None else torch.from_numpy(cnt_np).to(dev)
            x = table(gen, rows)
            for wire in ("fp8", "int8"):
                q_ref, s_ref = qp.gather_quantize_plain(x, src, cnt,
                                                        wire_dtype=wire)
                line = {"wire": wire, "case": case,
                        "slots": int(src.shape[0]), "table_rows": rows}
                for kn, lib in libs.items():
                    q, s = call(lib, x, src, cnt, wire)
                    same = (torch.equal(q.view(torch.uint8),
                                        q_ref.view(torch.uint8))
                            and torch.equal(s.view(torch.int32),
                                            s_ref.view(torch.int32)))
                    line[f"{kn}_bit_exact"] = same
                    ok &= same
                bound_ms, bound_by, work = cs.bound("gather_quantize",
                                                    (x, src, cnt), {})
                times, devt = cc.in_turns(
                    libs, lambda fn: call(fn, x, src, cnt, wire))
                line.update(bound_ms=bound_ms, bound_by=bound_by, work=work)
                line.update({f"{kn}_ms": times[kn] for kn in libs})
                line.update({f"{kn}_device_ms": devt[kn] for kn in libs})
                for kn in libs:
                    line[f"{kn}_device_bound_share"] = bound_ms / min(
                        t for t in devt[kn] if t)
                sets = [table(gen, rows) for _ in range(cs.COLD_CACHES)]
                line.update({f"{kn}_cold_device_ms": cc.cold(
                    lambda lib=lib: [call(lib, xs, src, cnt, wire)
                                     for xs in sets])
                    for kn, lib in libs.items()})
                cc.emit(line)
    cc.emit({"ok": ok})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
