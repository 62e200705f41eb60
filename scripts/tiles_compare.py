#!/usr/bin/env python3
"""Time the four kernels of the grouped-expert tile loop
(``csrc/swiglu_tiles.cuh``: grouped_matmul, grouped_swiglu,
gather_swiglu_scatter, grouped_swiglu_db) against an earlier version of
their sources, on one NVIDIA GPU, on the same inputs.

    mkdir -p build/old_tiles
    for f in swiglu_tiles.cuh grouped_matmul.cu grouped_swiglu.cu \\
             gather_swiglu_scatter.cu grouped_swiglu_db.cu; do
      git show <commit>:src/repro_torch/csrc/$f > build/old_tiles/$f
    done
    python3 scripts/tiles_compare.py --other old=build/old_tiles [--sass]

(``build/`` is ignored by git; an earlier tile loop that includes
``hopper_common.cuh`` needs that header in the directory too; a
``grouped_swiglu_db.cu`` from before it ran on the tile loop is a source
of its own.)  The current kernels ("new") come from the package's build;
each ``--other NAME=DIR`` compiles DIR's four ``.cu`` files out of tree
and runs them through the package's own wrappers
(``compare_common.py``).  Inputs are
seeded N(0, 1) values at the shapes qwen2-moe serves (64 experts, D 2048,
F 1408): the grouped matmul on the HT buffer (64, 128, 2048) @ (64, 2048,
1408), ``grouped_swiglu_db`` on the same buffer (the HT expert compute of
a plain expert_fn under ``REPRO_SWIGLU_DB=1``) and ``gather_swiglu_scatter``
on 1024 tokens x top-4 at capacity 128, all with per-expert counts of a
seeded uniform top-4 routing;
``grouped_swiglu`` at the LL decode shape (64, 64, 2048) with (64, 4)
bucketed counts, 16 tokens (4 from each of 4 source ranks) routed top-4
among 15 experts.  Each version is held to the plain version at
``chip_smoke.KERNEL_TOL`` (max error over max |plain|, and exact zeros in
the unoccupied rows of a stored output), then timed in turns (others, new,
new, others reversed): CUDA-event medians and profiler device times,
beside ``torch.bmm`` over the whole buffer for the grouped matmul and each
call's bound from ``chip_smoke.bound``; and each version's host time per
call (the median of the profiler's CPU time of a span around the
wrapper) and device time by kernel (the two passes apart).  ``--sass``
prints ptxas's register, spill and shared-memory report for the four
sources' kernels and counts their HGMMA (wgmma) and HMMA (mma.sync) instructions.
One JSON line per result, the card's name and power limit from nvidia-smi
among them.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

import compare_common as cc

E, D, F, K_TOP = 64, 2048, 1408, 4
HT_TOKENS, HT_C = 1024, 128
LL_RANKS, LL_TOKENS_PER_RANK, LL_EXPERTS, LL_C = 4, 4, 15, 64
SOURCES = ("grouped_matmul.cu", "grouped_swiglu.cu",
           "gather_swiglu_scatter.cu", "grouped_swiglu_db.cu")
ENTRIES = [s.replace(".cu", "_launch") for s in SOURCES]


def ht_routing(rng):
    """(src (E*C,) token per slot, T for empty; counts (E,)): each token's
    top-4 distinct experts, uniform, slots filled in token order up to C."""
    src = np.full((E, HT_C), HT_TOKENS, dtype=np.int32)
    counts = np.zeros(E, dtype=np.int32)
    for t in range(HT_TOKENS):
        for e in rng.choice(E, K_TOP, replace=False):
            if counts[e] < HT_C:
                src[e, counts[e]] = t
                counts[e] += 1
    return src.reshape(-1), counts


def ll_counts(rng):
    """(E, ranks) per-source counts: 16 tokens, each to 4 distinct experts
    of 15 chosen ones."""
    counts = np.zeros((E, LL_RANKS), dtype=np.int32)
    experts = rng.choice(E, LL_EXPERTS, replace=False)
    for r in range(LL_RANKS):
        for _ in range(LL_TOKENS_PER_RANK):
            for e in rng.choice(experts, K_TOP, replace=False):
                counts[e, r] += 1
    return counts


def cases(torch, gm):
    """(kernel name, wrapper, args, dead-row mask or None) at the served
    shapes."""
    rng = np.random.default_rng(0)
    dev = "cuda"

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(dev, torch.bfloat16)

    src, cnt = ht_routing(rng)
    counts = torch.from_numpy(cnt).to(dev)
    wg, wu, wd = normal(E, D, F), normal(E, D, F), normal(E, F, D)
    x_buf = normal(E, HT_C, D)
    dead = ~gm.occupancy_mask(counts, E, HT_C)
    out = [("grouped_matmul", gm.grouped_matmul_cuda,
            (x_buf, wg, counts), dead),
           ("grouped_swiglu_db", gm.grouped_swiglu_db_cuda,
            (x_buf, wg, wu, wd, counts), dead)]
    x_ext = normal(HT_TOKENS + 1, D)
    x_ext[HT_TOKENS] = 0
    w_slot = torch.from_numpy(rng.random(E * HT_C, dtype=np.float32)).to(dev)
    out.append(("gather_swiglu_scatter", gm.gather_swiglu_scatter_cuda,
                (x_ext, torch.from_numpy(src).to(dev), w_slot, wg, wu, wd,
                 counts), None))
    ll = torch.from_numpy(ll_counts(rng)).to(dev)
    out.append(("grouped_swiglu", gm.grouped_swiglu_cuda,
                (normal(E, LL_C, D), wg, wu, wd, ll),
                ~gm.occupancy_mask(ll, E, LL_C)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=DIR",
                    help="a directory holding an earlier tile loop's sources")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("tiles_compare: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import grouped_matmul as gm

    cc.emit(cc.device_line())
    if args.sass:
        cc.emit({"sass": cc.sass_report([build.CSRC / s for s in SOURCES],
                                        ("swiglu_tiles",))})
    libs = {"new": None}
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for other in args.other:
            name, path = other.split("=", 1)
            libs[name] = cc.load_other([Path(path) / s for s in SOURCES],
                                       Path(tmp), name, ENTRIES)
        for name, wrapper, a, dead in cases(torch, gm):
            def call(lib):
                with cc.using_library(lib):
                    return wrapper(*a)

            plain = getattr(gm, name + "_plain")
            ref = plain(*a).float()
            tol = cs.KERNEL_TOL[name]
            line = {"kernel": name, "shapes": [list(t.shape) for t in a],
                    "tol": tol}
            for kn, lib in libs.items():
                got = call(lib).float()
                torch.cuda.synchronize()
                err = float((got - ref).abs().max() / ref.abs().max())
                zeros = dead is None or bool((got[dead] == 0).all())
                line[f"{kn}_rel_err"] = err
                line[f"{kn}_dead_rows_zero"] = zeros
                ok &= bool(torch.isfinite(got).all()) and err <= tol and zeros
            bound_ms, bound_by, work = cs.bound(name, a, {})
            times, dev = cc.in_turns(libs, call)
            line.update({f"{kn}_ms": times[kn] for kn in libs})
            line.update({f"{kn}_device_ms": dev[kn] for kn in libs})
            line.update({f"{kn}_host_ms": cc.host_ms(lambda: call(lib))
                         for kn, lib in libs.items()})
            line.update({f"{kn}_device_ms_by_kernel": cc.device_ms_by_kernel(
                lambda: call(lib)) for kn, lib in libs.items()})
            line.update(bound_ms=bound_ms, bound_by=bound_by, work=work)
            for kn in libs:
                line[f"{kn}_bound_share"] = bound_ms / min(
                    t for t in dev[kn] if t)
            lib_call = cs.library_call(name, a, {})
            if lib_call is not None:
                line.update(library="torch.bmm (whole buffer)",
                            library_ms=cs.cuda_ms(lib_call),
                            library_device_ms=cs.device_ms(lib_call))
            cc.emit(line)
    cc.emit({"ok": ok})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
