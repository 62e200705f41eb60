#!/usr/bin/env python3
"""Time the selective scan's backward kernel (``scan_bwd_kernel`` of
``csrc/mamba_scan.cu``) against an earlier version of its source, on one
NVIDIA GPU, on the same inputs; and optionally the training step through
each.

    git show <commit>:src/repro_torch/csrc/mamba_scan.cu > build/old_scan.cu
    python3 scripts/scan_compare.py --other old=build/old_scan.cu \\
        [--sass] [--train]

(``build/`` is ignored by git.)  The current kernels ("new") come from the
package's build; each ``--other NAME=PATH`` compiles that source out of
tree (``compare_common.py``) under the same C entry points, and the
package's wrappers launch it (``using_library``).  First every version's
six gradients at a reduced shape (2, 200, 136) against
``torch.autograd.grad`` through ``mamba_scan_plain``, each within
``chip_smoke.KERNEL_TOL["mamba_scan_bwd"]`` of its largest value.  Then,
at the trained shape (Bt 4, S 1024, Di 8192: falcon-mamba-7b's d_inner at
batch 4 x 1024), seeded inputs in the model's ranges (x, B, C, D and dy
N(0, 1); dt uniform in [0.001, 0.1], the span of Mamba's dt init; A =
-(1..16) times a per-channel U(0.5, 1.5), as ``-exp(A_log)`` starts) and
the chunk states the forward kernel saves: each version timed in turns
(others, new, new, others reversed), CUDA-event medians and profiler
device times, beside ``chip_smoke.scan_bound``; and cold, each call on
one of ``chip_smoke.COLD_CACHES`` input sets (670 MB each, past the 50 MB
L2).  There is no PyTorch call that computes the scan.  ``--train`` then
runs chip_smoke's training path (``chip_smoke.train_setup``:
falcon-mamba-7b, full width, 16 layers, batch 4 x 1024, 5 AdamW steps;
fresh weights from seed 0 each turn) through each version's library in the
same turns, and reports each turn's step seconds and tokens/s over the
steps after the first.
``--sass`` prints ptxas's register, spill and shared-memory report for
the new kernels.  One JSON line per result, the card's name and power
limit from nvidia-smi among them.
"""
from __future__ import annotations

import argparse
import gc
import sys
import tempfile
from pathlib import Path

import compare_common as cc

SHAPE = (4, 1024, 8192)
CHECK_SHAPE = (2, 200, 136)
ENTRIES = ["mamba_scan_fwd_launch", "mamba_scan_bwd_launch"]
GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD")


def scan_inputs(gen, Bt, S, Di, N=16):
    """(x, dt, A, B, C, D, dy) on the card, in the model's ranges."""
    import torch
    dev = gen.device
    f = dict(generator=gen, device=dev)
    x = torch.randn((Bt, S, Di), **f)
    dt = torch.rand((Bt, S, Di), **f) * (0.1 - 1e-3) + 1e-3
    A = -torch.arange(1, N + 1, device=dev, dtype=torch.float32) * (
        0.5 + torch.rand((Di, 1), **f))
    B, C = torch.randn((Bt, S, N), **f), torch.randn((Bt, S, N), **f)
    D = torch.randn((Di,), **f)
    dy = torch.randn((Bt, S, Di), **f)
    return x, dt, A, B, C, D, dy


def check_grads(libs: dict, gen) -> tuple[dict, bool]:
    """Each version's gradients against autograd through the plain scan."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import mamba_scan as ms
    *ins, dy = scan_inputs(gen, *CHECK_SHAPE)
    ref = ms.mamba_scan_bwd_plain(*ins, None, dy)
    tol = cs.KERNEL_TOL["mamba_scan_bwd"]
    line, ok = {"check_shape": list(CHECK_SHAPE), "tol": tol}, True
    for kn, lib in libs.items():
        with cc.using_library(lib):
            _, states = ms._scan_fwd(*ins, save_states=True)
            got = ms.mamba_scan_bwd_cuda(*ins, states, dy)
        torch.cuda.synchronize()
        for n, g, r in zip(GRADS, got, ref):
            e = float((g - r).abs().max()) / float(r.abs().max())
            line[f"{kn}_{n}_rel_err"] = e
            ok &= bool(torch.isfinite(g).all()) and e <= tol
    return line, ok


def train_turn(lib) -> dict:
    """chip_smoke's training path (``train_setup``) through ``lib``."""
    import torch

    import chip_smoke as cs
    from repro_torch.training.train_loop import init_state
    cfg, hp, batch = cs.train_setup()
    dev = torch.device("cuda")
    with cc.using_library(lib):
        state = init_state(cfg, seed=0, device=dev)
        state, hist, secs = cs.train_steps(cfg, hp, batch, state, dev)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    tokens = cs.TRAIN_BATCH * cs.TRAIN_SEQ * (hp.total_steps - 1)
    return {"steps": hp.total_steps, "step_s": secs,
            "losses": [h["loss"] for h in hist],
            "tokens_per_s_after_first": tokens / sum(secs[1:])}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=PATH", help="another mamba_scan.cu")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--train", action="store_true")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("scan_compare: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import mamba_scan as ms

    cc.emit(cc.device_line())
    if args.sass:
        cc.emit({"sass": cc.sass_report([build.CSRC / "mamba_scan.cu"],
                                        ("scan",))})
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"new": None}
        for other in args.other:
            name, path = other.split("=", 1)
            libs[name] = cc.load_other([Path(path)], Path(tmp), name,
                                       ENTRIES)
        gen = torch.Generator(device=dev).manual_seed(0)
        line, ok = check_grads(libs, gen)
        cc.emit(line)

        def inputs():
            *ins, dy = scan_inputs(gen, *SHAPE)
            _, states = ms._scan_fwd(*ins, save_states=True)
            return ins, states, dy
        ins, states, dy = inputs()

        def bwd(lib, ins=ins, states=states, dy=dy):
            with cc.using_library(lib):
                return ms.mamba_scan_bwd_cuda(*ins, states, dy)
        bound_ms, bound_by, work = cs.scan_bound("mamba_scan_bwd",
                                                 (*ins, states))
        times, devt = cc.in_turns(libs, bwd)
        line = {"shape": list(SHAPE), "bound_ms": bound_ms,
                "bound_by": bound_by, "work": work}
        line.update({f"{kn}_ms": times[kn] for kn in libs})
        line.update({f"{kn}_device_ms": devt[kn] for kn in libs})
        for kn in libs:
            line[f"{kn}_device_bound_share"] = bound_ms / min(
                t for t in devt[kn] if t)
        del ins, states, dy
        sets = [inputs() for _ in range(cs.COLD_CACHES)]
        line.update({f"{kn}_cold_device_ms": cc.cold(
            lambda lib=lib: [bwd(lib, *s) for s in sets])
            for kn, lib in libs.items()})
        cc.emit(line)
        del sets
        gc.collect()
        torch.cuda.empty_cache()
        if args.train:
            others = [k for k in libs if k != "new"]
            for kn in others + ["new", "new"] + others[::-1]:
                cc.emit({"train": kn, **train_turn(libs[kn])})
    cc.emit({"ok": ok})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
