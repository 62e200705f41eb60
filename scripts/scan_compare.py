#!/usr/bin/env python3
"""Time the selective scan's kernels (``scan_fwd_kernel`` and
``scan_bwd_kernel`` of ``csrc/mamba_scan.cu``) against an earlier version
of their source, on one NVIDIA GPU, on the same inputs; and optionally the
training step through each.

    git show <commit>:src/repro_torch/csrc/mamba_scan.cu > build/old_scan.cu
    python3 scripts/scan_compare.py --other old=build/old_scan.cu \\
        [--sass] [--train]

(``build/`` is ignored by git.)  The current kernels ("new") come from the
package's build; each ``--other NAME=PATH`` compiles that source out of
tree (``compare_common.py``) under the same C entry points, and the
package's wrappers launch it (``using_library``).  First every version's
forward (y and the saved chunk states against the plain recurrence, each
within ``chip_smoke.KERNEL_TOL["mamba_scan"]`` of its largest value) and
six gradients (against ``torch.autograd.grad`` through
``mamba_scan_plain``, each within ``KERNEL_TOL["mamba_scan_bwd"]``) at a
reduced shape (2, 200, 136), and the forward at the slowest decays (dt
0.001, a = -0.5: (1, 4096, 64); y against the plain version, the states
against the float64 recurrence within twice the fp32 plain version's own
error).  Then, at the trained shape (Bt 4, S
1024, Di 8192: falcon-mamba-7b's d_inner at batch 4 x 1024), seeded inputs
in the model's ranges (x, B, C, D and dy N(0, 1); dt uniform in [0.001,
0.1], the span of Mamba's dt init; A = -(1..16) times a per-channel U(0.5,
1.5), as ``-exp(A_log)`` starts): the forward saving its chunk states (as
every training call does) and the backward from them, each version timed
in turns (others, new, new, others reversed), CUDA-event medians and
profiler device times, beside ``chip_smoke.scan_bound``; and cold, each
call on one of ``chip_smoke.COLD_CACHES`` input sets (670 MB each, past
the 50 MB L2).  There is no PyTorch call that computes the scan.
``--train`` then runs chip_smoke's training path
(``chip_smoke.train_setup``: falcon-mamba-7b, full width, 16 layers, batch
4 x 1024, 5 AdamW steps; fresh weights from seed 0 each turn) through each
version's library in the same turns, and reports each turn's step seconds
and tokens/s over the steps after the first.  ``--sass`` prints ptxas's
register, spill and shared-memory report for the new kernels.  One JSON
line per result, the card's name and power limit from nvidia-smi among
them.
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
SLOW_SHAPE = (1, 4096, 64)      # dt 0.001, a = -0.5: ~2,000 steps of memory
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


def rel_err(got, ref) -> float:
    return float((got - ref).abs().max()) / float(ref.abs().max())


def check(libs: dict, gen) -> tuple[dict, bool]:
    """Each version's forward (y and states) against the plain recurrence,
    here and at the slowest decays, and its gradients against autograd
    through the plain scan."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import mamba_scan as ms
    *ins, dy = scan_inputs(gen, *CHECK_SHAPE)
    ref = ms.mamba_scan_bwd_plain(*ins, None, dy)
    slow = list(scan_inputs(gen, *SLOW_SHAPE)[:6])
    slow[1] = torch.full_like(slow[1], 1e-3)
    slow[2] = torch.full_like(slow[2], -0.5)
    fwd_refs = {"": ms.mamba_scan_plain(*ins, with_states=True),
                "slow_": ms.mamba_scan_plain(*slow, with_states=True)}
    # at the slowest decays the fp32 recurrence drifts from the exact one
    # over its ~2,000-step memory: the states are held to float64, within
    # twice the fp32 plain version's own error
    exact = ms.mamba_scan_plain(*[t.double() for t in slow],
                                with_states=True)[1]
    slow_tol = 2 * rel_err(fwd_refs["slow_"][1].double(), exact)
    tol, ftol = cs.KERNEL_TOL["mamba_scan_bwd"], cs.KERNEL_TOL["mamba_scan"]
    line = {"check_shape": list(CHECK_SHAPE), "slow_shape": list(SLOW_SHAPE),
            "tol": tol, "fwd_tol": ftol, "slow_states_tol_vs_float64":
            slow_tol}
    ok = True
    for kn, lib in libs.items():
        with cc.using_library(lib):
            for tag, args in (("", ins), ("slow_", slow)):
                got = ms._scan_fwd(*args, save_states=True)
                for n, g, r in zip(("y", "states"), got, fwd_refs[tag]):
                    e = rel_err(g, r)
                    line[f"{kn}_{tag}{n}_rel_err"] = e
                    lim = ftol
                    if tag and n == "states":
                        e = rel_err(g.double(), exact)
                        line[f"{kn}_slow_states_rel_err_vs_float64"] = e
                        lim = slow_tol
                    ok &= bool(torch.isfinite(g).all()) and e <= lim
            _, states = ms._scan_fwd(*ins, save_states=True)
            got = ms.mamba_scan_bwd_cuda(*ins, states, dy)
        torch.cuda.synchronize()
        for n, g, r in zip(GRADS, got, ref):
            e = rel_err(g, r)
            line[f"{kn}_{n}_rel_err"] = e
            ok &= bool(torch.isfinite(g).all()) and e <= tol
    return line, ok


def timed(libs: dict, name: str, call, bound) -> dict:
    """One kernel of each version, in turns, beside its bound."""
    bound_ms, bound_by, work = bound
    times, devt = cc.in_turns(libs, call)
    line = {"kernel": name, "shape": list(SHAPE), "bound_ms": bound_ms,
            "bound_by": bound_by, "work": work}
    line.update({f"{kn}_ms": times[kn] for kn in libs})
    line.update({f"{kn}_device_ms": devt[kn] for kn in libs})
    for kn in libs:
        line[f"{kn}_device_bound_share"] = bound_ms / min(
            t for t in devt[kn] if t)
    return line


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
        line, ok = check(libs, gen)
        cc.emit(line)

        def inputs():
            *ins, dy = scan_inputs(gen, *SHAPE)
            _, states = ms._scan_fwd(*ins, save_states=True)
            return ins, states, dy
        ins, states, dy = inputs()

        def fwd(lib, ins=ins, states=None, dy=None):
            with cc.using_library(lib):
                return ms._scan_fwd(*ins, save_states=True)

        def bwd(lib, ins=ins, states=states, dy=dy):
            with cc.using_library(lib):
                return ms.mamba_scan_bwd_cuda(*ins, states, dy)
        lines = [timed(libs, "mamba_scan", fwd,
                       cs.scan_bound("mamba_scan", ins, save_states=True)),
                 timed(libs, "mamba_scan_bwd", bwd,
                       cs.scan_bound("mamba_scan_bwd", (*ins, states)))]
        del ins, states, dy
        sets = [inputs() for _ in range(cs.COLD_CACHES)]
        for line, call in zip(lines, (fwd, bwd)):
            line.update({f"{kn}_cold_device_ms": cc.cold(
                lambda lib=lib, call=call: [call(lib, *s) for s in sets])
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
