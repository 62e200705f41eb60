#!/usr/bin/env python3
"""Time the two SwiGLU backward kernels (``csrc/swiglu_bwd.cu``:
``grouped_swiglu_bwd`` and ``gather_swiglu_scatter_bwd``) against an
earlier version of that source, on one NVIDIA GPU, on the same inputs.

    git show <commit>:src/repro_torch/csrc/swiglu_bwd.cu > build/old_bwd.cu
    python3 scripts/swiglu_bwd_compare.py --other old=build/old_bwd.cu [--sass]

(``build/`` is ignored by git.) The current kernels ("new") come from the
package's build, through its wrappers. Each ``--other NAME=PATH`` is
compiled out of tree (``compare_common.py``) and launched through its own
C signature, the one before the scratch of the wgmma passes was added
(``OLD_SIGNATURES``), with the allocations its wrapper made. Inputs are
the training shapes of chip_smoke's train-qwen2moe-ep (qwen2-moe at full
width: 64 experts, D 2048, F 1408; seeded N(0, 1) activations, weights
scaled by D^-0.5): HT's fused call over 32,768 slots (64 experts x C 512)
from a 4,097-row token table, a seeded top-4 routing of 4,096 tokens over
60 experts of log-normal popularity (sigma 0.6), slots filled in token
order up to C (15,762 occupied); LL's (64, 1024, 2048) buffer with (64, 4)
sub-bucket counts, 4 source ranks of 1,024 tokens routed top-4 over 60
experts, at most 256 a sub-bucket (16,336 rows). Each version is held to
the plain backward at ``chip_smoke.KERNEL_TOL`` (each gradient's max error
over its max |plain|; LL's dx exact zeros past the counts), then timed in
turns (others, new, new, others reversed): CUDA-event medians and profiler
device times, beside the call's bound from ``chip_smoke.bound``, and each
version's cold device time (each call on one of ``chip_smoke.COLD_CACHES``
sets of the activations and upstream), host time per call and device time
by kernel (the passes apart). ``--sass`` prints ptxas's register, spill
and shared-memory report for the current source's kernels and each
other's, and counts their HGMMA (wgmma) and HMMA (mma.sync) instructions.
``--train DIR`` then runs chip_smoke's train-qwen2moe-ep phase from an
earlier checkout (``git archive <commit> | tar -x -C DIR``, DIR in
``build/``) and from this tree, each in a process of its own, in turns
(parent, new, new, parent): tokens/s, step seconds, peak memory and the
profiled HT step's device time by kind. One JSON line per result, the
card's name and power limit from nvidia-smi among them.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

import compare_common as cc
from repro_torch.kernels.build import _I, _P

E, D, F, TOP_K, EXPERTS = 64, 2048, 1408, 4, 60
HT_TOKENS, HT_C, HT_SIGMA = 4096, 512, 0.6
LL_RANKS, LL_TOKENS, LL_C = 4, 1024, 1024
ENTRIES = ["grouped_swiglu_bwd_launch", "gather_swiglu_scatter_bwd_launch"]
# the C signatures of the four-pass mma.sync source, before the wgmma
# passes' scratch
OLD_SIGNATURES = {"grouped_swiglu_bwd_launch": [_P] * 13 + [_I] * 5 + [_P],
                  "gather_swiglu_scatter_bwd_launch": [_P] * 16 + [_I] * 5
                  + [_P]}


def routing(rng, tokens: int):
    """(tokens, TOP_K) distinct experts a token, among the first EXPERTS of
    E, by log-normal popularity."""
    pop = np.exp(HT_SIGMA * rng.standard_normal(EXPERTS))
    g = np.log(pop / pop.sum())[None, :] + rng.gumbel(size=(tokens, EXPERTS))
    return np.argsort(-g, axis=1)[:, :TOP_K]


def ht_slots(rng):
    """(src (E*C,) token per slot, T for empty; counts (E,)): slots filled
    in token order up to C."""
    src = np.full((E, HT_C), HT_TOKENS, dtype=np.int32)
    counts = np.zeros(E, dtype=np.int32)
    for t, es in enumerate(routing(rng, HT_TOKENS)):
        for e in es:
            if counts[e] < HT_C:
                src[e, counts[e]] = t
                counts[e] += 1
    return src.reshape(-1), counts


def ll_counts(rng):
    """(E, ranks) rows each source rank sends each expert."""
    counts = np.zeros((E, LL_RANKS), dtype=np.int32)
    for r in range(LL_RANKS):
        counts[:, r] = np.bincount(routing(rng, LL_TOKENS).reshape(-1),
                                   minlength=E)
    return np.minimum(counts, LL_C // LL_RANKS)


def cases(torch, dev):
    """(kernel name, args) at the training shapes, and the activations and
    upstream a cold call replaces (their positions in args)."""
    rng = np.random.default_rng(0)

    def normal(shape, s=1.0, dtype=torch.bfloat16):
        return torch.from_numpy((rng.standard_normal(shape, dtype=np.float32)
                                 * s)).to(dev, dtype)

    src, cnt = ht_slots(np.random.default_rng(1))
    ll = torch.from_numpy(ll_counts(np.random.default_rng(2))).to(dev)
    ws = [normal(sh, D ** -0.5) for sh in ((E, D, F), (E, D, F), (E, F, D))]
    x_ext = normal((HT_TOKENS + 1, D))
    x_ext[HT_TOKENS] = 0
    w_slot = torch.from_numpy(rng.random(E * HT_C, dtype=np.float32)).to(dev)
    dout = normal((HT_TOKENS, D), 1e-2, torch.float32)
    ht = (torch.from_numpy(src).to(dev), w_slot,
          torch.from_numpy(cnt).to(dev))
    return [("gather_swiglu_scatter_bwd",
             (x_ext, ht[0], ht[1], *ws, ht[2], dout), (0, 7)),
            ("grouped_swiglu_bwd",
             (normal((E, LL_C, D)), *ws, ll,
              normal((E, LL_C, D), 1e-2)), (0, 5))]


def old_call(lib, name, args):
    """One call of an earlier source through its own C signature, with the
    allocations and casts its wrapper made."""
    import torch

    from repro_torch.kernels import grouped_matmul as gm
    if name == "grouped_swiglu_bwd":
        x, wg, wu, wd, counts, dy = args
        E_, C, D_ = x.shape
        F_, cnt, B = gm._check_swiglu(name, x, wg, wu, wd, counts)
        dx = torch.empty_like(x)
        dws = [torch.empty_like(w) for w in (wg, wu, wd)]
        h, dg, du = (torch.empty((E_ * C, F_), dtype=x.dtype, device=x.device)
                     for _ in range(3))
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.grouped_swiglu_bwd_launch(
            x.data_ptr(), cnt.data_ptr(), wg.data_ptr(), wu.data_ptr(),
            wd.data_ptr(), dy.contiguous().data_ptr(), h.data_ptr(),
            dg.data_ptr(), du.data_ptr(), dx.data_ptr(),
            *(w.data_ptr() for w in dws), E_, C, B, D_, F_, stream)
        assert err == 0, err
        return (dx, *dws)
    x_ext, src, w_slot, wg, wu, wd, counts, dout = args
    Tp1, D_ = x_ext.shape
    E_, C, F_, src32, ws, cnt = gm._check_gss(name, x_ext, src, w_slot, wg,
                                              wu, wd, counts)
    dx = torch.zeros((Tp1, D_), dtype=torch.float32, device=x_ext.device)
    dws = torch.zeros(E_ * C, dtype=torch.float32, device=x_ext.device)
    dw = [torch.empty_like(w) for w in (wg, wu, wd)]
    h, dg, du = (torch.empty((E_ * C, F_), dtype=x_ext.dtype,
                             device=x_ext.device) for _ in range(3))
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.gather_swiglu_scatter_bwd_launch(
        x_ext.data_ptr(), src32.data_ptr(), ws.data_ptr(), cnt.data_ptr(),
        wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
        dout.contiguous().data_ptr(), h.data_ptr(), dg.data_ptr(),
        du.data_ptr(), dx.data_ptr(), dws.data_ptr(),
        *(w.data_ptr() for w in dw), Tp1, E_, C, D_, F_, stream)
    assert err == 0, err
    return (dx.to(x_ext.dtype), dws, *dw)


def rel_errs(torch, got, ref) -> list:
    out = []
    for g, r in zip(got, ref):
        scale = float(r.float().abs().max())
        ok = bool(torch.isfinite(g).all())
        err = float((g.float() - r.float()).abs().max())
        out.append(err / max(scale, 1e-30) if ok else float("inf"))
    return out


TRAIN_TURN = """
import json, torch, chip_smoke as cs
lines, _, launches = cs.train_ep_phase(torch.device("cuda"))
for line in lines:
    print(json.dumps(line), flush=True)
"""


def train_turn(tree: Path) -> dict:
    """chip_smoke's train-qwen2moe-ep phase (``train_ep_phase``) run from
    ``tree`` in a process of its own (its own kernels, built at first use):
    tokens/s over steps 2-5, the steps' seconds, peak memory, the LL and
    fp8-wire steps' seconds, and the profiled HT step's device time by
    kind (its "EP backward kernels" as that tree's chip_smoke books them)."""
    import json
    import os
    import subprocess
    r = subprocess.run([sys.executable, "-c", TRAIN_TURN], cwd=tree,
                       env={**os.environ, "PYTHONPATH": str(tree / "src")},
                       capture_output=True, text=True)
    out = {"tree": str(tree), "rc": r.returncode}
    lines = [json.loads(ln) for ln in r.stdout.splitlines()
             if ln.startswith("{")]
    for line in lines:
        if line.get("phase") == "train-qwen2moe-ep":
            out.update(tokens_per_s_steps_2_5=line["tokens_per_s_steps_2_5"],
                       step_seconds=[d["seconds"]
                                     for d in line["steps_detail"]],
                       peak_mem_gb=line["peak_mem_gb"])
        elif line.get("phase") == "train_qwen2moe_ep_more":
            out["more_step_seconds"] = {
                m["run"]: [d["seconds"] for d in m["steps_detail"]]
                for m in line["runs"]}
        elif line.get("phase") == "train_qwen2moe_ep_profile":
            out.update(profile_wall_ms=line["wall_ms"],
                       profile_busy_ms=line["device_busy_ms"],
                       device_ms_by_kind={
                           k: v["device_ms"]
                           for k, v in line["device_ms_by_kind"].items()},
                       adamw_update_ms=line["adamw_update_ms"])
    if r.returncode:
        out["stderr"] = r.stderr[-2000:]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=PATH",
                    help="an earlier swiglu_bwd.cu (the mma.sync source's C "
                    "signature)")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--train", metavar="DIR",
                    help="a checkout of the earlier tree: chip_smoke's "
                    "train-qwen2moe-ep phase from it and from this one in "
                    "turns")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("swiglu_bwd_compare: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import grouped_matmul as gm

    cc.emit(cc.device_line())
    others = dict(o.split("=", 1) for o in args.other)
    if args.sass:
        cc.emit({"sass": cc.sass_report([build.CSRC / "swiglu_bwd.cu"],
                                        ("swiglu_bwd",))})
        for name, path in others.items():
            cc.emit({"sass_" + name: cc.sass_report([Path(path)], ("bwd_",))})
    ok = True
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        libs = {name: cc.load_other([Path(path)], Path(tmp), name, ENTRIES,
                                    OLD_SIGNATURES)
                for name, path in others.items()}
        for name, a, cold_at in cases(torch, dev):
            new = getattr(gm, name + "_cuda")
            fns = {"new": lambda a=a, new=new: new(*a)}
            for kn, lib in libs.items():
                fns[kn] = lambda a=a, lib=lib, name=name: old_call(lib, name, a)
            ref = getattr(gm, name + "_plain")(*a)
            tol = cs.KERNEL_TOL[name]
            bound_ms, bound_by, work = cs.bound(name, a, {})
            line = {"kernel": name, "shapes": [list(t.shape) for t in a],
                    "tol": tol, "bound_ms": bound_ms, "bound_by": bound_by,
                    "work": work}
            for kn, fn in fns.items():
                got = fn()
                torch.cuda.synchronize()
                errs = rel_errs(torch, got, ref)
                line[f"{kn}_rel_errs"] = errs
                good = max(errs) <= tol
                if name == "grouped_swiglu_bwd":
                    dead = ~gm.occupancy_mask(a[4], E, LL_C)
                    zeros = bool((got[0][dead] == 0).all())
                    line[f"{kn}_dead_rows_zero"] = zeros
                    good &= zeros
                ok &= good
                del got
            del ref
            times, devs = cc.in_turns(fns, lambda fn: fn())
            line.update({f"{kn}_ms": times[kn] for kn in fns})
            line.update({f"{kn}_device_ms": devs[kn] for kn in fns})
            for kn in fns:
                best = min((t for t in devs[kn] if t), default=None)
                line[f"{kn}_bound_share"] = best and bound_ms / best
            sets = [tuple(torch.randn_like(t) if i in cold_at else t
                          for i, t in enumerate(a))
                    for _ in range(cs.COLD_CACHES)]
            for kn, fn in fns.items():
                if kn == "new":
                    def one(s, new=new):
                        return new(*s)
                else:
                    def one(s, lib=libs[kn], name=name):
                        return old_call(lib, name, s)
                line[f"{kn}_cold_device_ms"] = cc.cold(
                    lambda: [one(s) for s in sets])
                line[f"{kn}_host_ms"] = cc.host_ms(fn)
                line[f"{kn}_device_ms_by_kernel"] = cc.device_ms_by_kernel(fn)
            del sets
            cc.emit(line)
            torch.cuda.empty_cache()
    if args.train:
        turns = [("parent", Path(args.train)), ("new", cc.ROOT),
                 ("new", cc.ROOT), ("parent", Path(args.train))]
        for kn, tree in turns:
            line = train_turn(tree)
            cc.emit({"train": kn, **line})
            ok &= line["rc"] == 0
    cc.emit({"ok": ok})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
