#!/usr/bin/env python3
"""Time the paged flash-decoding kernel (``csrc/decode_attention_paged.cu``)
against an earlier version of its source, on one NVIDIA GPU, on the same
inputs.

    mkdir -p build/old_paged
    for f in decode_attention_paged.cu decode_common.cuh; do
      git show <commit>:src/repro_torch/csrc/$f > build/old_paged/$f
    done
    python3 scripts/paged_compare.py --parent old=build/old_paged \\
        [--split NAME=DIR ...] [--other NAME=DIR ...] [--sass] [--chunk N ...]

(``build/`` is ignored by git.)  The current kernel ("new") comes from the
package's build and its wrapper.  Each ``--split NAME=DIR`` compiles DIR's
``decode_attention_paged.cu`` out of tree (``compare_common.py``) and
launches it through the C entry point the paged kernel had before it took
the contiguous decoder's body: a split kernel over chunks of 256 /
bs table columns, then a second launch to merge them (part_m and part_l
apart, and the columns a chunk in place of the arrival counters and the
chunk).  Each ``--other NAME=DIR`` (a draft with today's entry points)
launches through the package's wrapper, its chunk from its own
occupancy; each ``--parent NAME=DIR`` likewise, for a source from
before the head dim became an argument (PRs 22-26, head dim 128 only),
through its own C signatures (``compare_common.py``), its output equal to
the new kernel's bit for bit (``NAME_equal_new``).  Inputs: qwen3-4b's
decode heads (batch 4, 32 query heads over 8 kv heads, head dim 128)
over 16-token blocks whose tables a ``KVBlockPool`` makes, every unread
pool row NaN (``chip_smoke.paged_pools`` on seeded N(0, 1) caches), at
the served ragged positions ``chip_smoke.PAGED_POS`` and at a full batch
(2078 for all four), and at the served positions with 8, 16 and 64 query
heads over the same 8 kv heads (reps 1, 2 and 8).  Each
version is held row by row to the plain version
(``chip_smoke.KERNEL_TOL``), then timed in turns (others, new, new, others
reversed): CUDA-event medians and profiler device times beside the bound
from ``chip_smoke.norm_attn_bound`` (the live rows, each read once), its
host time per call, and its cold device time, each call on one of
``chip_smoke.COLD_CACHES`` pool sets of the same shape in turn (175 MB,
where the repeated calls find part of their 21 MB in L2).  ``--chunk N``
also times the new kernel with its chunk forced to N positions
("new@N"; N whole table columns and a multiple of 32).  ``--sass`` prints
ptxas's register, spill and shared-memory report for the new kernel.
One JSON line per result, the card's name and power limit from
nvidia-smi among them.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
import tempfile
from pathlib import Path

import compare_common as cc

# name: (the positions of the batch's four sequences, query heads); the
# served decode heads are qwen3-4b's (32 over 8 kv heads), and the other
# reps the D 128 kernel takes before PR 27 ride on the same 8 kv heads
CASES = {"served": (None, 32), "full": ((2078,) * 4, 32),
         "served_rep1": (None, 8), "served_rep2": (None, 16),
         "served_rep8": (None, 64)}
S, HKV = 2080, 8    # the contiguous caches the pools are cut from
ENTRY = "decode_attention_paged_launch"
SLOTS = "decode_attention_paged_blocks_per_sm"
# the C entry point before the one-launch design: q, k, v, tables, pos,
# part_o, part_m, part_l, out; B, H, Hkv, NB, bs, nb, cols, ns; the stream
SPLIT_SIGNATURE = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
    ctypes.c_void_p]
SPLIT_POSITIONS = 256      # positions a chunk of that design held


def split_call(lib, q, k_pool, v_pool, tables, pos):
    """The earlier wrapper: chunks of 256 / bs columns, then the merge."""
    import torch

    from repro_torch.kernels import build
    B, Hq, D = q.shape
    NB, bs, Hkv, _ = k_pool.shape
    nb = tables.shape[1]
    cols = max(1, SPLIT_POSITIONS // bs)
    ns = max(1, -(-nb // cols))
    out = torch.empty_like(q)
    part_o = torch.empty((B, Hq, ns, D), dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty((2, B, Hq, ns), dtype=torch.float32,
                          device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.decode_attention_paged_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), pos.data_ptr(), part_o.data_ptr(),
        part_ml[0].data_ptr(), part_ml[1].data_ptr(), out.data_ptr(),
        B, Hq, Hkv, NB, bs, nb, cols, ns, stream)
    build.check(err, "decode_attention_paged (split)")
    return out


def row_err(got, ref) -> float:
    e = (got.float() - ref.float()).abs().amax(-1)
    s = ref.float().abs().amax(-1).clamp_min(1e-30)
    return float((e / s).max())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--split", action="append", default=[],
                    metavar="NAME=DIR",
                    help="a directory holding an earlier "
                         "decode_attention_paged.cu (two launches) and the "
                         "decode_common.cuh it includes")
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=DIR",
                    help="the same, for a source with today's entry points")
    ap.add_argument("--parent", action="append", default=[],
                    metavar="NAME=DIR",
                    help="the same for a source whose entry points take no "
                         "head dim")
    ap.add_argument("--chunk", action="append", default=[], type=int,
                    help="also time the new kernel at this chunk size")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("paged_compare: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import norm_attention as na

    cc.emit(cc.device_line())
    if args.sass:
        cc.emit({"sass": cc.sass_report(
            [build.CSRC / "decode_attention_paged.cu"], ("decode",))})
    lib = build.library()
    dev = torch.device("cuda")
    tol = cs.KERNEL_TOL["decode_attention_paged"]
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        split, others = {}, {}
        for other in args.split:
            name, path = other.split("=", 1)
            split[name] = cc.load_other(
                [Path(path) / "decode_attention_paged.cu"], Path(tmp), name,
                [ENTRY], {ENTRY: SPLIT_SIGNATURE})
        for other in args.other:
            name, path = other.split("=", 1)
            others[name] = cc.load_other(
                [Path(path) / "decode_attention_paged.cu"], Path(tmp), name,
                [ENTRY, SLOTS])
        parents = set()
        for other in args.parent:
            name, path = other.split("=", 1)
            others[name] = cc.load_before_head_dim(
                [Path(path) / "decode_attention_paged.cu"], Path(tmp), name,
                [ENTRY, SLOTS])
            parents.add(name)
        gen = torch.Generator(device=dev).manual_seed(0)
        k = torch.randn((4, S, HKV, 128), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        v = torch.randn_like(k)
        for case, (pos, H) in CASES.items():
            pos = pos or cs.PAGED_POS
            q = torch.randn((4, H, 128), generator=gen, device=dev,
                            dtype=torch.bfloat16)
            k_pool, v_pool, tables, posv, pool = cs.paged_pools(
                k, v, pos, cs.PAGED_BLOCK)
            NB, bs = k_pool.shape[:2]
            nb = tables.shape[1]
            sms, per_sm = na._decode_slots_of(lib, dev, H // HKV, 128,
                                              "decode_attention_paged")
            chunk = na.paged_chunk(4, nb, bs, HKV, sms, per_sm)
            # each version as a function of the pools
            fns = {"new": lambda kp, vp: na.decode_attention_paged_cuda(
                q, kp, vp, tables, posv)}
            for name, olib in split.items():
                fns[name] = (lambda kp, vp, olib=olib: split_call(
                    olib, q, kp, vp, tables, posv))
            for name, olib in others.items():
                def through_wrapper(kp, vp, olib=olib, slots={}):
                    saved = na._decode_slots
                    na._decode_slots = slots    # its own occupancy
                    try:
                        with cc.using_library(olib):
                            return na.decode_attention_paged_cuda(
                                q, kp, vp, tables, posv)
                    finally:
                        na._decode_slots = saved
                fns[name] = through_wrapper

            def forced(n):
                def call(kp, vp):
                    saved = na.paged_chunk
                    na.paged_chunk = lambda *a: n
                    try:
                        return na.decode_attention_paged_cuda(
                            q, kp, vp, tables, posv)
                    finally:
                        na.paged_chunk = saved
                return call
            for n in args.chunk:
                fns[f"new@{n}"] = forced(n)
            pools = [(torch.randn_like(k_pool), torch.randn_like(v_pool))
                     for _ in range(cs.COLD_CACHES)]
            ref = na.decode_attention_paged_plain(q, k_pool, v_pool, tables,
                                                  posv)
            live = cs.paged_live((q, k_pool, v_pool, tables, posv))
            line = {"case": case, "H": H, "Hkv": HKV, "pos": list(pos),
                    "block": bs,
                    "pool_blocks": NB, "table_width": nb, "tol": tol,
                    "sms": sms, "blocks_per_sm": per_sm, "chunk": chunk,
                    "chunks": -(-(nb * bs) // chunk),
                    "live_chunks": [-(-n // chunk) for n in live],
                    "grid_blocks": -(-(nb * bs) // chunk) * 4 * HKV}
            for kn, fn in fns.items():
                err = row_err(fn(k_pool, v_pool), ref)
                line[f"{kn}_row_err"] = err
                ok &= err <= tol
            # a second call of the new kernel: its arrival counters were
            # set back to 0 by the first
            new_out = fns["new"](k_pool, v_pool)
            line["new_again_equal"] = bool(torch.equal(
                new_out, fns["new"](k_pool, v_pool)))
            ok &= line["new_again_equal"]
            for name in parents:
                line[f"{name}_equal_new"] = bool(torch.equal(
                    fns[name](k_pool, v_pool), new_out))
                ok &= line[f"{name}_equal_new"]
            bound_ms, bound_by, work = cs.norm_attn_bound(
                "decode_attention_paged", (q, k_pool, v_pool, tables, posv),
                {})
            times, devt = cc.in_turns(fns, lambda f: f(k_pool, v_pool))
            line.update({f"{kn}_ms": times[kn] for kn in fns})
            line.update({f"{kn}_device_ms": devt[kn] for kn in fns})
            line.update({f"{kn}_host_ms": cc.host_ms(
                lambda: fn(k_pool, v_pool)) for kn, fn in fns.items()})
            line.update({f"{kn}_cold_device_ms": cc.cold(
                lambda: [fn(kp, vp) for kp, vp in pools]) for kn, fn in
                fns.items()})
            line.update(bound_ms=bound_ms, bound_by=bound_by,
                        live_bytes=work["bytes"])
            for kn in fns:
                line[f"{kn}_device_bound_share"] = bound_ms / min(
                    t for t in devt[kn] if t)
                cold = line[f"{kn}_cold_device_ms"]
                line[f"{kn}_cold_bound_share"] = cold and bound_ms / cold
            cc.emit(line)
    cc.emit({"ok": ok})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
