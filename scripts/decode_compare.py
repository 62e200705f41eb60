#!/usr/bin/env python3
"""Time the flash-decoding kernel (``csrc/decode_attention.cu``) against
earlier versions of its source, on one NVIDIA GPU, on the same inputs.

    mkdir -p build/old_decode
    for f in decode_attention.cu decode_common.cuh; do
      git show <commit>:src/repro_torch/csrc/$f > build/old_decode/$f
    done
    python3 scripts/decode_compare.py --parent old=build/old_decode \\
        [--sass] [--chunk N ...]

(``build/`` is ignored by git.)  The current kernel ("new") comes from the
package's build and its wrapper, with ``pos`` a 0-d int32 on the card.
Each ``--other NAME=DIR`` compiles DIR's ``decode_attention.cu`` out of
tree (``compare_common.py``) and launches it through the package's
wrapper, so it must have today's C entry points (``pos`` on the device,
one launch, the head dim an argument); each ``--parent NAME=DIR`` the
same for a source from before the head dim became an argument (PRs
18-26), through its own C signatures (``compare_common.py``), at head dim
128 and reps 1, 2, 4 and 8 only.  Their outputs must equal the new
kernel's bit for bit (``NAME_equal_new``).  Inputs are seeded N(0, 1)
values at the served decode shapes: qwen3-4b's (batch 4, 32 query heads
over 8 kv heads, a 2080-position cache) at pos 2048 and 2078 (its first
and last decode steps), qwen2-moe's (batch 4, 16 heads, MHA, a
272-position cache) at pos 256 and 270, qwen3-1.7b's (16 query heads over
8: rep 2) at pos 2078, and serve-dense-wide's last decode steps (a
1040-position cache at pos 1038) of qwen2-72b (64 over 8: rep 8),
internvl2-26b (48 over 8: rep 6) and musicgen-large (32 heads, MHA, head
dim 64); no earlier source takes the last two.  Each version is held row
by row to the plain version
(``chip_smoke.KERNEL_TOL``), then timed in turns (others, new, new,
others reversed): CUDA-event medians and profiler device times, beside
``scaled_dot_product_attention`` on the live prefix (events and device)
and the bound from ``chip_smoke.norm_attn_bound``; each version's host
time per call; and its cold device time, each call on one of
``chip_smoke.COLD_CACHES`` caches of the same shape in turn (their 272 MB
at qwen3's shape do not fit the 50 MB L2, as a decode step's 36 layers do
not), where the repeated calls above find part of their cache in L2.
``--chunk N`` also times the new kernel with its chunk forced to N
positions ("new@N"; ``--chunk 160 --chunk 192`` compares a chunk that
puts four blocks on some SMs at qwen3's shape with the rule's three).
``--sass`` prints ptxas's register, spill and shared-memory report for
the new kernel.  One JSON line per result, the card's name and power
limit from nvidia-smi among them.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import compare_common as cc

# name: (B, H, Hkv, S, pos, D)
CASES = {"qwen3_4b_first": (4, 32, 8, 2080, 2048, 128),
         "qwen3_4b_last": (4, 32, 8, 2080, 2078, 128),
         "qwen2_moe_first": (4, 16, 16, 272, 256, 128),
         "qwen2_moe_last": (4, 16, 16, 272, 270, 128),
         "qwen3_1_7b_last": (4, 16, 8, 2080, 2078, 128),
         "qwen2_72b_last": (4, 64, 8, 1040, 1038, 128),
         "internvl2_last": (4, 48, 8, 1040, 1038, 128),
         "musicgen_last": (4, 32, 32, 1040, 1038, 64)}
PARENT_REPS = (1, 2, 4, 8)   # what a source before PR 27 takes
ENTRY = "decode_attention_launch"
SLOTS = "decode_attention_blocks_per_sm"


def row_err(got, ref) -> float:
    e = (got.float() - ref.float()).abs().amax(-1)
    s = ref.float().abs().amax(-1).clamp_min(1e-30)
    return float((e / s).max())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=DIR",
                    help="a directory holding another decode_attention.cu "
                         "with today's C entry point and the "
                         "decode_common.cuh it includes")
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
        print("decode_compare: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import norm_attention as na

    cc.emit(cc.device_line())
    if args.sass:
        cc.emit({"sass": cc.sass_report([build.CSRC / "decode_attention.cu"],
                                        ("decode",))})
    lib = build.library()
    dev = torch.device("cuda")
    tol = cs.KERNEL_TOL["decode_attention"]
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        others, parents = {}, set()
        for other in args.other:
            name, path = other.split("=", 1)
            others[name] = cc.load_other(
                [Path(path) / "decode_attention.cu"], Path(tmp), name,
                [ENTRY, SLOTS])
        for other in args.parent:
            name, path = other.split("=", 1)
            others[name] = cc.load_before_head_dim(
                [Path(path) / "decode_attention.cu"], Path(tmp), name,
                [ENTRY, SLOTS])
            parents.add(name)
        gen = torch.Generator(device=dev).manual_seed(0)
        for case, (B, H, Hkv, S, pos, D) in CASES.items():
            q = torch.randn((B, H, D), generator=gen, device=dev,
                            dtype=torch.bfloat16)
            k = torch.randn((B, S, Hkv, D), generator=gen, device=dev,
                            dtype=torch.bfloat16)
            v = torch.randn((B, S, Hkv, D), generator=gen, device=dev,
                            dtype=torch.bfloat16)
            pos_t = torch.full((), pos, dtype=torch.int32, device=dev)
            rep = H // Hkv
            sms, per_sm = na._decode_slots_of(lib, dev, rep, D)
            chunk = na.decode_chunk(B, S, Hkv, sms, per_sm)
            # each version as a function of the cache (k, v)
            fns = {"new": lambda kk, vv: na.decode_attention_cuda(q, kk, vv,
                                                                   pos_t)}
            for name, olib in others.items():
                if name in parents and (D != 128 or rep not in PARENT_REPS):
                    continue
                def through_wrapper(kk, vv, olib=olib):
                    with cc.using_library(olib):
                        return na.decode_attention_cuda(q, kk, vv, pos_t)
                fns[name] = through_wrapper

            def forced(n):
                def call(kk, vv):
                    saved = na.decode_chunk
                    na.decode_chunk = lambda *a: n
                    try:
                        return na.decode_attention_cuda(q, kk, vv, pos_t)
                    finally:
                        na.decode_chunk = saved
                return call
            for n in args.chunk:
                fns[f"new@{n}"] = forced(n)
            caches = [(torch.randn_like(k), torch.randn_like(v))
                      for _ in range(cs.COLD_CACHES)]
            ref = na.decode_attention_plain(q, k, v, pos)
            line = {"case": case, "B": B, "H": H, "Hkv": Hkv, "S": S,
                    "D": D, "pos": pos, "tol": tol, "sms": sms,
                    "blocks_per_sm": per_sm,
                    "chunk": chunk, "chunks": -(-S // chunk),
                    "grid_blocks": -(-S // chunk) * B * Hkv}
            for kn, fn in fns.items():
                err = row_err(fn(k, v), ref)
                line[f"{kn}_row_err"] = err
                ok &= err <= tol
            # a second call of the new kernel: its arrival counters were
            # set back to 0 by the first
            new_out = fns["new"](k, v)
            line["new_again_equal"] = bool(torch.equal(new_out,
                                                       fns["new"](k, v)))
            ok &= line["new_again_equal"]
            for name in others:
                if name not in fns:
                    continue
                line[f"{name}_equal_new"] = bool(torch.equal(
                    fns[name](k, v), new_out))
                ok &= line[f"{name}_equal_new"]
            bound_ms, bound_by, work = cs.norm_attn_bound(
                "decode_attention", (q, k, v, pos), {})
            times, devt = cc.in_turns(fns, lambda f: f(k, v))
            sdpa = cs.library_call("decode_attention", (q, k, v, pos), {})
            line.update({f"{kn}_ms": times[kn] for kn in fns})
            line.update({f"{kn}_device_ms": devt[kn] for kn in fns})
            line.update({f"{kn}_host_ms": cc.host_ms(lambda: fn(k, v))
                         for kn, fn in fns.items()})
            line.update({f"{kn}_cold_device_ms": cc.cold(
                lambda: [fn(kk, vv) for kk, vv in caches]) for kn, fn in
                fns.items()})
            sdpa_cold = [cs.library_call("decode_attention", (q, kk, vv, pos),
                                         {}) for kk, vv in caches]
            line["sdpa_cold_device_ms"] = cc.cold(
                lambda: [f() for f in sdpa_cold])
            line.update(bound_ms=bound_ms, bound_by=bound_by,
                        live_bytes=work["bytes"],
                        sdpa_ms=cs.cuda_ms(sdpa),
                        sdpa_device_ms=cs.device_ms(sdpa))
            for kn in fns:
                line[f"{kn}_device_bound_share"] = bound_ms / min(
                    t for t in devt[kn] if t)
            cc.emit(line)
    cc.emit({"ok": ok})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
