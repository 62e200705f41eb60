#!/usr/bin/env python3
"""Time the flash-decoding kernel (``csrc/decode_attention.cu``) against an
earlier version of its source, on one NVIDIA GPU, on the same inputs.

    mkdir -p build/old_decode
    for f in decode_attention.cu decode_common.cuh; do
      git show <commit>:src/repro_torch/csrc/$f > build/old_decode/$f
    done
    python3 scripts/decode_compare.py --other old=build/old_decode \\
        [--sass] [--chunk N ...]

(``build/`` is ignored by git.)  The current kernel ("new") comes from the
package's build and its wrapper, with ``pos`` a 0-d int32 on the card.
Each ``--other NAME=DIR`` compiles DIR's ``decode_attention.cu`` out of
tree (``compare_common.py``) and launches it as its source was launched
before the position moved to the device: ``pos`` a host int, only the
256-position chunks of the live prefix launched, and a second kernel to
merge them, through that version's own C entry point.  Inputs are seeded
N(0, 1) values at the served decode shapes: qwen3-4b's (batch 4, 32 query
heads over 8 kv heads, a 2080-position cache) at pos 2048 and 2078 (its
first and last decode steps), and qwen2-moe's (batch 4, 16 heads, MHA, a
272-position cache) at pos 256 and 270.  Each version is held row by row
to the plain version (``chip_smoke.KERNEL_TOL``), then timed in turns
(others, new, new, others reversed): CUDA-event medians and profiler
device times, beside ``scaled_dot_product_attention`` on the live prefix
(events and device) and the bound from ``chip_smoke.norm_attn_bound``;
each version's host time per call; and its cold device time, each call on one of ``chip_smoke.COLD_CACHES``
caches of the same shape in turn (their 272 MB at qwen3's shape do not fit
the 50 MB L2, as a decode step's 36 layers do not), where the repeated
calls above find part of their cache in L2.  ``--chunk N`` also times the
new kernel with its chunk forced to N positions ("new@N"; ``--chunk 160
--chunk 192`` compares a chunk that puts four blocks on some SMs at
qwen3's shape with the rule's three).  ``--sass`` prints ptxas's register,
spill and shared-memory report for the new kernel.  One JSON line per
result, the card's name and power limit from nvidia-smi among them.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
import tempfile
from pathlib import Path

import compare_common as cc

# name: (B, H, Hkv, S, pos)
CASES = {"qwen3_4b_first": (4, 32, 8, 2080, 2048),
         "qwen3_4b_last": (4, 32, 8, 2080, 2078),
         "qwen2_moe_first": (4, 16, 16, 272, 256),
         "qwen2_moe_last": (4, 16, 16, 272, 270)}
ENTRY = "decode_attention_launch"
# the C entry point before pos moved to the device: q, k, v, part_o,
# part_m, part_l, out; B, S, H, Hkv, n_live, ns, chunk; the stream
HOST_POS_SIGNATURE = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
    ctypes.c_void_p]
HOST_POS_CHUNK = 256


def host_pos_call(lib, q, k, v, pos: int):
    """The earlier wrapper: the live prefix's chunks, then the merge."""
    import torch

    from repro_torch.kernels import build
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    n_live = min(max(pos + 1, 0), S)
    ns = max(1, -(-n_live // HOST_POS_CHUNK))
    out = torch.empty_like(q)
    part_o = torch.empty((B, H, ns, D), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((2, B, H, ns), dtype=torch.float32,
                          device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), part_o.data_ptr(),
        part_ml[0].data_ptr(), part_ml[1].data_ptr(), out.data_ptr(),
        B, S, H, Hkv, n_live, ns, HOST_POS_CHUNK, stream)
    build.check(err, "decode_attention (host pos)")
    return out


def row_err(got, ref) -> float:
    e = (got.float() - ref.float()).abs().amax(-1)
    s = ref.float().abs().amax(-1).clamp_min(1e-30)
    return float((e / s).max())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=DIR",
                    help="a directory holding another decode_attention.cu "
                         "and the decode_common.cuh it includes")
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
        others = {}
        for other in args.other:
            name, path = other.split("=", 1)
            others[name] = cc.load_other(
                [Path(path) / "decode_attention.cu"], Path(tmp), name,
                [ENTRY], {ENTRY: HOST_POS_SIGNATURE})
        gen = torch.Generator(device=dev).manual_seed(0)
        for case, (B, H, Hkv, S, pos) in CASES.items():
            q = torch.randn((B, H, 128), generator=gen, device=dev,
                            dtype=torch.bfloat16)
            k = torch.randn((B, S, Hkv, 128), generator=gen, device=dev,
                            dtype=torch.bfloat16)
            v = torch.randn((B, S, Hkv, 128), generator=gen, device=dev,
                            dtype=torch.bfloat16)
            pos_t = torch.full((), pos, dtype=torch.int32, device=dev)
            rep = H // Hkv
            sms, per_sm = na._decode_slots_of(lib, dev, rep)
            chunk = na.decode_chunk(B, S, Hkv, sms, per_sm)
            # each version as a function of the cache (k, v)
            fns = {"new": lambda kk, vv: na.decode_attention_cuda(q, kk, vv,
                                                                   pos_t)}
            for name, olib in others.items():
                fns[name] = (lambda kk, vv, olib=olib:
                             host_pos_call(olib, q, kk, vv, pos))

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
                    "pos": pos, "tol": tol, "sms": sms, "blocks_per_sm": per_sm,
                    "chunk": chunk, "chunks": -(-S // chunk),
                    "grid_blocks": -(-S // chunk) * B * Hkv}
            for kn, fn in fns.items():
                err = row_err(fn(k, v), ref)
                line[f"{kn}_row_err"] = err
                ok &= err <= tol
            # a second call of the new kernel: its arrival counters were
            # set back to 0 by the first
            line["new_again_equal"] = bool(torch.equal(fns["new"](k, v),
                                                       fns["new"](k, v)))
            ok &= line["new_again_equal"]
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
