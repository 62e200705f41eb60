#!/usr/bin/env python3
"""Time the RMSNorm kernel (``csrc/rmsnorm.cu``) against an earlier version
of its source and ``torch.nn.functional.rms_norm``, on one NVIDIA GPU, on
the same inputs.

    git show <commit>:src/repro_torch/csrc/rmsnorm.cu > build/old_rmsnorm.cu
    python3 scripts/rmsnorm_compare.py --other old=build/old_rmsnorm.cu \
        [--sass] [--threads N ...]

(``build/`` is ignored by git.)  The current kernel ("new") comes from the
package's build and its wrapper.  Each ``--other NAME=PATH`` compiles that
source out of tree (``compare_common.py``) and launches it through the C
entry point it had before the launch shape moved to the wrapper
(``rmsnorm_launch(x, scale, out, rows, D, eps, stream)``).  Inputs are
seeded N(0, 1) rows and scale at serve-qwen3's shapes: the prefill's ln1
(8192 x 2560), q_norm (262,144 x 128) and k_norm (65,536 x 128), and the
decode step's ln1 (4 x 2560), q_norm (128 x 128) and k_norm (32 x 128).
Each version is held row by row to the plain version
(``chip_smoke.KERNEL_TOL``), then timed in turns (others, new, new, others
reversed), ``F.rms_norm`` among the others (its scale in bf16, its fused
kernel's condition; not held to the tolerance): CUDA-event medians and
profiler device times, beside the bytes bound
(``chip_smoke.norm_attn_bound``); and cold, each call on one of
``chip_smoke.COLD_CACHES`` row sets of the same shape in turn (336 MB at
the ln1 shape, past the 50 MB L2).  ``--threads N`` also times the new
kernel with N threads a row ("new@N") where the shape takes N (a power of
two up to 32 for rows of at most 32 vectors, a multiple of 32 up to 512
for wider ones; ``--threads 320`` at the ln1 shape: a vector a thread
against the rule's two).  ``--sass`` prints ptxas's register,
spill and shared-memory report for the new kernels.  One JSON line per
shape, the card's name and power limit from nvidia-smi among them.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
import tempfile
from pathlib import Path

import compare_common as cc

# name: (rows, D)
CASES = {"prefill_ln1": (8192, 2560), "prefill_q_norm": (262144, 128),
         "prefill_k_norm": (65536, 128), "decode_ln1": (4, 2560),
         "decode_q_norm": (128, 128), "decode_k_norm": (32, 128)}
ENTRY = "rmsnorm_launch"
# the C entry point before the wrapper chose the launch shape: x, scale,
# out; rows, D, eps; the stream
OLD_SIGNATURE = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_float, ctypes.c_void_p]
EPS = 1e-5   # qwen3-4b's norm_eps


def old_call(lib, x, scale):
    import torch

    from repro_torch.kernels import build
    out = torch.empty_like(x)
    D = x.shape[-1]
    err = lib.rmsnorm_launch(x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                             x.numel() // D, D, EPS,
                             torch.cuda.current_stream().cuda_stream)
    build.check(err, "rmsnorm (earlier source)")
    return out


def forced(n, x, scale):
    """The new kernel through its wrapper, at n threads a row."""
    from repro_torch.kernels import norm_attention as na
    saved = na.rmsnorm_threads_per_row
    na.rmsnorm_threads_per_row = lambda *a: n
    try:
        return na.rmsnorm_cuda(x, scale, EPS)
    finally:
        na.rmsnorm_threads_per_row = saved


def row_err(got, ref) -> float:
    e = (got.float() - ref.float()).abs().amax(-1)
    s = ref.float().abs().amax(-1).clamp_min(1e-30)
    return float((e / s).max())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=PATH", help="another rmsnorm.cu")
    ap.add_argument("--threads", action="append", default=[], type=int,
                    help="also time the new kernel at this many threads a row")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("rmsnorm_compare: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import norm_attention as na

    cc.emit(cc.device_line())
    if args.sass:
        cc.emit({"sass": cc.sass_report([build.CSRC / "rmsnorm.cu"],
                                        ("rmsnorm",))})
    dev = torch.device("cuda")
    tol = cs.KERNEL_TOL["rmsnorm"]
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        others = {}
        for other in args.other:
            name, path = other.split("=", 1)
            others[name] = cc.load_other([Path(path)], Path(tmp), name,
                                         [ENTRY], {ENTRY: OLD_SIGNATURE})
        gen = torch.Generator(device=dev).manual_seed(0)
        sms = na._sm_count(dev)
        for case, (rows, D) in CASES.items():
            x = torch.randn((rows, D), generator=gen, device=dev,
                            dtype=torch.bfloat16)
            scale = torch.randn((D,), generator=gen, device=dev)
            fns = {"new": lambda xx: na.rmsnorm_cuda(xx, scale, EPS)}
            for name, olib in others.items():
                fns[name] = lambda xx, olib=olib: old_call(olib, xx, scale)
            narrow = na.rmsnorm_vectors(D) <= na.RMSNORM_ROWS_MAX_VECTORS
            for n in args.threads:
                if (n in (4, 8, 16, 32) if narrow else
                        n % 32 == 0 and n <= na.RMSNORM_ROW_MAX_THREADS):
                    fns[f"new@{n}"] = lambda xx, n=n: forced(n, xx, scale)
            ref = na.rmsnorm_plain(x, scale, EPS)
            line = {"case": case, "rows": rows, "D": D, "tol": tol,
                    "threads_per_row": na.rmsnorm_threads_per_row(rows, D,
                                                                  sms)}
            for kn, fn in fns.items():
                err = row_err(fn(x), ref)
                line[f"{kn}_row_err"] = err
                ok &= err <= tol
            bound_ms, bound_by, _ = cs.norm_attn_bound("rmsnorm",
                                                       (x, scale), {})
            # F.rms_norm (chip_smoke.library_call's) takes its turns beside
            # the kernels
            scale_bf = scale.to(torch.bfloat16)
            fns["rms_norm"] = lambda xx: F.rms_norm(xx, (D,), scale_bf, EPS)
            times, devt = cc.in_turns(fns, lambda f: f(x))
            sets = [torch.randn_like(x) for _ in range(cs.COLD_CACHES)]
            line.update({f"{kn}_ms": times[kn] for kn in fns})
            line.update({f"{kn}_device_ms": devt[kn] for kn in fns})
            line.update({f"{kn}_cold_device_ms": cc.cold(
                lambda fn=fn: [fn(xx) for xx in sets]) for kn, fn in
                fns.items()})
            line.update(bound_ms=bound_ms, bound_by=bound_by)
            for kn in fns:
                line[f"{kn}_device_bound_share"] = bound_ms / min(
                    t for t in devt[kn] if t)
            cc.emit(line)
            del x, sets, ref
    cc.emit({"ok": ok})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
