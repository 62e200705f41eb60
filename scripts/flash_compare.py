#!/usr/bin/env python3
"""Time the flash attention kernel against an earlier version of its source,
on one NVIDIA GPU, on the same inputs.

    git show <commit>:src/repro_torch/csrc/flash_attention.cu > build/old_fa.cu
    python3 scripts/flash_compare.py --parent old=build/old_fa.cu [--sass]

The current kernel ("new") comes from the package's build
(``kernels/build.py``); each ``--other NAME=PATH`` source compiles with
nvcc into a temporary directory outside the repository and loads through
ctypes under the same C entry point (``compare_common.py``; an earlier
source that includes ``hopper_common.cuh`` needs that header beside it),
each ``--parent NAME=PATH`` likewise, for a source from before the head
dim became an argument (PRs 16-26: head dim 128 only), through its own C
signature.  All are held row by row to the plain version (2e-2 of each
output row's largest value), and at head dim 128 to the new kernel bit
for bit (``NAME_equal_new``), then timed in turns (others, new, new,
others reversed) at the serving prefill shapes: CUDA-event medians and
profiler device times, beside ``scaled_dot_product_attention`` and the
bound the card's bf16 rate sets.  The shapes at head dim 64
(musicgen-large) time the new kernel alone.  ``--sass`` also prints
ptxas's register and
shared-memory report for the current source and counts its HGMMA (wgmma)
and HMMA (mma.sync) instructions.  One JSON line per result, the card's
name and power limit from nvidia-smi among them.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import compare_common as cc

# (B, Sq, Skv, H, Hkv, D, causal): qwen3-4b's prefill, the qwen2-moe
# one, internvl2-26b's (6 query heads a kv head), musicgen-large's (MHA at
# head dim 64)
SHAPES = {"qwen3_4b_prefill": (4, 2048, 2048, 32, 8, 128, True),
          "qwen2_moe_prefill": (4, 256, 256, 16, 16, 128, True),
          "internvl2_prefill": (4, 1024, 1024, 48, 8, 128, True),
          "musicgen_prefill": (4, 1024, 1024, 32, 32, 64, True)}
ROW_TOL = 2e-2
ENTRY = "flash_attention_launch"


def row_err(got, ref) -> float:
    e = (got.float() - ref.float()).abs().amax(-1)
    s = ref.float().abs().amax(-1).clamp_min(1e-30)
    return float((e / s).max())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=PATH", help="another flash_attention.cu")
    ap.add_argument("--parent", action="append", default=[],
                    metavar="NAME=PATH",
                    help="a flash_attention.cu whose entry takes no head "
                         "dim")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("flash_compare: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import norm_attention as na

    cc.emit(cc.device_line())
    if args.sass:
        cc.emit({"sass": cc.sass_report([build.CSRC / "flash_attention.cu"],
                                        ("flash",))})
    libs = {"new": None}
    with tempfile.TemporaryDirectory() as tmp:
        for other in args.other:
            name, path = other.split("=", 1)
            libs[name] = cc.load_other([Path(path)], Path(tmp), name, [ENTRY])
        for other in args.parent:
            name, path = other.split("=", 1)
            libs[name] = cc.load_before_head_dim([Path(path)], Path(tmp),
                                                 name, [ENTRY])
        ok = True
        gen = torch.Generator(device="cuda").manual_seed(0)
        for name, (B, Sq, Skv, H, Hkv, D, causal) in SHAPES.items():
            q = torch.randn((B, Sq, H, D), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            k = torch.randn((B, Skv, Hkv, D), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            v = torch.randn((B, Skv, Hkv, D), generator=gen, device="cuda",
                            dtype=torch.bfloat16)

            def call(lib):
                with cc.using_library(lib):
                    return na.flash_attention_cuda(q, k, v, causal=causal)

            ref = na.flash_attention_plain(q, k, v, causal=causal)
            line = {"shape": name, "B": B, "Sq": Sq, "Skv": Skv, "H": H,
                    "Hkv": Hkv, "D": D, "causal": causal, "tol": ROW_TOL}
            here = {kn: lib for kn, lib in libs.items()
                    if D == 128 or kn == "new"}
            new_out = call(None)
            for kn, lib in here.items():
                out = call(lib)
                err = row_err(out, ref)
                line[f"{kn}_row_err"] = err
                ok &= err <= ROW_TOL
                if kn != "new":
                    line[f"{kn}_equal_new"] = bool(torch.equal(out, new_out))
                    ok &= line[f"{kn}_equal_new"]
            bound_ms, bound_by, _ = cs.norm_attn_bound(
                "flash_attention", (q, k, v), {"causal": causal})
            times, dev = cc.in_turns(here, call)
            lib_call = cs.library_call("flash_attention", (q, k, v),
                                       {"causal": causal})
            line.update({f"{kn}_ms": times[kn] for kn in here})
            line.update({f"{kn}_device_ms": dev[kn] for kn in here})
            line.update(bound_ms=bound_ms, bound_by=bound_by,
                        sdpa_ms=cs.cuda_ms(lib_call),
                        sdpa_device_ms=cs.device_ms(lib_call))
            for kn in here:
                line[f"{kn}_bound_share"] = bound_ms / min(times[kn])
            cc.emit(line)
    cc.emit({"ok": ok})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
