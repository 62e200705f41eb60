#!/usr/bin/env python3
"""Time the flash attention kernel against an earlier version of its source,
on one NVIDIA GPU, on the same inputs.

    git show <commit>:src/repro_torch/csrc/flash_attention.cu > build/old_fa.cu
    python3 scripts/flash_compare.py --other old=build/old_fa.cu [--sass]

The current kernel ("new") comes from the package's build
(``kernels/build.py``); each ``--other NAME=PATH`` source compiles with
nvcc into a temporary directory outside the repository and loads through
ctypes under the same C entry point.  All are held row by row to the plain
version (2e-2 of each output row's largest value), then timed in turns
(others, new, new, others reversed) at the serving prefill shapes:
CUDA-event medians and profiler device times, beside
``scaled_dot_product_attention`` and the bound the card's bf16 rate sets.
``--sass`` also prints ptxas's register and shared-memory report for the
current source and counts its HGMMA (wgmma) instructions.  One JSON line
per result, the card's name and power limit from nvidia-smi among them.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# (B, Sq, Skv, H, Hkv, causal): qwen3-4b's prefill, the qwen2-moe one
SHAPES = {"qwen3_4b_prefill": (4, 2048, 2048, 32, 8, True),
          "qwen2_moe_prefill": (4, 256, 256, 16, 16, True)}
ROW_TOL = 2e-2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def load_other(src: Path, tmp: Path, name: str):
    from repro_torch.kernels import build
    so = tmp / f"lib{name}_flash.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", str(src), "-o",
           str(so)]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{out.stderr}")
    lib = ctypes.CDLL(str(so))
    fn = lib.flash_attention_launch
    fn.argtypes = build.SIGNATURES["flash_attention_launch"]
    fn.restype = ctypes.c_int
    return fn


def launcher(fn):
    """A flash_attention_cuda-like call through the C entry point ``fn``."""
    import torch

    def call(q, k, v, causal=True):
        B, Sq, H, D = q.shape
        Skv, Hkv = k.shape[1], k.shape[2]
        out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, Skv, H, Hkv, int(causal), *q.stride()[:3],
                 *k.stride()[:3], *v.stride()[:3],
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch error {err}")
        return out
    return call


def sass_report() -> dict:
    from repro_torch.kernels import build
    src = build.CSRC / "flash_attention.cu"
    with tempfile.TemporaryDirectory() as tmp:
        obj = Path(tmp) / "fa.o"
        ptxas = subprocess.run(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas=-v", "-c", str(src),
             "-o", str(obj)], capture_output=True, text=True)
        if ptxas.returncode:
            return {"ptxas": ptxas.stderr[-4000:]}
        cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
        sass = subprocess.run([str(cuobjdump), "-sass", str(obj)],
                              capture_output=True, text=True).stdout
    ops = [ln.split()[1].split(".")[0] for ln in sass.splitlines()
           if ln.strip().startswith("/*") and len(ln.split()) > 1]
    return {"ptxas": [ln for ln in ptxas.stderr.splitlines()
                      if "flash" in ln or "registers" in ln or "spill" in ln
                      or "warning" in ln.lower()],
            "hgmma": sum("HGMMA" in ln for ln in sass.splitlines()),
            "hmma": sum(o == "HMMA" for o in ops)}


def row_err(got, ref) -> float:
    e = (got.float() - ref.float()).abs().amax(-1)
    s = ref.float().abs().amax(-1).clamp_min(1e-30)
    return float((e / s).max())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=PATH", help="another flash_attention.cu")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("flash_compare: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import norm_attention as na

    emit({"device": torch.cuda.get_device_name(0),
          "nvidia_smi": cs.nvidia_smi()})
    if args.sass:
        emit({"sass": sass_report()})
    kernels = {"new": na.flash_attention_cuda}
    with tempfile.TemporaryDirectory() as tmp:
        for other in args.other:
            name, path = other.split("=", 1)
            kernels[name] = launcher(load_other(Path(path), Path(tmp), name))
        ok = True
        gen = torch.Generator(device="cuda").manual_seed(0)
        for name, (B, Sq, Skv, H, Hkv, causal) in SHAPES.items():
            q = torch.randn((B, Sq, H, 128), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            k = torch.randn((B, Skv, Hkv, 128), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            v = torch.randn((B, Skv, Hkv, 128), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            ref = na.flash_attention_plain(q, k, v, causal=causal)
            line = {"shape": name, "B": B, "Sq": Sq, "Skv": Skv, "H": H,
                    "Hkv": Hkv, "causal": causal, "tol": ROW_TOL}
            for kn, fn in kernels.items():
                err = row_err(fn(q, k, v, causal=causal), ref)
                line[f"{kn}_row_err"] = err
                ok &= err <= ROW_TOL
            bound_ms, bound_by, _ = cs.norm_attn_bound(
                "flash_attention", (q, k, v), {"causal": causal})
            others = [kn for kn in kernels if kn != "new"]
            order = others + ["new", "new"] + others[::-1]
            times = {kn: [] for kn in kernels}
            dev = {kn: [] for kn in kernels}
            for kn in order:
                fn = kernels[kn]
                times[kn].append(cs.cuda_ms(lambda: fn(q, k, v, causal=causal)))
                dev[kn].append(cs.device_ms(lambda: fn(q, k, v,
                                                       causal=causal)))
            lib = cs.library_call("flash_attention", (q, k, v),
                                  {"causal": causal})
            line.update({f"{kn}_ms": times[kn] for kn in kernels})
            line.update({f"{kn}_device_ms": dev[kn] for kn in kernels})
            line.update(bound_ms=bound_ms, bound_by=bound_by,
                        sdpa_ms=cs.cuda_ms(lib),
                        sdpa_device_ms=cs.device_ms(lib))
            for kn in kernels:
                line[f"{kn}_bound_share"] = bound_ms / min(times[kn])
            emit(line)
    emit({"ok": ok})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
