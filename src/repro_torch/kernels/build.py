"""Build and load the hand-written Hopper kernels (``repro_torch/csrc``).

Every ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` (one process per
source, all started together), and the objects link into one shared
library with a plain C interface that :func:`library` loads with
``ctypes``.  The build runs at first use, into ``build/repro_torch/<hash>``
at the repository root, keyed on a hash of the sources and flags, so a
fresh checkout builds everything on its first kernel launch.  Nothing here
runs at import.  The library links no driver library: the kernels fed by
TMA (flash attention, the grouped-expert tile loop and the SwiGLU
backward that runs on it) take
``cuTensorMapEncodeTiled`` (their tensor maps) from the driver at run
time through ``cudaGetDriverEntryPoint`` (``csrc/hopper_common.cuh``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# C entry points: every pointer and the stream are c_void_p, ints c_int
# (c_longlong for row counts and strides);
# each returns its cudaGetLastError() as an int
SIGNATURES = {
    "grouped_matmul_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "grouped_swiglu_launch": [_P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _P],
    "grouped_swiglu_db_launch": [_P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _P],
    "gather_swiglu_scatter_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _I, _I, _I, _I, _I, _P],
    "gather_quantize_launch": [_P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _F, _F, _I, _P],
    "dequantize_launch": [_P, _P, _P, _I, _I, _I, _I, _P],
    "grouped_swiglu_bwd_launch": [_P] * 18 + [_I] * 5 + [_P],
    "gather_swiglu_scatter_bwd_launch": [_P] * 20 + [_I] * 5 + [_P],
    "dequantize_bwd_launch": [_P] * 3 + [_I] * 4 + [_P],
    "gather_quantize_bwd_launch": [_P] * 6 + [_I] * 5 + [_F, _P],
    "mamba_scan_fwd_launch": [_P] * 8 + [_I, _I, _I, _P],
    "mamba_scan_bwd_launch": [_P] * 14 + [_I, _I, _I, _P],
    "rmsnorm_rows_launch": [_P, _P, _P, _L, _I, _F, _I, _I, _P],
    "rmsnorm_row_launch": [_P, _P, _P, _L, _I, _F, _I, _P],
    "flash_attention_launch": [_P] * 4 + [_I] * 6 + [_L] * 9 + [_P],
    "decode_attention_launch": [_P] * 8 + [_I] * 7 + [_P],
    "decode_attention_blocks_per_sm": [_I],
    "decode_attention_paged_launch": [_P] * 9 + [_I] * 8 + [_P],
    "decode_attention_paged_blocks_per_sm": [_I],
    "combine_reduce_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
}

_lib = None
last_build_seconds = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build() -> Path:
    """Compile the kernels if this source hash has not been built yet;
    returns the shared library's path."""
    global last_build_seconds
    out_dir = BUILD_ROOT / _digest()
    so = out_dir / "librepro_torch_kernels.so"
    if so.exists():
        return so
    t0 = time.perf_counter()
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, p in procs:
            out, _ = p.communicate()
            logs.append(f"--- {src.name}\n{out}")
            if p.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
        tmp_so = Path(tmp) / so.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_so),
             *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, so)
    last_build_seconds = time.perf_counter() - t0
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
