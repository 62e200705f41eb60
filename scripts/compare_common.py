"""What the kernel comparison scripts (``flash_compare.py``,
``tiles_compare.py``, ``decode_compare.py``, ``paged_compare.py``,
``rmsnorm_compare.py``, ``scan_compare.py``, ``dequantize_compare.py``,
``quantize_compare.py``, ``swiglu_bwd_compare.py``) share: building an
earlier version of a kernel's sources out of tree and binding its C entry
points, ptxas's and cuobjdump's report on the current sources, and timing
versions in turns.

An earlier source is compiled with the package's nvcc flags into a
temporary directory outside the repository and loaded through ctypes under
the same C entry points (``kernels/build.py::SIGNATURES``), so the
package's own wrappers can launch it: :func:`using_library` swaps it in
for the package's library during a call.  An entry point whose signature
has changed since is bound with its own and launched by the script; an
attention source from before the head dim became an argument
(:func:`load_before_head_dim`) goes through the wrappers behind a stand-in
that drops it.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def device_line() -> dict:
    """The card's name, and its name and power limit from nvidia-smi."""
    import torch

    import chip_smoke as cs
    return {"device": torch.cuda.get_device_name(0),
            "nvidia_smi": cs.nvidia_smi()}


def load_other(sources: list[Path], tmp: Path, name: str,
               entries: list[str], signatures: dict = None) -> ctypes.CDLL:
    """Compile ``sources`` (headers found beside the first) into one shared
    library under ``tmp`` and bind ``entries``, with their argument types
    from ``signatures`` where it names them (an entry point whose C
    signature has since changed), else from the package's."""
    from repro_torch.kernels import build
    so = tmp / f"lib{name}.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I",
           str(sources[0].parent), *map(str, sources), "-o", str(so)]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed for {sources}:\n{out.stderr}")
    lib = ctypes.CDLL(str(so))
    for entry in entries:
        fn = getattr(lib, entry)
        sigs = signatures or {}
        fn.argtypes = sigs[entry] if entry in sigs else build.SIGNATURES[entry]
        fn.restype = ctypes.c_int
    return lib


# the attention kernels' C entry points before the head dim became an
# argument (PRs 16-26, head dim 128 only): their argument types, and the
# index of the head dim in today's arguments
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
PRE_HEAD_DIM = {
    "flash_attention_launch": ([_P] * 4 + [_I] * 6 + [_L] * 9 + [_P], 9),
    "decode_attention_launch": ([_P] * 8 + [_I] * 7 + [_P], 12),
    "decode_attention_blocks_per_sm": ([_I], 1),
    "decode_attention_paged_launch": ([_P] * 9 + [_I] * 8 + [_P], 12),
    "decode_attention_paged_blocks_per_sm": ([_I], 1),
}


class _DropHeadDim:
    """Stands in for a library whose entries ``drop`` ({entry: index})
    take no head dim: called with today's arguments, each passes on all
    but the head dim, which must be 128."""

    def __init__(self, lib, drop: dict):
        self._lib, self._drop = lib, drop

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name not in self._drop:
            return fn
        i = self._drop[name]

        def call(*args):
            if args[i] != 128:
                raise ValueError(f"{name}: the earlier source takes head "
                                 f"dim 128 only, not {args[i]}")
            return fn(*args[:i], *args[i + 1:])
        return call


def load_before_head_dim(sources: list[Path], tmp: Path, name: str,
                         entries: list[str]):
    """:func:`load_other` for an attention source from before the head dim
    became an argument: its ``entries`` bound with their own argument types
    (``PRE_HEAD_DIM``), behind a stand-in that takes today's, so the
    package's wrappers launch it (at head dim 128) under
    :func:`using_library`."""
    lib = load_other(sources, tmp, name, entries,
                     {e: PRE_HEAD_DIM[e][0] for e in entries})
    return _DropHeadDim(lib, {e: PRE_HEAD_DIM[e][1] for e in entries})


@contextlib.contextmanager
def using_library(lib):
    """The package's wrappers launch from ``lib`` inside the block (None:
    the package's own library)."""
    from repro_torch.kernels import build
    saved = build.library()
    build._lib = lib if lib is not None else saved
    try:
        yield
    finally:
        build._lib = saved


def sass_report(sources: list[Path], fragments: tuple[str, ...]) -> dict:
    """ptxas's register, spill and shared-memory lines for the kernels whose
    names hold one of ``fragments``, and the HGMMA (wgmma) and HMMA
    (mma.sync) instructions in each source's SASS."""
    from repro_torch.kernels import build
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            ptxas = subprocess.run(
                [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                 "-Xptxas=-v", "-c", str(src), "-o", str(obj)],
                capture_output=True, text=True)
            if ptxas.returncode:
                report[src.name] = {"ptxas": ptxas.stderr[-4000:]}
                continue
            cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
            sass = subprocess.run([str(cuobjdump), "-sass", str(obj)],
                                  capture_output=True, text=True).stdout
            ops = [ln.split()[1].split(".")[0] for ln in sass.splitlines()
                   if ln.strip().startswith("/*") and len(ln.split()) > 1]
            lines = ptxas.stderr.splitlines()
            keep, take = [], False
            for ln in lines:  # a kernel's "Compiling" line, then its report
                if "Compiling entry function" in ln:
                    take = any(f in ln for f in fragments)
                if take or "warning" in ln.lower():
                    keep.append(ln.strip())
            report[src.name] = {
                "ptxas": keep,
                "spills": [ln for ln in keep if "spill" in ln and
                           "0 bytes spill stores, 0 bytes spill loads"
                           not in ln],
                "hgmma": sum("HGMMA" in ln for ln in sass.splitlines()),
                "hmma": sum(o == "HMMA" for o in ops)}
    return report


def device_ms_by_kernel(fn, n: int = 10) -> dict:
    """Device time of one ``fn()`` by kernel name (the first 60 characters
    of each), as ``chip_smoke.device_ms`` sums it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            k = e.key[:60]
            out[k] = out.get(k, 0.0) + e.self_device_time_total / 1e3 / n
    return out


def host_ms(fn, n: int = 20) -> float:
    """Host time of one ``fn()`` (its wrapper's checks, allocations, tensor
    maps and launches): the median of the profiler's CPU time of a
    ``record_function`` span around each of ``n`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(n):
            with record_function("compare_call"):
                fn()
        torch.cuda.synchronize()
    spans = sorted(e.cpu_time_total for e in prof.events()
                   if e.name == "compare_call")
    return spans[len(spans) // 2] / 1e3


def cold(calls) -> float:
    """One call's device time where ``calls()`` makes one on each of
    ``chip_smoke.COLD_CACHES`` input sets in turn (None: not measured)."""
    import chip_smoke as cs
    t = cs.device_ms(calls, n=5)
    return t and t / cs.COLD_CACHES


def in_turns(kernels: dict, call) -> tuple[dict, dict]:
    """CUDA-event medians and profiler device times of ``call(fn)`` for
    each kernel, in turns: the others, "new" twice, the others reversed."""
    import chip_smoke as cs
    others = [k for k in kernels if k != "new"]
    times = {k: [] for k in kernels}
    dev = {k: [] for k in kernels}
    for k in others + ["new", "new"] + others[::-1]:
        fn = kernels[k]
        times[k].append(cs.cuda_ms(lambda: call(fn)))
        dev[k].append(cs.device_ms(lambda: call(fn)))
    return times, dev
