#!/usr/bin/env python3
"""Plant one fault at a time in a copy of the port's sources and count the
``cuda`` tests of RMSNorm and the scan that each fails, on one NVIDIA GPU.

    python3 scripts/plant_faults.py

Each fault is a one-line edit of ``csrc/rmsnorm.cu`` or
``csrc/mamba_scan.cu`` in a copy of ``src/`` and ``tests/`` under a
temporary directory (the repository is never edited); the copy builds its
own kernels and runs ``pytest --noconftest -m cuda -k "rmsnorm or scan"
tests/test_torch_cuda.py``.  One JSON line a fault: pytest's summary and
the failed tests.  Exits 1 if a fault fails no test.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CSRC = "src/repro_torch/csrc/"
# name: (file, text, the text that replaces it)
FAULTS = {
    "scan_drops_carry": (
        CSRC + "mamba_scan.cu",
        "    const BwdSmem::Stage& st = sm.stage[c & 1];\n"
        "    const int t0 = c * kChunk;\n",
        "    const BwdSmem::Stage& st = sm.stage[c & 1];\n"
        "    const int t0 = c * kChunk;\n"
        "    for (int j = 0; j < 2; ++j) for (int s = 0; s < 2; ++s) g[j][s] = 0.f;\n"),
    "rmsnorm_scale_off_rows": (
        CSRC + "rmsnorm.cu", "sc[q] = s_scale[q * nv + j];",
        "sc[q] = s_scale[q * nv + (j + 1) % nv];"),
    "rmsnorm_scale_off_row": (
        CSRC + "rmsnorm.cu", "      scale_at<V>(scale, c, s[i]);",
        "      scale_at<V>(scale, (c + V) % D, s[i]);"),
    "rmsnorm_tail_unwritten": (
        CSRC + "rmsnorm.cu",
        "    if (c < D) *reinterpret_cast<P*>(orow + c) = normed<V>(v[i], r, s[i]);",
        "    if (c < D - V) *reinterpret_cast<P*>(orow + c) = normed<V>(v[i], r, s[i]);"),
}


def run(name: str, path: str, old: str, new: str, root: Path) -> dict:
    dst = root / name
    for d in ("src", "tests"):
        shutil.copytree(REPO / d, dst / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    f = dst / path
    text = f.read_text()
    if text.count(old) != 1:
        raise SystemExit(f"{name}: the text to replace is not in {path} once")
    f.write_text(text.replace(old, new))
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-m", "cuda",
         "-k", "rmsnorm or scan", "-p", "no:cacheprovider",
         "tests/test_torch_cuda.py"],
        cwd=dst, env={**os.environ, "PYTHONPATH": str(dst / "src")},
        capture_output=True, text=True)
    lines = r.stdout.strip().splitlines()
    failed = sorted(set(re.findall(r"FAILED (\S+)", r.stdout)))
    shutil.rmtree(dst, ignore_errors=True)
    return {"fault": name, "summary": lines[-1] if lines else r.stderr[-300:],
            "n_failed": len(failed), "failed": failed}


def main() -> int:
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for name, (path, old, new) in FAULTS.items():
            line = run(name, path, old, new, Path(tmp))
            ok &= line["n_failed"] > 0
            print(json.dumps(line), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
