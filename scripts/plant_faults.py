#!/usr/bin/env python3
"""Plant one fault at a time in a copy of the port's sources and count the
``cuda`` tests of RMSNorm, the scan, the wire kernels, the double-buffered
grouped SwiGLU, flash attention, flash decoding (contiguous and paged), the
replayed Mamba decode step and the EP backward kernels that each fails, on
one NVIDIA GPU.

    python3 scripts/plant_faults.py [FAULT ...]

Each fault (all of ``FAULTS``, or those named) is a one-line edit of
``csrc/mamba_scan.cu``, ``csrc/dequantize.cu``, ``csrc/rmsnorm.cu``,
``csrc/gather_quantize.cu``, ``csrc/grouped_swiglu_db.cu``,
``csrc/flash_attention.cu``, ``csrc/decode_attention_paged.cu``, the
decoders' shared body
``csrc/decode_common.cuh``, the tile loop's backward passes in
``csrc/swiglu_tiles.cuh``, ``csrc/swiglu_bwd.cu``, ``csrc/wire_bwd.cu``
or ``launch/serve.py``
(the cache reset after a decode step's capture) in a copy of ``src/`` and ``tests/`` under a
temporary directory (the repository is never edited); the copy builds its
own kernels and runs ``pytest --noconftest -m cuda -k TESTS
tests/test_torch_cuda.py``.  One JSON line
a fault: pytest's summary and the failed tests.  Exits 1 if a fault fails
no test.
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
TESTS = ("rmsnorm or scan or quantize or swiglu_db or paged or "
         "graph_matches_eager_mamba or bwd or train_through or flash or "
         "decode_attention")
# name: (file, text, the text that replaces it)
FAULTS = {
    "scan_drops_carry": (
        CSRC + "mamba_scan.cu",
        "    const BwdSmem::Stage& st = sm.stage[c & 1];\n"
        "    const int t0 = c * kChunk;\n",
        "    const BwdSmem::Stage& st = sm.stage[c & 1];\n"
        "    const int t0 = c * kChunk;\n"
        "    for (int j = 0; j < 2; ++j) for (int s = 0; s < 2; ++s) g[j][s] = 0.f;\n"),
    "scan_fwd_skips_states": (
        CSRC + "mamba_scan.cu", "    if (st_out != nullptr && d_ok)\n",
        "    if (st_out != nullptr && d_ok && c == 0)\n"),
    "scan_fwd_drops_lane": (
        CSRC + "mamba_scan.cu",
        "    // sum over the channel's 4 lanes: lane q keeps steps 2 q and 2 q + 1\n",
        "    if (q == 3) for (int i = 0; i < kChunk; ++i) acc[i] = 0.f;\n"),
    "dequantize_next_scale": (
        CSRC + "dequantize.cu", "scales[(size_t)r * nb + c / kBlock]",
        "scales[(size_t)r * nb + (c / kBlock + 1) % nb]"),
    "dequantize_last_vector_unwritten": (
        CSRC + "dequantize.cu", "    if (i < total) {\n      if constexpr",
        "    if (i < total && (i + 1) % per_row != 0) {\n      if constexpr"),
    "rmsnorm_scale_off_rows": (
        CSRC + "rmsnorm.cu", "sc[q] = s_scale[q * nv + j];",
        "sc[q] = s_scale[q * nv + (j + 1) % nv];"),
    "rmsnorm_scale_off_row": (
        CSRC + "rmsnorm.cu", "      scale_at<V>(scale, c, s[i]);",
        "      scale_at<V>(scale, (c + V) % D, s[i]);"),
    "gather_quantize_skips_zero_fill": (
        CSRC + "gather_quantize.cu",
        "        reinterpret_cast<uint4*>(qrow)[i] = make_uint4(0, 0, 0, 0);",
        "        ;"),
    "gather_quantize_next_block_absmax": (
        CSRC + "gather_quantize.cu",
        "    const float a = fmaxf(fmaxf(fabsf(v[j][0]), fabsf(v[j][1])),\n"
        "                          fmaxf(fabsf(v[j][2]), fabsf(v[j][3])));",
        "    const float (&vn)[4] = v[(j + 1) % kN];\n"
        "    const float a = fmaxf(fmaxf(fabsf(vn[0]), fabsf(vn[1])), "
        "fmaxf(fabsf(vn[2]), fabsf(vn[3])));"),
    "gather_quantize_direct_e4m3": (
        CSRC + "gather_quantize.cu",
        "__nv_cvt_halfraw2_to_fp8x2(h, __NV_SATFINITE, __NV_E4M3)",
        "__nv_cvt_float2_to_fp8x2(make_float2(y[2 * p], y[2 * p + 1]), "
        "__NV_SATFINITE, __NV_E4M3)"),
    "swiglu_db_next_expert_count": (
        CSRC + "grouped_swiglu_db.cu",
        "  up.cnt = static_cast<const int*>(cnt);",
        "  up.cnt = static_cast<const int*>(cnt) + 1;"),
    "rmsnorm_tail_unwritten": (
        CSRC + "rmsnorm.cu",
        "    if (c < D) *reinterpret_cast<P*>(orow + c) = normed<V>(v[i], r, s[i]);",
        "    if (c < D - V) *reinterpret_cast<P*>(orow + c) = normed<V>(v[i], r, s[i]);"),
    "paged_next_column": (
        CSRC + "decode_attention_paged.cu",
        "__ldg(p.tables + (long long)b * p.nb + c)",
        "__ldg(p.tables + (long long)b * p.nb + min(c + 1, p.nb - 1))"),
    "paged_reads_dead_rows": (
        CSRC + "decode_common.cuh", '"r"(live ? 16 : 0));', '"r"(16));'),
    # the head dim 64 paths: flash attention's PV product weighting each
    # 16-key step's values by its neighbour's probabilities; the decoders'
    # merge at D = 64 (two threads a feature) leaving the odd heads to no
    # thread
    "flash_d64_pv_wrong_keys": (
        CSRC + "flash_attention.cu", "        wgmma_rs_n64(o, pa[kk], dv);",
        "        wgmma_rs_n64(o, pa[kk ^ 1], dv);"),
    "decode_d64_merge_even_heads": (
        CSRC + "decode_common.cuh",
        "  const int r0 = kSplit == 1 ? 0 : tid / D;",
        "  const int r0 = 0;"),
    "paged_merge_drops_last_chunk": (
        CSRC + "decode_common.cuh",
        "const bool in = (c0 + j) * p.chunk < n_live;",
        "const bool in = (c0 + j + 1) * p.chunk < n_live;"),
    # the EP backward kernels: HT's slot weight left out of dH; the odd
    # rows' dX never added; every sub-bucket reduced over the first one's
    # count; the wire's gradient at every element (straight through), or
    # unshared between tied elements, or the rows no slot names left
    # unwritten (the table's gradient has no memset); a lane's products
    # left out.  The
    # SwiGLU backward's passes run on the tile loop (swiglu_tiles.cuh;
    # these lines are the backward's alone), LL's sub-buckets are packed
    # by its prepass (swiglu_bwd.cu)
    "swiglu_bwd_unweighted": (
        CSRC + "swiglu_tiles.cuh",
        "const float wv = occ && p.s_w != nullptr ? p.s_w[slot] : 1.f;",
        "const float wv = 1.f;"),
    "swiglu_bwd_drops_odd_rows": (
        CSRC + "swiglu_tiles.cuh",
        "const float wv = EPI == kDownScatter ? p.s_w[slot] : 1.f;",
        "const float wv = EPI == kDownScatter ? p.s_w[slot] : (r % 2 ? 0.f : 1.f);"),
    "swiglu_bwd_first_bucket_count": (
        CSRC + "swiglu_bwd.cu",
        "const int n = min(max(cnt[e * B + k], 0), Cg);",
        "const int n = min(max(cnt[e * B], 0), Cg);"),
    "wire_bwd_straight_through": (
        CSRC + "wire_bwd.cu",
        "const bool at = m > 0.f && fabsf(v[g][i]) == m;",
        "const bool at = m > 0.f;"),
    "wire_bwd_unshared_ties": (
        CSRC + "wire_bwd.cu", "__fdiv_rn(f, ties)", "f"),
    "wire_bwd_skips_unnamed_rows": (
        CSRC + "wire_bwd.cu",
        "      for (int k = 0; k < n32; ++k) store4<kVec>(dr, b32 + k, lane, "
        "D, zero);\n",
        ""),
    "dequantize_bwd_drops_lane": (
        CSRC + "wire_bwd.cu",
        "if (j < D) acc += dy[r * D + j]",
        "if (j < D && lane) acc += dy[r * D + j]"),
    # the capture's warm-up steps leave their conv and ssm states behind
    "serve_skips_cache_reset": (
        "src/repro_torch/launch/serve.py", "        Z.reset_cache(cache)\n",
        "        pass\n"),
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
         "-k", TESTS, "-p", "no:cacheprovider",
         "tests/test_torch_cuda.py"],
        cwd=dst, env={**os.environ, "PYTHONPATH": str(dst / "src")},
        capture_output=True, text=True)
    lines = r.stdout.strip().splitlines()
    failed = sorted(set(re.findall(r"FAILED (\S+)", r.stdout)))
    shutil.rmtree(dst, ignore_errors=True)
    return {"fault": name, "summary": lines[-1] if lines else r.stderr[-300:],
            "n_failed": len(failed), "failed": failed}


def main() -> int:
    names = sys.argv[1:] or list(FAULTS)
    unknown = set(names) - set(FAULTS)
    if unknown:
        raise SystemExit(f"no such fault: {sorted(unknown)}")
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            path, old, new = FAULTS[name]
            line = run(name, path, old, new, Path(tmp))
            ok &= line["n_failed"] > 0
            print(json.dumps(line), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
