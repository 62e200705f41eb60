"""The port's repo lint (``repro_torch.analysis.lint``) against the
reference's (``repro.analysis.lint``): every planted case of the
reference's lint tests flags the same rule ids under the port's paths on
both sides, the CUDA rule ``LNT-CU-OCC`` catches planted kernels that read
no count or never gate on it (and passes the guarded forms, a helper's
guard included), the shipped ``src/repro_torch`` is clean, and the module
runs as ``python -m repro_torch.analysis.lint``."""
import os
import subprocess
import sys

import pytest

from repro.analysis import lint as r_lint
from repro_torch.analysis import CATALOG
from repro_torch.analysis import lint as t_lint

pytestmark = pytest.mark.timeout(60)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_REPO, "src", "repro_torch")

T = "src/repro_torch/core/transport/"

# (source, path under the port, the rule ids both lints give): the
# reference's planted cases of tests/test_analysis.py, at the port's paths
PLANTED = [
    ("x = (w >> 16) & 0xFF\ny = s & 0b11111\n", T + "proxy.py",
     ["LNT-BITMASK", "LNT-BITMASK"]),
    ("CH_MASK = 0xFF\n", T + "wire_format.py", []),
    ("CH_MASK = 0xFF\n", "src/repro_torch/core/plan.py", []),
    ("a = f & 0x3\nb = f | 0x10\nc = 0xA0\n", T + "proxy.py", []),
    ("def enc(x):\n"
     "    s = np.abs(x).max() / FP8_MAX\n"
     "    return x / np.float32(127.0)\n", T + "codec.py",
     ["LNT-SCALE-DIV", "LNT-SCALE-DIV"]),
    ("def enc(x):\n    return x / QMAX\n",
     "src/repro_torch/kernels/quantize_pack.py", ["LNT-SCALE-DIV"]),
    ("_QINV = 1.0 / 448.0\ndef enc(x, scale):\n    return x / scale\n",
     T + "codec.py", []),
    ("def f(x):\n    return x / 2.0\n", T + "proxy.py", []),
    ("def f(seq, ch):\n    assert seq < SEQ_MOD and ch >= 0\n",
     T + "semantics.py", ["LNT-ASSERT-PROTO"]),
    ("def f(a):\n    assert a\n", T + "semantics.py", []),
    ("def f(seq, ch):\n    assert seq < SEQ_MOD and ch >= 0\n",
     "src/repro_torch/core/plan.py", []),
    ("def _foo_kernel(x_ref, cnt_ref, o_ref):\n"
     "    o_ref[...] = x_ref[...]\n",
     "src/repro_torch/kernels/grouped_matmul.py", ["LNT-PL-WHEN"]),
    ("def _foo_kernel(x_ref, cnt_ref, o_ref):\n"
     "    @pl.when(i < cnt_ref[0])\n"
     "    def _():\n"
     "        o_ref[...] = x_ref[...]\n",
     "src/repro_torch/kernels/grouped_matmul.py", []),
    ("def _rms_kernel(x_ref, o_ref):\n    o_ref[...] = x_ref[...]\n",
     "src/repro_torch/kernels/norm_attention.py", []),
    ("def f(:\n", "src/repro_torch/core/plan.py", ["LNT-PARSE"]),
]


def _ids(findings):
    return [f.rule for f in findings]


@pytest.mark.parametrize("src,path,want", PLANTED,
                         ids=[f"{p.split('/')[-1]}-{i}"
                              for i, (_, p, _w) in enumerate(PLANTED)])
def test_planted_cases_flag_the_reference_ids(src, path, want):
    assert _ids(t_lint.lint_source(src, path)) == want
    assert _ids(r_lint.lint_source(src, path)) == want


CU_HEAD = "#include <cuda_runtime.h>\n// a kernel, with a comment: cnt\n"

CU_BAD = {
    "never_reads_cnt": (
        "__global__ void __launch_bounds__(256)\n"
        "    scale_kernel(const float* __restrict__ x, const int* cnt,\n"
        "                 float* y, int C) {\n"
        "  const int i = blockIdx.x * C + threadIdx.x;\n"
        "  y[i] = x[i] * 2.0f;\n"
        "}\n"),
    "reads_cnt_never_gates": (
        "template <int V>\n"
        "__global__ void rows_kernel(const float* x, const int* counts,\n"
        "                            float* y, int C) {\n"
        "  const int i = blockIdx.x * C + threadIdx.x;\n"
        "  const float n = (float)counts[blockIdx.x];  // read, no branch\n"
        "  const int c = counts ? counts[blockIdx.x] : C;\n"
        "  for (int r = threadIdx.x; r < C; r += blockDim.x)\n"
        "    y[blockIdx.x * C + r] = x[blockIdx.x * C + r] * n + c;\n"
        "  if (i < C) y[i] += 1.0f;\n"
        "}\n"),
    "helper_never_gates": (
        "__device__ __forceinline__ void copy_rows(const float* x, float* y,\n"
        "                                          int n, int C) {\n"
        "  for (int r = 0; r < C; ++r) y[r] = x[r] * n;\n"
        "}\n"
        "__global__ void k(const float* x, const int* occ_e, float* y,\n"
        "                  int C) {\n"
        "  copy_rows(x + blockIdx.x * C, y + blockIdx.x * C,\n"
        "            occ_e[blockIdx.x], C);\n"
        "}\n"),
}

CU_GOOD = {
    "returns_past_count": (
        "__global__ void k(const float* x, const int* cnt, float* y, int C) {\n"
        "  const int e = blockIdx.x, r = threadIdx.x;\n"
        "  if (r >= cnt[e]) return;\n"
        "  y[e * C + r] = x[e * C + r];\n"
        "}\n"),
    "loop_bounded_through_a_local": (
        "__global__ void k(const float* x, const int* counts, float* y,\n"
        "                  int C) {\n"
        "  const int n = min(max(counts[blockIdx.x], 0), C);\n"
        "  for (int r = threadIdx.x; r < n; r += blockDim.x)\n"
        "    y[blockIdx.x * C + r] = x[blockIdx.x * C + r];\n"
        "}\n"),
    "skips_under_an_if": (
        "__global__ void k(const float* x, const int* cnt, float* y, int C) {\n"
        "  int row = -1;\n"
        "  const int c = cnt ? cnt[blockIdx.x] : C;\n"
        "  if (threadIdx.x < c) {\n"
        "    y[threadIdx.x] = x[threadIdx.x];\n"
        "  }\n"
        "}\n"),
    "helper_bounds_its_loop": (
        "template <int EPI>\n"
        "__device__ void tile_rows(const float* x, float* y, int n_rows) {\n"
        "  for (int r = threadIdx.x; r < n_rows; r += blockDim.x) y[r] = x[r];\n"
        "}\n"
        "__global__ void k(const float* x, const int* cnt, float* y, int C) {\n"
        "  const int n = cnt[blockIdx.x];\n"
        "  tile_rows<0>(x + blockIdx.x * C, y + blockIdx.x * C, n);\n"
        "}\n"),
    "no_count_parameter": (
        "__global__ void k(const float* x, float* y, int n) {\n"
        "  y[threadIdx.x] = x[threadIdx.x];\n"
        "}\n"),
    "device_helper_alone": (
        "__device__ float twice(const float* x, int cnt) { return 2 * x[0]; }\n"),
}


@pytest.mark.parametrize("name", sorted(CU_BAD))
@pytest.mark.parametrize("ext", [".cu", ".cuh"])
def test_cuda_rule_flags_ungated_kernels(name, ext):
    path = f"src/repro_torch/csrc/planted{ext}"
    got = t_lint.lint_source(CU_HEAD + CU_BAD[name], path)
    assert _ids(got) == ["LNT-CU-OCC"], got
    # the finding points at the kernel's __global__ line
    line = (CU_HEAD + CU_BAD[name]).splitlines()[got[0].line - 1]
    assert "__global__" in line


@pytest.mark.parametrize("name", sorted(CU_GOOD))
def test_cuda_rule_passes_gated_kernels(name):
    assert t_lint.lint_source(CU_HEAD + CU_GOOD[name],
                              "src/repro_torch/csrc/planted.cu") == []


def test_cuda_rule_finds_a_helper_in_an_included_header(tmp_path):
    """A kernel whose guard lives in a ``__device__`` helper of a header it
    includes (as the grouped kernels' tile loop lives in
    ``swiglu_tiles.cuh``) passes; the same kernel without the header in
    reach, or with a helper that never gates, is flagged."""
    (tmp_path / "tiles.cuh").write_text(
        "__device__ void tile_loop(const float* x, float* y, int rows) {\n"
        "  for (int r = 0; r < rows; ++r) y[r] = x[r];\n"
        "}\n")
    (tmp_path / "bad_tiles.cuh").write_text(
        "__device__ void tile_loop(const float* x, float* y, int rows) {\n"
        "  y[0] = x[0] * rows;\n"
        "}\n")
    kern = ('#include "{h}"\n'
            "__global__ void k(const float* x, const int* cnt, float* y) {{\n"
            "  tile_loop(x, y, cnt[blockIdx.x]);\n"
            "}}\n")
    good = tmp_path / "k.cu"
    good.write_text(kern.format(h="tiles.cuh"))
    bad = tmp_path / "k_bad.cu"
    bad.write_text(kern.format(h="bad_tiles.cuh"))
    missing = tmp_path / "k_missing.cu"
    missing.write_text(kern.format(h="absent.cuh"))
    by_path = {f.path: f.rule for f in t_lint.lint_paths([str(tmp_path)])}
    assert by_path == {str(bad): "LNT-CU-OCC", str(missing): "LNT-CU-OCC"}


@pytest.mark.parametrize("src,fault", [
    ("gather_rows", "  if (slot - e * C >= cnt[e]) return;\n"),
    ("fold_scales_kernel",
     "  if (cnt && s % C >= min(max(cnt[s / C], 0), C)) return;"
     "  // past its count\n"),
    ("gather_quantize_kernel",
     "      if (s % C < c) row = min(max(r, 0), Tp1 - 1);\n"),
])
def test_cuda_rule_catches_the_shipped_guards_removed(src, fault):
    """Each shipped kernel that takes a count, with its count guard deleted
    (the row then loaded whatever its count), is flagged; as shipped it is
    clean."""
    files = {"gather_rows": "swiglu_bwd.cu",
             "fold_scales_kernel": "wire_bwd.cu",
             "gather_quantize_kernel": "gather_quantize.cu"}
    path = os.path.join(_SRC, "csrc", files[src])
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    assert fault in text
    assert t_lint.lint_source(text, path) == []
    got = t_lint.lint_source(text.replace(fault, "\n"), path)
    assert [(f.rule, src in f.message) for f in got] == [("LNT-CU-OCC", True)]


def test_lint_clean_on_the_port():
    """The shipped port passes its own lint, its CUDA sources included."""
    findings = t_lint.lint_paths([_SRC])
    assert findings == [], "\n".join(str(f) for f in findings)
    n_cu = sum(f.endswith((".cu", ".cuh"))
               for _, _, fs in os.walk(os.path.join(_SRC, "csrc")) for f in fs)
    assert n_cu > 10


def test_lint_module_runs_and_fails_on_a_finding(tmp_path):
    env = {**os.environ, "PYTHONPATH": os.path.join(_REPO, "src")}
    ok = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint"],
                        cwd=_REPO, env=env, capture_output=True, text=True,
                        timeout=60)
    assert ok.returncode == 0 and "lint: clean" in ok.stdout, ok
    assert "RuntimeWarning" not in ok.stderr, ok.stderr
    bad = tmp_path / "planted.cu"
    bad.write_text(CU_BAD["never_reads_cnt"])
    no = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint",
                         str(bad)], cwd=_REPO, env=env, capture_output=True,
                        text=True, timeout=60)
    assert no.returncode == 1 and "LNT-CU-OCC" in no.stdout, no


def test_rule_ids_in_catalog():
    for rid in ("LNT-BITMASK", "LNT-SCALE-DIV", "LNT-ASSERT-PROTO",
                "LNT-PL-WHEN", "LNT-CU-OCC"):
        assert rid in CATALOG, rid
