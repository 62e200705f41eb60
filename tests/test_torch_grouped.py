"""The port's grouped matmul, double-buffered grouped SwiGLU and
combine-reduce on the CPU, against the reference on the same numpy
inputs: the plain versions against ``repro.kernels.ref`` (the Pallas
grouped kernels cannot run here: they call ``pltpu.TPUCompilerParams``)
and against ``combine_reduce_pallas(interpret=True)``; the
``REPRO_SWIGLU_DB`` routing of ``ops.grouped_swiglu``.  The CUDA kernels are held against these
plain versions on the card in ``test_torch_cuda.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.combine_reduce import combine_reduce_pallas  # noqa: E402
from repro_torch.kernels import combine_reduce as cr  # noqa: E402
from repro_torch.kernels import grouped_matmul as gm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

# fp32 on both sides; only the summation order differs
RTOL, ATOL = 1e-5, 1e-5


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


@pytest.mark.parametrize("G,M,K,N,counted", [
    (3, 16, 24, 40, True), (2, 13, 7, 5, True),   # ragged M, K, N
    (4, 8, 32, 16, False), (1, 1, 3, 9, True)])
def test_grouped_matmul_plain_matches_ref(G, M, K, N, counted):
    """With and without counts; rows past the count are exact zeros even
    where the input is not."""
    rng = np.random.default_rng(G * 100 + K)
    x = rng.standard_normal((G, M, K)).astype(np.float32)
    w = rng.standard_normal((G, K, N)).astype(np.float32)
    counts = (rng.integers(0, M + 2, (G,)).astype(np.int32) if counted
              else None)
    ref = np.asarray(jref.grouped_matmul_ref(
        jnp.asarray(x), jnp.asarray(w),
        None if counts is None else jnp.asarray(counts)))
    got = ops.grouped_matmul(*_t(x, w), None if counts is None
                             else torch.from_numpy(counts))
    assert got.dtype == torch.float32 and got.shape == (G, M, N)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    if counts is not None:
        dead = ~np.asarray(jref.occupancy_mask(counts, G, M))
        assert (got.numpy()[dead] == 0).all()


def test_grouped_matmul_rounds_once_to_x_dtype():
    """bf16 x and fp32 w: w is cast to x's dtype (as the reference casts
    it), the sum is fp32 and the output rounds once to bf16."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 5, 24)).astype(
        np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((2, 24, 16)).astype(np.float32))
    got = ops.grouped_matmul(x, w)
    want = torch.matmul(x.float(), w.bfloat16().float()).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_grouped_matmul_and_db_refuse_bucketed_counts():
    """Flat counts only, as the TPU kernels assert (grouped_matmul.py:116,
    :303); a (G, 1) table is flat."""
    x, w = torch.zeros((2, 8, 16)), torch.zeros((2, 16, 8))
    bucketed = torch.ones((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="bucketed"):
        ops.grouped_matmul(x, w, bucketed)
    with pytest.raises(ValueError, match="bucketed"):
        gm.grouped_swiglu_db_plain(x, w, w, w.transpose(1, 2), bucketed)
    ops.grouped_matmul(x, w, torch.ones((2, 1), dtype=torch.int32))


def _swiglu_case(seed, E, C, D, F):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, C, D)).astype(np.float32)
    ws = [(rng.standard_normal(s) * 0.2).astype(np.float32)
          for s in ((E, D, F), (E, D, F), (E, F, D))]
    return rng, x, ws


@pytest.mark.parametrize("env", [None, "1", "0"])
@pytest.mark.parametrize("counts_kind", ["none", "flat", "bucketed"])
def test_ops_swiglu_db_env_routing(monkeypatch, env, counts_kind):
    """``REPRO_SWIGLU_DB=1``, read at call time, sends flat (or no) counts
    to the double-buffered kernel's plain version and bucketed counts to
    the grouped one, as ``repro.kernels.ops.grouped_swiglu`` routes them
    (tests/test_kernel_modes.py::test_ops_swiglu_db_env_routing); every
    route equals ``grouped_swiglu_ref``."""
    e, c, d, f = 3, 24, 16, 13
    rng, x, (wg, wu, wd) = _swiglu_case(9, e, c, d, f)
    counts = {"none": None, "flat": np.array([5, 0, 24], np.int32),
              "bucketed": rng.integers(0, 7, (e, 4)).astype(np.int32)
              }[counts_kind]
    ref = np.asarray(jref.grouped_swiglu_ref(
        jnp.asarray(x), wg, wu, wd,
        counts=None if counts is None else jnp.asarray(counts)))
    calls = []
    for name in ("grouped_swiglu", "grouped_swiglu_db"):
        cuda, plain = ops.KERNELS[name]
        monkeypatch.setitem(ops.KERNELS, name, (cuda, lambda *a, n=name,
                            p=plain: calls.append(n) or p(*a)))
    if env is None:
        monkeypatch.delenv("REPRO_SWIGLU_DB", raising=False)
    else:
        monkeypatch.setenv("REPRO_SWIGLU_DB", env)
    got = ops.grouped_swiglu(*_t(x, wg, wu, wd), None if counts is None
                             else torch.from_numpy(counts))
    db = env == "1" and counts_kind != "bucketed"
    assert calls == ["grouped_swiglu_db" if db else "grouped_swiglu"]
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def _ulp(a: torch.Tensor) -> torch.Tensor:
    """The spacing of ``a``'s dtype at each |value| (its smallest normal's
    spacing at 0)."""
    info = torch.finfo(a.dtype)
    mant = {torch.float32: 23, torch.bfloat16: 7}[a.dtype]
    _, exp = torch.frexp(a.float().abs().clamp_min(info.tiny))
    return torch.ldexp(torch.ones_like(a, dtype=torch.float32),
                       exp - 1 - mant)


@pytest.mark.parametrize("parts_dtype,w_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"), ("bfloat16", "bfloat16"),
    ("float32", "bfloat16")])
@pytest.mark.parametrize("T,K,D", [(37, 4, 40), (5, 1, 7), (64, 8, 256)])
def test_combine_reduce_plain_matches_pallas(parts_dtype, w_dtype, T, K, D):
    """Against ``combine_reduce_pallas(interpret=True)``: the plain version
    sums in k order and the reference in its einsum's order, both in fp32,
    so the two agree to one ulp of the output's dtype, where the fp32 sums
    may round to neighbouring values."""
    rng = np.random.default_rng(T * K + D)
    p = rng.standard_normal((T, K, D)).astype(np.float32)
    w = rng.random((T, K)).astype(np.float32)
    jp, jw = jnp.asarray(p, parts_dtype), jnp.asarray(w, w_dtype)
    ref = combine_reduce_pallas(jp, jw, interpret=True)
    tp = torch.from_numpy(np.array(jp.astype(jnp.float32))).to(
        getattr(torch, parts_dtype))
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(
        getattr(torch, w_dtype))
    got = ops.combine_reduce(tp, tw)
    assert got.dtype == tp.dtype and got.shape == (T, D)
    ref_t = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    err = (got.float() - ref_t).abs()
    # the fp32 sums differ by at most a few fp32 ulps of the terms
    slack = 4 * _ulp((tp.float() * tw.float()[..., None]).abs().sum(1))
    assert (err <= torch.maximum(_ulp(got), slack)).all(), float(err.max())


def test_combine_reduce_plain_is_k_ordered():
    """The plain version is the k-ordered fp32 loop the CUDA kernel runs,
    bit for bit: sum_k (w * p), each product and sum rounded."""
    rng = np.random.default_rng(1)
    p = torch.from_numpy(rng.standard_normal((9, 5, 33)).astype(np.float32))
    w = torch.from_numpy(rng.random((9, 5)).astype(np.float32))
    acc = torch.zeros((9, 33))
    for k in range(5):
        acc = acc + w[:, k, None] * p[:, k]
    assert torch.equal(cr.combine_reduce_plain(p, w), acc)
