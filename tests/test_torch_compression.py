"""Gradient compression over a rank-stacked world
(``repro_torch.distributed.compression``) against the reference's
``repro.distributed.compression`` on the CPU: ``quantize``, ``dequantize``
and ``pad_to_ring`` bit for bit; ``ef_compressed_mean`` and its residuals
over 8 fake devices (one subprocess) bit for bit, two rounds;
the reference test's bounds (``tests/test_distributed.py:131``) on the
port alone at P = 2, 4 and 8; and the ring's hop order."""
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.distributed import compression as J  # noqa: E402
from repro_torch.distributed import compression as C  # noqa: E402

pytestmark = pytest.mark.timeout(300)

WORLDS = (2, 4, 8)


def _grads(P, blocks=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((P, P * C.BLOCK * blocks)).astype(np.float32)


@pytest.mark.parametrize("n", [1, 255, 256, 1000, 4096])
def test_quantize_dequantize_bit_for_bit(n):
    x = (np.random.default_rng(n).standard_normal(n) * 3).astype(np.float32)
    x[: n // 3] = 0.0                     # all-zero blocks: scale 0
    q, tq = J.quantize(jnp.asarray(x)), C.quantize(torch.from_numpy(x))
    assert tq.q.dtype == torch.int8 and tq.q.shape == (-(-n // 256), 256)
    np.testing.assert_array_equal(np.asarray(q.q), tq.q.numpy())
    np.testing.assert_array_equal(np.asarray(q.scale), tq.scale.numpy())
    np.testing.assert_array_equal(np.asarray(J.dequantize(q, n)),
                                  C.dequantize(tq, n).numpy())


def test_quantize_rank_stacked_rows_each_their_own():
    """A (P, n) stack quantises row by row: each row as it would alone."""
    g = _grads(4)
    both = C.quantize(torch.from_numpy(g))
    for r in range(4):
        one = C.quantize(torch.from_numpy(g[r]))
        assert torch.equal(both.q[r], one.q)
        assert torch.equal(both.scale[r], one.scale)


@pytest.mark.parametrize("shape,P", [((1000,), 4), ((10, 100), 4),
                                     ((3, 7), 8), ((2048,), 8)])
def test_pad_to_ring(shape, P):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    got = C.pad_to_ring(torch.from_numpy(x), P).numpy()
    np.testing.assert_array_equal(got, np.asarray(J.pad_to_ring(
        jnp.asarray(x), P)))
    assert got.size % (P * C.BLOCK) == 0


_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.distributed.compression import BLOCK, ef_compressed_mean
    out = {}
    for P in (8,):
        mesh = jax.make_mesh((P,), ("data",), axis_types=(AxisType.Auto,),
                             devices=jax.devices()[:P])
        g = np.random.default_rng(P).standard_normal(
            (P, P * BLOCK * 2)).astype(np.float32)
        mean, res = ef_compressed_mean(jnp.asarray(g), mesh, "data")
        mean2, res2 = ef_compressed_mean(jnp.asarray(g), mesh, "data",
                                         residual=res)
        for k, v in (("mean", mean), ("res", res), ("mean2", mean2),
                     ("res2", res2)):
            out[f"{P}/{k}"] = np.asarray(v)
    np.savez(sys.argv[1], **out)
    print("COMPRESS-JAX-OK")
""")


@pytest.fixture(scope="module")
def jax_ef(tmp_path_factory, dist_runner):
    d = tmp_path_factory.mktemp("compress")
    script = (f"import sys\nsys.argv[1:] = [{str(d / 'out.npz')!r}]\n"
              + _SCRIPT)
    assert "COMPRESS-JAX-OK" in dist_runner(script, n_devices=8, timeout=600)
    res = np.load(d / "out.npz")
    return {k: res[k] for k in res.files}


def test_ef_compressed_mean_bit_for_bit(jax_ef):
    """Both rounds' means and residuals over 8 ranks equal the
    reference's bit for bit: the same quantizer, the same hop order, fp32
    accumulation."""
    P = 8
    g = torch.from_numpy(np.random.default_rng(P).standard_normal(
        (P, P * C.BLOCK * 2)).astype(np.float32))
    mean, res = C.ef_compressed_mean(g)
    mean2, res2 = C.ef_compressed_mean(g, res)
    for k, v in (("mean", mean), ("res", res), ("mean2", mean2),
                 ("res2", res2)):
        np.testing.assert_array_equal(v.numpy(), jax_ef[f"{P}/{k}"], k)


@pytest.mark.parametrize("P", WORLDS)
def test_reference_bounds_on_the_port(P):
    """The reference test's two bounds, on the port alone: the mean within
    0.05 x its largest value + 0.05 of the true mean, and a second round
    with the first's residuals no worse on average than 1.05 x one."""
    g = torch.from_numpy(_grads(P))
    true_mean = g.mean(0)
    mean, res = C.ef_compressed_mean(g)
    err = float((mean - true_mean).abs().max())
    assert err < 0.05 * float(true_mean.abs().max()) + 0.05, err
    mean2, _ = C.ef_compressed_mean(g, res)
    base = float((mean - true_mean).abs().mean())
    assert float(((mean + mean2) / 2 - true_mean).abs().mean()) <= 1.05 * base
    assert float((mean - true_mean).abs().max()) > 0      # it is lossy


def _ring_by_rank(x):
    """The reference's ring written rank by rank: rank i starts on chunk
    (i - 1) % P; each hop it receives rank i - 1's quantised partial sum,
    dequantises it, adds its own chunk of that id, and requantises."""
    P, n = x.shape
    chunk = n // P
    xc = x.reshape(P, P, chunk)
    held = [(i - 1) % P for i in range(P)]
    qs = [C.quantize(xc[i, held[i]]) for i in range(P)]
    for _ in range(P - 1):
        qs = [qs[(i - 1) % P] for i in range(P)]          # i - 1 -> i
        held = [(h - 1) % P for h in held]
        qs = [C.quantize(C.dequantize(qs[i], chunk) + xc[i, held[i]])
              for i in range(P)]
    assert held == list(range(P))
    return torch.stack([C.dequantize(q, chunk) for q in qs])


@pytest.mark.parametrize("P", WORLDS)
def test_psum_scatter_equals_the_ring_rank_by_rank(P):
    """The rank-stacked ring (a roll of the rank axis a hop) equals the
    ring written rank by rank bit for bit, and row r is chunk r of the sum
    within the int8 hops' error."""
    x = torch.from_numpy(_grads(P, seed=3))
    got = C.compressed_psum_scatter(x)
    assert torch.equal(got, _ring_by_rank(x))
    want = x.sum(0).reshape(P, -1)
    assert float((got - want).abs().max()) < 0.05 * float(
        want.abs().max()) * P


def test_ef_compressed_mean_refuses_unpadded():
    with pytest.raises(AssertionError, match="pad input"):
        C.ef_compressed_mean(torch.zeros(4, 1000))
