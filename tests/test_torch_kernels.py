"""The port's four kernels of the serving path.

On the CPU: each plain PyTorch version against the reference's jnp
oracles (``repro.kernels.ref``, the ``quantize_pack`` refs) on the same
numpy inputs, in fp32; the device dispatch of ``kernels.ops``; and the
CUDA wrappers refusing CPU tensors.  The CUDA kernels themselves are held
against these plain versions on the card in ``test_torch_cuda.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.quantize_pack import (dequantize_ref,  # noqa: E402
                                         gather_quantize_ref)
from repro_torch.kernels import grouped_matmul as gm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quantize_pack as qp  # noqa: E402

# fp32 on both sides; only the summation order differs
RTOL, ATOL = 1e-5, 1e-5


def _w(rng, E, D, F, s=0.2):
    return [(rng.standard_normal(sh) * s).astype(np.float32)
            for sh in ((E, D, F), (E, D, F), (E, F, D))]


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


@pytest.mark.parametrize("E,C,D,F,B", [(3, 16, 24, 40, 1), (2, 12, 16, 13, 1),
                                       (4, 16, 8, 24, 4), (3, 10, 16, 7, 2)])
def test_grouped_swiglu_plain_matches_ref(E, C, D, F, B):
    """Flat (E,) and bucketed (E, B) counts, ragged F; rows past the count
    are exact zeros even when the input there is not."""
    rng = np.random.default_rng(E * 100 + F)
    x = rng.standard_normal((E, C, D)).astype(np.float32)
    wg, wu, wd = _w(rng, E, D, F)
    shape = (E,) if B == 1 else (E, B)
    counts = rng.integers(0, C // B + 2, shape).astype(np.int32)
    ref = np.asarray(jref.grouped_swiglu_ref(jnp.asarray(x), wg, wu, wd,
                                             counts=jnp.asarray(counts)))
    got = gm.grouped_swiglu_plain(*_t(x, wg, wu, wd, counts)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    mask = np.asarray(jref.occupancy_mask(counts, E, C))
    assert (got[~mask] == 0).all()
    dense = gm.grouped_swiglu_plain(*_t(x, wg, wu, wd)).numpy()
    np.testing.assert_allclose(
        dense, np.asarray(jref.grouped_swiglu_ref(x, wg, wu, wd)),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("T,E,C,D,F,dup", [(20, 4, 8, 16, 13, False),
                                           (9, 3, 12, 24, 32, True),
                                           (1, 2, 4, 8, 8, True)])
def test_gather_swiglu_scatter_plain_matches_ref(T, E, C, D, F, dup):
    """Slots gather rows of the (T+1, D) table and add, weighted, into
    their token; duplicate tokens add up; slots past the count do nothing."""
    rng = np.random.default_rng(T + C)
    x_ext = rng.standard_normal((T + 1, D)).astype(np.float32)
    x_ext[T] = 0.0
    counts = rng.integers(0, C + 1, (E,)).astype(np.int32)
    src = rng.integers(0, T, (E * C,)).astype(np.int32)
    if dup:
        src[: E * C // 2] = 0                       # one token, many slots
    w = rng.random((E * C,)).astype(np.float32)
    wg, wu, wd = _w(rng, E, D, F)
    ref = np.asarray(jref.gather_swiglu_scatter_ref(
        jnp.asarray(x_ext), jnp.asarray(src), jnp.asarray(w), wg, wu, wd,
        counts=jnp.asarray(counts)))
    got = gm.gather_swiglu_scatter_plain(*_t(x_ext, src, w, wg, wu, wd,
                                             counts)).numpy()
    assert got.shape == (T, D) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("wire", ["fp8", "int8"])
@pytest.mark.parametrize("D", [200, 256])
def test_gather_quantize_plain_bit_exact(wire, D):
    """Bytes and scales equal the reference's numpy oracle, including zero
    bytes and zero scales past each bucket's count."""
    rng = np.random.default_rng(D + len(wire))
    T, E, C = 30, 4, 8
    x_ext = (rng.standard_normal((T + 1, D)) * 3).astype(np.float32)
    x_ext[T] = 0.0
    src = rng.integers(0, T + 1, (E * C,)).astype(np.int32)
    counts = np.array([0, 3, 8, 5], np.int32)
    q_ref, s_ref = gather_quantize_ref(x_ext, src, counts, wire_dtype=wire)
    q, s = qp.gather_quantize_plain(*_t(x_ext, src, counts), wire_dtype=wire)
    np.testing.assert_array_equal(q.view(torch.uint8).numpy(),
                                  np.asarray(q_ref).view(np.uint8))
    np.testing.assert_array_equal(s.numpy(), s_ref)
    dead = ~np.asarray(jref.occupancy_mask(counts, E, C)).reshape(-1)
    assert (q.view(torch.uint8).numpy()[dead] == 0).all()
    assert (s.numpy()[dead] == 0).all()
    np.testing.assert_array_equal(dequantize_ref(q_ref, s_ref),
                                  qp.dequantize_plain(q, s).numpy())
    # dense (counts=None): every slot quantized, scratch rows to zeros
    qd, sd = qp.gather_quantize_plain(*_t(x_ext, src), wire_dtype=wire)
    qd_ref, sd_ref = gather_quantize_ref(x_ext, src, None, wire_dtype=wire)
    np.testing.assert_array_equal(qd.view(torch.uint8).numpy(),
                                  np.asarray(qd_ref).view(np.uint8))
    np.testing.assert_array_equal(sd.numpy(), sd_ref)


@pytest.mark.parametrize("wire", ["fp8", "int8"])
@pytest.mark.parametrize("D", [130, 256])
def test_gather_quantize_plain_ll_pattern(wire, D):
    """The LL decode step's dispatch: most buckets empty, one at its
    capacity, the rest partial; empty slots name the scratch row.  Bytes
    and scales equal the reference's oracle; every empty slot is zero
    bytes with zero scales."""
    rng = np.random.default_rng(D * 7 + len(wire))
    T, E, C = 12, 32, 4
    x_ext = (rng.standard_normal((T + 1, D))
             * rng.uniform(1e-3, 1e3, (T + 1, 1))).astype(np.float32)
    x_ext[T] = 0.0
    counts = np.zeros(E, np.int32)
    counts[[3, 9, 17, 30]] = [C, 1, 2, 3]
    occ = np.arange(C)[None, :] < counts[:, None]
    src = np.where(occ, rng.integers(0, T, (E, C)), T).astype(
        np.int32).reshape(-1)
    q_ref, s_ref = gather_quantize_ref(x_ext, src, counts, wire_dtype=wire)
    q, s = qp.gather_quantize_plain(*_t(x_ext, src, counts), wire_dtype=wire)
    np.testing.assert_array_equal(q.view(torch.uint8).numpy(),
                                  np.asarray(q_ref).view(np.uint8))
    np.testing.assert_array_equal(s.numpy(), s_ref)
    dead = ~occ.reshape(-1)
    assert dead.sum() == E * C - C - 6
    assert (q.view(torch.uint8).numpy()[dead] == 0).all()
    assert (s.numpy()[dead] == 0).all()
    assert (s.numpy()[~dead] > 0).all()


def _small_case(dtype=torch.float32, device="cpu"):
    rng = np.random.default_rng(0)
    E, C, D, F = 2, 8, 16, 24
    x = torch.from_numpy(rng.standard_normal((E, C, D)).astype(np.float32))
    ws = [torch.from_numpy(w) for w in _w(rng, E, D, F)]
    return [t.to(device=device, dtype=dtype) for t in [x, *ws]]


def test_ops_dispatch_cpu_takes_plain_version():
    x, wg, wu, wd = _small_case()
    counts = torch.tensor([3, 8], dtype=torch.int32)
    np.testing.assert_array_equal(
        ops.grouped_swiglu(x, wg, wu, wd, counts).numpy(),
        gm.grouped_swiglu_plain(x, wg, wu, wd, counts).numpy())
    q, s = ops.gather_quantize(x[0], torch.arange(8), wire_dtype="fp8")
    np.testing.assert_array_equal(
        ops.dequantize_tokens(q, s).numpy(),
        qp.dequantize_plain(q, s).numpy())
    assert set(ops.KERNELS) == {"grouped_matmul", "grouped_swiglu",
                                "grouped_swiglu_db", "gather_swiglu_scatter",
                                "gather_quantize", "dequantize",
                                "mamba_scan", "mamba_scan_bwd", "rmsnorm",
                                "flash_attention", "decode_attention",
                                "decode_attention_paged", "combine_reduce",
                                "grouped_swiglu_bwd",
                                "gather_swiglu_scatter_bwd",
                                "gather_quantize_bwd", "dequantize_bwd",
                                "mla_decode", "gather_rows",
                                "combine_reduce_bwd"}


@pytest.mark.parametrize("name", ["grouped_swiglu", "gather_swiglu_scatter",
                                  "gather_quantize", "dequantize", "rmsnorm",
                                  "flash_attention", "decode_attention",
                                  "grouped_matmul", "grouped_swiglu_db",
                                  "combine_reduce", "decode_attention_paged",
                                  "grouped_swiglu_bwd",
                                  "gather_swiglu_scatter_bwd",
                                  "gather_quantize_bwd", "dequantize_bwd",
                                  "mla_decode", "gather_rows",
                                  "combine_reduce_bwd", "combine_gathered",
                                  "dequantize_rows"])
def test_cuda_wrapper_refuses_cpu_tensors(name):
    """A CUDA wrapper launches its kernel or raises: on CPU tensors it
    raises before touching the kernel library and counts no launch."""
    x, wg, wu, wd = _small_case(torch.bfloat16)
    form = {"combine_gathered": "combine_reduce",
            "dequantize_rows": "dequantize"}
    cuda = ops.KERNELS[form.get(name, name)][0]
    before = cuda.launches
    args = {
        "grouped_swiglu": lambda: cuda(x, wg, wu, wd, None),
        "gather_swiglu_scatter": lambda: cuda(
            x[0], torch.zeros(16, dtype=torch.int32), torch.zeros(16),
            wg, wu, wd, None),
        "gather_quantize": lambda: cuda(x[0].float(), torch.arange(8),
                                        wire_dtype="int8"),
        "dequantize": lambda: cuda(torch.zeros((4, 16), dtype=torch.int8),
                                   torch.ones((4, 1))),
        "rmsnorm": lambda: cuda(x[0], torch.ones(16), 1e-5),
        "flash_attention": lambda: cuda(*[torch.zeros(
            (1, 8, 2, 128), dtype=torch.bfloat16)] * 3),
        "decode_attention": lambda: cuda(torch.zeros(
            (1, 2, 128), dtype=torch.bfloat16), *[torch.zeros(
                (1, 8, 2, 128), dtype=torch.bfloat16)] * 2, 3),
        "grouped_matmul": lambda: cuda(x, wg),
        "grouped_swiglu_db": lambda: cuda(x, wg, wu, wd),
        "combine_reduce": lambda: cuda(x, torch.ones((2, 8))),
        "decode_attention_paged": lambda: cuda(torch.zeros(
            (1, 4, 128), dtype=torch.bfloat16), *[torch.zeros(
                (4, 16, 2, 128), dtype=torch.bfloat16)] * 2,
            torch.zeros((1, 2), dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32)),
        "grouped_swiglu_bwd": lambda: cuda(x, wg, wu, wd, None, x),
        "gather_swiglu_scatter_bwd": lambda: cuda(
            x[0], torch.zeros(16, dtype=torch.int32), torch.zeros(16),
            wg, wu, wd, None, torch.zeros((7, 16))),
        "gather_quantize_bwd": lambda: cuda(
            x[0].float(), torch.arange(8), None, torch.zeros((8, 1)),
            wire_dtype="int8"),
        "dequantize_bwd": lambda: cuda(torch.zeros((4, 16), dtype=torch.int8),
                                       torch.ones((4, 1)),
                                       torch.zeros((4, 16))),
        "mla_decode": lambda: cuda(
            torch.zeros((2, 16, 576), dtype=torch.bfloat16),
            torch.zeros((2, 8, 576), dtype=torch.bfloat16),
            torch.zeros((), dtype=torch.int32), scale=0.1, v_dim=512),
        "gather_rows": lambda: cuda(x[0], torch.arange(8),
                                    torch.tensor([3, 4])),
        "combine_reduce_bwd": lambda: cuda(
            x[0], torch.ones((2, 3)), torch.zeros((2, 3), dtype=torch.int32),
            torch.zeros((2, 16), dtype=torch.bfloat16)),
        "combine_gathered": lambda: cuda(
            x[0], torch.ones((2, 3)), sel=torch.zeros((2, 3),
                                                      dtype=torch.int32),
            out_dtype=torch.float32),
        "dequantize_rows": lambda: cuda(
            torch.zeros((4, 16), dtype=torch.int8), torch.ones((4, 1)),
            torch.tensor([1, 2]), torch.bfloat16),
    }[name]
    with pytest.raises(ValueError):
        args()
    assert cuda.launches == before
