"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda`` and skipped without a GPU; this file imports no JAX
so that it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import grouped_matmul as gm  # noqa: E402
from repro_torch.kernels import quantize_pack as qp  # noqa: E402


def _w(rng, E, D, F, s=0.2):
    return [(rng.standard_normal(sh) * s).astype(np.float32)
            for sh in ((E, D, F), (E, D, F), (E, F, D))]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("counts_kind", ["none", "flat", "bucketed"])
def test_cuda_grouped_swiglu_matches_plain(cuda_device, counts_kind):
    rng = np.random.default_rng(1)
    E, C, D, F = 6, 48, 136, 200        # ragged against the 64-wide tiles
    x = torch.from_numpy(rng.standard_normal((E, C, D)).astype(np.float32))
    ws = [torch.from_numpy(w) for w in _w(rng, E, D, F)]
    x, wg, wu, wd = [t.to(cuda_device, torch.bfloat16) for t in [x, *ws]]
    counts = {"none": None,
              "flat": torch.tensor([0, 1, 48, 17, 64, 33]),
              "bucketed": torch.from_numpy(rng.integers(0, 13, (E, 4)))
              }[counts_kind]
    if counts is not None:
        counts = counts.to(cuda_device, torch.int32)
    got = gm.grouped_swiglu_cuda(x, wg, wu, wd, counts).float()
    ref = gm.grouped_swiglu_plain(x, wg, wu, wd, counts).float()
    # one bf16 rounding of the output, plus h rounding on either side
    torch.testing.assert_close(got, ref, rtol=2e-2, atol=2e-2)
    if counts is not None:
        dead = ~gm.occupancy_mask(counts, E, C)
        assert (got[dead] == 0).all()


@pytest.mark.cuda
def test_cuda_gather_swiglu_scatter_matches_plain(cuda_device):
    rng = np.random.default_rng(2)
    T, E, C, D, F = 50, 5, 40, 136, 200
    x_ext = torch.from_numpy(rng.standard_normal((T + 1, D)).astype(np.float32))
    x_ext[T] = 0
    src = torch.from_numpy(rng.integers(0, T, E * C).astype(np.int32))
    src[:30] = 7                                    # duplicate tokens add
    w = torch.from_numpy(rng.random(E * C).astype(np.float32))
    counts = torch.tensor([0, 40, 13, 1, 27], dtype=torch.int32)
    ws = [torch.from_numpy(a) for a in _w(rng, E, D, F)]
    x_ext, *ws = [t.to(cuda_device, torch.bfloat16) for t in [x_ext, *ws]]
    src, w, counts = (t.to(cuda_device) for t in (src, w, counts))
    got = gm.gather_swiglu_scatter_cuda(x_ext, src, w, *ws, counts)
    ref = gm.gather_swiglu_scatter_plain(x_ext, src, w, *ws, counts)
    # h rounds to bf16 on both sides; fp32 atomics add in any order
    torch.testing.assert_close(got, ref, rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["fp8", "int8"])
@pytest.mark.parametrize("D", [200, 2048])
def test_cuda_quantize_kernels_bit_exact(cuda_device, wire, D):
    rng = np.random.default_rng(D)
    T, E, C = 64, 8, 16
    x_ext = torch.from_numpy((rng.standard_normal((T + 1, D))
                              * rng.uniform(0.01, 100, (T + 1, 1))
                              ).astype(np.float32)).to(cuda_device)
    x_ext[T] = 0
    src = torch.from_numpy(rng.integers(0, T + 1, E * C).astype(np.int32)
                           ).to(cuda_device)
    counts = torch.from_numpy(rng.integers(0, C + 1, E).astype(np.int32)
                              ).to(cuda_device)
    for cnt in (counts, None):
        q, s = qp.gather_quantize_cuda(x_ext, src, cnt, wire_dtype=wire)
        q_ref, s_ref = qp.gather_quantize_plain(x_ext, src, cnt,
                                                wire_dtype=wire)
        assert torch.equal(q.view(torch.uint8), q_ref.view(torch.uint8))
        assert torch.equal(s, s_ref)
        assert torch.equal(qp.dequantize_cuda(q, s),
                           qp.dequantize_plain(q_ref, s_ref))


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_inputs_they_do_not_take(cuda_device):
    """A CUDA tensor launches the kernel or raises: never a quiet fallback."""
    x = torch.zeros((2, 8, 16), device=cuda_device)            # fp32, not bf16
    w = [torch.zeros(s, device=cuda_device, dtype=torch.bfloat16)
         for s in ((2, 16, 24), (2, 16, 24), (2, 24, 16))]
    before = gm.grouped_swiglu_cuda.launches
    with pytest.raises(ValueError):
        gm.grouped_swiglu_cuda(x, *w)
    with pytest.raises(ValueError):          # counts for the wrong group count
        gm.grouped_swiglu_cuda(x.bfloat16(), *w,
                               torch.ones(3, dtype=torch.int32,
                                          device=cuda_device))
    with pytest.raises(ValueError):
        qp.gather_quantize_cuda(x[0].bfloat16(), torch.arange(8,
                                device=cuda_device), wire_dtype="fp8")
    assert gm.grouped_swiglu_cuda.launches == before
