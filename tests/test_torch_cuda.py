"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda`` and skipped without a GPU; this file imports no JAX
so that it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import grouped_matmul as gm  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
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


def _scan_inputs(rng, Bt, S, Di, N=16):
    """Scan inputs in the model's ranges: softplus step sizes, A = -exp(A_log)
    with the reference's A_log init, unit-scale x, B, C, D."""
    f = np.float32
    return [torch.from_numpy(a.astype(f)) for a in (
        rng.standard_normal((Bt, S, Di)), rng.uniform(1e-3, 0.1, (Bt, S, Di)),
        -np.broadcast_to(np.arange(1, N + 1), (Di, N)) * rng.uniform(
            0.5, 1.5, (Di, 1)),
        rng.standard_normal((Bt, S, N)), rng.standard_normal((Bt, S, N)),
        rng.standard_normal((Di,)))]


def _max_rel(got, ref):
    return float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


# S ragged against the 8-step chunk, Di against the 128-channel block
SCAN_SHAPES = [(2, 37, 200), (1, 64, 256), (3, 5, 130)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_cuda_mamba_scan_fwd_matches_plain(cuda_device, shape):
    ins = [t.to(cuda_device) for t in _scan_inputs(np.random.default_rng(3),
                                                   *shape)]
    y, states = ms._scan_fwd(*ins, save_states=True)
    ref = ms.mamba_scan_plain(*ins)
    # fp32 on both sides; expf and FMA contraction differ from torch's exp
    # and separate roundings by ulps, which the decaying recurrence carries
    assert _max_rel(y, ref) < 1e-5
    assert states.shape == (shape[0], ms.n_chunks(shape[1]), shape[2], 16)
    assert (states[:, 0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_cuda_mamba_scan_bwd_matches_autograd(cuda_device, shape):
    rng = np.random.default_rng(4)
    ins = [t.to(cuda_device) for t in _scan_inputs(rng, *shape)]
    dy = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                          ).to(cuda_device)
    _, states = ms._scan_fwd(*ins, save_states=True)
    got = ms.mamba_scan_bwd_cuda(*ins, states, dy)
    ref = ms.mamba_scan_bwd_plain(*ins, None, dy)
    # dA, dB, dC and dD are sums (over time and batch, or channels) added
    # with fp32 atomics in any order
    for name, g, r in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, ref):
        assert g.shape == r.shape, name
        assert _max_rel(g, r) < 1e-4, (name, _max_rel(g, r))


@pytest.mark.cuda
def test_cuda_mamba_scan_autograd_function(cuda_device):
    """ops.mamba_scan on CUDA tensors that require grad goes through both
    kernels and gives the plain version's gradients."""
    rng = np.random.default_rng(5)
    ins = [t.to(cuda_device).requires_grad_(True)
           for t in _scan_inputs(rng, 2, 24, 136)]
    dy = torch.randn((2, 24, 136), device=cuda_device)
    f0, b0 = ms.mamba_scan_cuda.launches, ms.mamba_scan_bwd_cuda.launches
    y = ops.mamba_scan(*ins)
    grads = torch.autograd.grad(y, ins, dy)
    assert ms.mamba_scan_cuda.launches == f0 + 1
    assert ms.mamba_scan_bwd_cuda.launches == b0 + 1
    ref = ms.mamba_scan_bwd_plain(*[t.detach() for t in ins], None, dy)
    for g, r in zip(grads, ref):
        assert _max_rel(g, r) < 1e-4
    with pytest.raises(ValueError):          # d_state 8: the kernel takes 16
        ops.mamba_scan(ins[0].detach(), ins[1].detach(),
                       ins[2].detach()[:, :8], ins[3].detach()[..., :8],
                       ins[4].detach()[..., :8], ins[5].detach())


@pytest.mark.cuda
def test_cuda_kernel_without_backward_refuses_grad(cuda_device):
    """A CUDA kernel with no backward kernel raises rather than return an
    output without grad_fn; under torch.no_grad (serving) it launches."""
    rng = np.random.default_rng(6)
    T, E, C, D, F = 16, 2, 8, 64, 64
    x_ext = torch.from_numpy(rng.standard_normal((T + 1, D)).astype(np.float32))
    x_ext[T] = 0
    ws = [torch.from_numpy(a) for a in _w(rng, E, D, F)]
    x_ext, *ws = [t.to(cuda_device, torch.bfloat16) for t in [x_ext, *ws]]
    src = torch.arange(E * C, device=cuda_device, dtype=torch.int32) % T
    w = torch.ones(E * C, device=cuda_device)
    for t in ws:
        t.requires_grad_(True)
    before = gm.gather_swiglu_scatter_cuda.launches
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        ops.gather_swiglu_scatter(x_ext, src, w, *ws)
    assert gm.gather_swiglu_scatter_cuda.launches == before
    with torch.no_grad():
        out = ops.gather_swiglu_scatter(x_ext, src, w, *ws)
    assert out.shape == (T, D)
    assert gm.gather_swiglu_scatter_cuda.launches == before + 1


@pytest.mark.cuda
def test_cuda_train_ep_mesh_local_raises(cuda_device):
    """Expert-parallel MoE training on the card is refused up front."""
    from repro_torch.launch import train
    with pytest.raises(NotImplementedError, match="EP training"):
        train.main(["--arch", "qwen2_moe_a2_7b", "--reduced", "--mesh",
                    "local", "--local-model-axis", "2", "--steps", "1",
                    "--batch", "2", "--seq", "16"])


@pytest.mark.cuda
def test_cuda_train_cli_reduced_mamba(cuda_device, capsys):
    from repro_torch.launch import train
    f0, b0 = ms.mamba_scan_cuda.launches, ms.mamba_scan_bwd_cuda.launches
    assert train.main(["--arch", "falcon_mamba_7b", "--reduced", "--steps",
                       "3", "--batch", "2", "--seq", "64",
                       "--log-every", "1"]) == 0
    assert "[train] finished: loss" in capsys.readouterr().out
    # 2 layers x 3 steps; the forward runs again under recomputation
    assert ms.mamba_scan_cuda.launches - f0 == 12
    assert ms.mamba_scan_bwd_cuda.launches - b0 == 6
