"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda`` and skipped without a GPU; this file imports no JAX
so that it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import all_to_all_ll_exchange  # noqa: E402
from repro_torch.kernels import combine_reduce as cr  # noqa: E402
from repro_torch.kernels import grouped_matmul as gm  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.kernels import norm_attention as na  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quantize_pack as qp  # noqa: E402
from repro_torch.serving.kv_cache import KVBlockPool  # noqa: E402


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
    E, C, D, F = 6, 48, 136, 200        # ragged against the 128-wide tiles
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


def _wire_table(rng, T, D, device):
    """(T + 1, D) fp32 token table, rows at magnitudes from 1e-32 to 1e32:
    row 0 all zeros (zero scales), row 1 near 1e-30, row 2 near 1e30, row
    3 with an all-zero first block; row T the zero scratch row."""
    x = rng.standard_normal((T + 1, D)) * rng.uniform(0.01, 100, (T + 1, 1))
    x[0] = 0
    x[1] *= 1e-30
    x[2] *= 1e30
    x[3, :128] = 0
    x[T] = 0
    return torch.from_numpy(x.astype(np.float32)).to(device)


def _check_gather_quantize(x_ext, src, counts, wire):
    """gather_quantize_cuda against the plain version, bit for bit (bytes
    and scales), its outputs landing in memory just filled with NaN, so
    that a slot the kernel leaves unwritten shows; then dequantize on its
    output.  Returns the CUDA (q, scales)."""
    n, D = src.shape[0], x_ext.shape[1]
    poison = (torch.full((n, D), 0xFF, dtype=torch.uint8, device=src.device),
              torch.full((n, -(-D // 128)), float("nan"), device=src.device))
    del poison
    before = qp.gather_quantize_cuda.launches
    q, s = qp.gather_quantize_cuda(x_ext, src, counts, wire_dtype=wire)
    assert qp.gather_quantize_cuda.launches == before + 1
    q_ref, s_ref = qp.gather_quantize_plain(x_ext, src, counts,
                                            wire_dtype=wire)
    assert torch.equal(q.view(torch.uint8), q_ref.view(torch.uint8))
    assert torch.equal(s.view(torch.int32), s_ref.view(torch.int32))
    assert torch.equal(qp.dequantize_cuda(q, s),
                       qp.dequantize_plain(q_ref, s_ref))
    return q, s


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["fp8", "int8"])
@pytest.mark.parametrize("D", [36, 130, 200, 2048])
def test_cuda_quantize_kernels_bit_exact(cuda_device, wire, D):
    """D 36 and 200: a partial last block in 4-feature units; 130: D % 4
    != 0, single features.  Zero, tiny and huge rows, slots naming the
    scratch row, buckets empty, full and partial, and no counts."""
    rng = np.random.default_rng(D)
    T, E, C = 64, 8, 16
    x_ext = _wire_table(rng, T, D, cuda_device)
    src = rng.integers(0, T + 1, E * C).astype(np.int32)
    src[:8] = [0, 1, 2, 3, T, T, 0, 2]
    src[C:C + 4] = [T, 1, 2, 0]
    cnt = rng.integers(0, C + 1, E).astype(np.int32)
    cnt[:3] = [C, 0, 4]
    src, counts = (torch.from_numpy(a).to(cuda_device) for a in (src, cnt))
    for c in (counts, None):
        q, s = _check_gather_quantize(x_ext, src, c, wire)
    assert (s[0] == 0).all() and (s[1, 1:] > 0).all()    # no counts: row 0


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["fp8", "int8"])
@pytest.mark.parametrize("case", ["ht", "ll"])
def test_cuda_gather_quantize_served_shapes(cuda_device, wire, case):
    """The served dispatch, 4096 slots x 2048: HT from a seeded top-4
    routing of 1024 tokens over 4 ranks (each token once to each rank its
    choices reach, 256 slots a (rank, destination), no counts: unfilled
    slots name the scratch row); LL with 64 occupied slots in 256 buckets
    of 16 (16 tokens x top 4), one bucket at its capacity."""
    rng = np.random.default_rng(5)
    R, T, D, E, K = 4, 256, 2048, 60, 4
    if case == "ht":
        x_ext = _wire_table(rng, R * T, D, cuda_device)
        src = np.full((R, R, T), R * T, np.int32)
        for r in range(R):
            fill = np.zeros(R, int)
            for t in range(T):
                for g in np.unique(rng.choice(E, K, replace=False) // (E // R)):
                    src[r, g, fill[g]] = r * T + t
                    fill[g] += 1
        counts = None
    else:
        x_ext = _wire_table(rng, 16, D, cuda_device)
        n_buckets, C = 256, 16
        counts = np.zeros(n_buckets, np.int32)
        counts[7] = C
        for b in rng.choice(np.arange(8, n_buckets), 24, replace=False):
            counts[b] = 2
        src = np.full((n_buckets, C), 16, np.int32)
        occ = np.arange(C)[None, :] < counts[:, None]
        src[occ] = rng.integers(0, 16, int(occ.sum()))
        assert occ.sum() == 64
        counts = torch.from_numpy(counts).to(cuda_device)
    src = torch.from_numpy(src.reshape(-1)).to(cuda_device)
    assert src.shape == (4096,)
    _check_gather_quantize(x_ext, src, counts, wire)


def _wire_bytes(N, D, wire, device):
    """(N, D) wire values running through all 256 byte patterns (NaN
    encodings included) wherever N * D >= 256."""
    b = ((torch.arange(N * D, dtype=torch.int64) * 37 + 11) % 256).to(
        torch.uint8).reshape(N, D)
    return b.view(torch.float8_e4m3fn if wire == "fp8" else torch.int8).to(
        device)


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["fp8", "int8"])
@pytest.mark.parametrize("N,D", [(16, 2048), (32, 16), (3, 144), (5, 200),
                                 (9, 36), (7, 201), (1, 2048), (1, 16),
                                 (0, 2048)])
def test_cuda_dequantize_every_byte_bit_exact(cuda_device, wire, N, D):
    """Every byte value of both wire dtypes, at D that the kernel takes in
    4-byte units (16, 144, 2048, and 200 and 36, not multiples of 16) and
    in single bytes (201), and N 0 and 1, bit for bit against the plain
    version (compared as int32 views, so NaNs compare too); every element
    written (the output lands in memory just filled with NaN).  Scales
    differ from block to block, and one is subnormal."""
    rng = np.random.default_rng(N * 1000 + D)
    q = _wire_bytes(N, D, wire, cuda_device)
    nb = -(-D // 128)
    s = rng.uniform(1e-3, 1e3, (N, nb)).astype(np.float32)
    if N:
        s[0, -1] = 1e-39
    scales = torch.from_numpy(s).to(cuda_device)
    junk = torch.full((N, D), float("nan"), device=cuda_device)
    del junk
    before = qp.dequantize_cuda.launches
    got = qp.dequantize_cuda(q, scales)
    assert qp.dequantize_cuda.launches == before + (1 if N else 0)
    ref = qp.dequantize_plain(q, scales)
    assert got.shape == ref.shape == (N, D)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


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


def _scan_fwd_checked(ins, states_vs_float64=False):
    """The forward kernel, its y and states landing in memory just filled
    with NaN (the caching allocator hands the freed blocks of those sizes
    back), against the plain recurrence: y, and the state at every chunk
    boundary (t = 8 c), each within 1e-5 of its own largest value.  fp32
    on both sides; ex2.approx and FMA contraction differ from torch's exp
    and separate roundings by ulps, which the decaying recurrence carries.
    ``states_vs_float64``: the states are held instead to the recurrence
    in float64, within twice the fp32 plain version's own error there."""
    Bt, S, Di = ins[0].shape
    st_shape = (Bt, ms.n_chunks(S), Di, 16)
    junk = (torch.full_like(ins[0], float("nan")),
            torch.full(st_shape, float("nan"), device=ins[0].device))
    del junk
    before = ms.mamba_scan_cuda.launches
    y, states = ms._scan_fwd(*ins, save_states=True)
    assert ms.mamba_scan_cuda.launches == before + 1
    ref, ref_states = ms.mamba_scan_plain(*ins, with_states=True)
    assert states.shape == st_shape == ref_states.shape
    assert torch.isfinite(y).all() and torch.isfinite(states).all()
    assert (states[:, 0] == 0).all()
    assert _max_rel(y, ref) < 1e-5, _max_rel(y, ref)
    if states_vs_float64:
        _, exact = ms.mamba_scan_plain(*[t.double() for t in ins],
                                       with_states=True)
        err = _max_rel(states.double(), exact)
        assert err <= 2 * _max_rel(ref_states.double(), exact), err
    else:
        assert _max_rel(states, ref_states) < 1e-5, _max_rel(states,
                                                             ref_states)
    y_only, none = ms._scan_fwd(*ins, save_states=False)
    assert none is None and torch.equal(y_only, y)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_cuda_mamba_scan_fwd_matches_plain(cuda_device, shape):
    ins = [t.to(cuda_device) for t in _scan_inputs(np.random.default_rng(3),
                                                   *shape)]
    _scan_fwd_checked(ins)


# ragged against the forward's 64-channel block (67 odd, 70, 130) and the
# 8-step chunk (S 1, 7, 9, 13), odd Bt, and a long S at narrow Di, where a
# state carried wrongly from chunk to chunk would show
SCAN_FWD_EDGES = [(1, 1, 64), (3, 7, 67), (1, 9, 70), (3, 13, 130),
                  (5, 1, 130), (1, 1024, 72)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SCAN_FWD_EDGES)
def test_cuda_mamba_scan_fwd_edges(cuda_device, shape):
    ins = [t.to(cuda_device) for t in _scan_inputs(
        np.random.default_rng(sum(shape) + 1), *shape)]
    _scan_fwd_checked(ins)


@pytest.mark.cuda
def test_cuda_mamba_scan_fwd_slowest_decays(cuda_device):
    """dt at its init's floor (0.001) and a = -0.5 (A_log's smallest
    entry after a 0.5 draw): the state carries each step's error of the
    decay over ~1 / (dt |a|) = 2,000 steps, so a biased exponential would
    show here first.  y is held to the plain version within 1e-5; the
    states to the float64 recurrence, from which the fp32 plain version's
    own states drift by ~1.6e-5 of their largest here (ex2.approx and
    torch's exp round the decay apart, so the two fp32 recurrences drift
    apart by more than either drifts from the exact one)."""
    rng = np.random.default_rng(7)
    Bt, S, Di = 1, 4096, 64
    x, _, _, B, C, D = _scan_inputs(rng, Bt, S, Di)
    dt = torch.from_numpy(rng.uniform(1e-3, 1.2e-3, (Bt, S, Di)).astype(
        np.float32))
    A = torch.from_numpy((-0.5 * rng.uniform(1.0, 1.05, (Di, 16))).astype(
        np.float32))
    _scan_fwd_checked([t.to(cuda_device) for t in (x, dt, A, B, C, D)],
                      states_vs_float64=True)


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


# S ragged against the 8-step chunk (1, 7, 13), a single step, Di ragged
# against the backward's 32-channel block (70, 130) and odd (67: staged in
# 4-byte pieces, not 8-byte pairs), Bt 1, and a long S at narrow Di, where a
# state carried wrongly from chunk to chunk would show
SCAN_BWD_EDGES = [(1, 1, 64), (2, 7, 70), (1, 13, 130), (3, 9, 64),
                  (2, 13, 67), (2, 1024, 72)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SCAN_BWD_EDGES)
def test_cuda_mamba_scan_bwd_edges(cuda_device, shape):
    rng = np.random.default_rng(sum(shape))
    ins = [t.to(cuda_device) for t in _scan_inputs(rng, *shape)]
    dy = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                          ).to(cuda_device)
    _, states = ms._scan_fwd(*ins, save_states=True)
    got = ms.mamba_scan_bwd_cuda(*ins, states, dy)
    ref = ms.mamba_scan_bwd_plain(*ins, None, dy)
    for name, g, r in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, ref):
        assert g.shape == r.shape, name
        assert torch.isfinite(g).all(), name
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
    E, C, D, F = 2, 8, 64, 64
    x = _bf16(rng, (E, C, D), cuda_device)
    ws = [torch.from_numpy(a).to(cuda_device, torch.bfloat16)
          for a in _w(rng, E, D, F)]
    for t in ws:
        t.requires_grad_(True)
    before = gm.grouped_swiglu_db_cuda.launches
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_SWIGLU_DB", "1")
        with pytest.raises(NotImplementedError, match="no backward kernel"):
            ops.grouped_swiglu(x, *ws)
        assert gm.grouped_swiglu_db_cuda.launches == before
        with torch.no_grad():
            out = ops.grouped_swiglu(x, *ws)
    assert out.shape == (E, C, D)
    assert gm.grouped_swiglu_db_cuda.launches == before + 1


# ------------------------------------------------ EP backward kernels -----
# the kernels against their plain backward (the same rounding points, fp32
# sums in another order, dx's atomics in any order) and against autograd
# through the plain forward on the same values in fp32 (no bf16 rounding of
# h, dh, dg or du; autograd through the bf16 forward would also sum a
# duplicated token's slot gradients in bf16): each gradient within 1e-2 of
# its largest, chip_smoke.py's limit for them
BWD_TOL = 1e-2
BWD_DIMS = {"ragged": (136, 200), "served": (2048, 1408)}


def _bwd_close(got, ref, tol=BWD_TOL):
    """Each gradient of ``got`` against ``ref``'s: max |err| within tol of
    max |ref|; the failures name the gradients."""
    bad = []
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape, i
        assert torch.isfinite(g).all(), i
        err, scale = float((g.float() - r.float()).abs().max()), float(
            r.float().abs().max())
        if err > tol * scale:
            bad.append((i, err, scale))
    assert not bad, bad


def _bf16_weights(rng, E, D, F, device):
    return [torch.from_numpy(a).to(device, torch.bfloat16)
            for a in _w(rng, E, D, F, D ** -0.5)]


def _autograd_plain(fwd, args, grad_at, dy):
    """Gradients of the plain forward ``fwd(*args)`` to the arguments at
    positions ``grad_at`` (taken in fp32), for the upstream ``dy``."""
    args = [a.detach().float().requires_grad_(True) if i in grad_at else a
            for i, a in enumerate(args)]
    return torch.autograd.grad(fwd(*args), [args[i] for i in grad_at],
                               dy.float())


# LL's sub-bucket counts (E, 4) over 192-row sub-buckets whose occupied
# prefixes span several 64-row steps of the weight gradients' reduction
# over rows and end inside one (and one empty, one full)
STEPS_COUNTS = np.array([[0, 0, 0, 0], [150, 64, 1, 191], [192, 100, 0, 130],
                         [65, 129, 63, 2], [192, 192, 192, 192]])


@pytest.mark.cuda
@pytest.mark.parametrize("counts_kind,dims", [
    ("none", "ragged"), ("flat", "ragged"), ("bucketed", "ragged"),
    ("bucketed", "served"), ("steps", "served")])
def test_cuda_grouped_swiglu_bwd_matches_plain(cuda_device, counts_kind,
                                               dims):
    """LL's expert backward: flat counts (one expert empty, one full) and
    LL's (E, B) sub-bucket counts; rows past the counts get exact zeros,
    an empty expert's weights zero gradients.  "steps": prefixes of
    several 64-row steps ending inside one, and NaN in x and dy past the
    counts, which must add nothing."""
    rng = np.random.default_rng(21)
    (D, F), E = BWD_DIMS[dims], 5
    C = 4 * 192 if counts_kind == "steps" else 48
    x = _bf16(rng, (E, C, D), cuda_device)
    ws = _bf16_weights(rng, E, D, F, cuda_device)
    counts = {"none": None, "flat": np.array([0, 1, 48, 17, 33]),
              "bucketed": rng.integers(0, 13, (E, 4)),
              "steps": STEPS_COUNTS.copy()}[counts_kind]
    if counts is not None:
        counts[0] = 0
        counts = torch.from_numpy(counts).to(cuda_device, torch.int32)
    dy = _bf16(rng, (E, C, D), cuda_device)
    dy_live = dy
    if counts_kind == "steps":
        dead = ~gm.occupancy_mask(counts, E, C)
        x[dead] = float("nan")
        dy_live = dy.clone()
        dy[dead] = float("nan")
        dy_live[dead] = 0
    before = gm.grouped_swiglu_bwd_cuda.launches
    _poisoned_allocation((E, C, D), torch.bfloat16, cuda_device)
    got = gm.grouped_swiglu_bwd_cuda(x, *ws, counts, dy)
    assert gm.grouped_swiglu_bwd_cuda.launches == before + 1
    _bwd_close(got, gm.grouped_swiglu_bwd_plain(x, *ws, counts, dy))
    # the output rows past the counts are constant zeros, so their upstream
    # is no part of the gradient; autograd would still multiply it by their
    # zero rows (NaN x 0), so it takes those upstream rows as zeros
    _bwd_close(got, _autograd_plain(gm.grouped_swiglu_plain,
                                    (x, *ws, counts), (0, 1, 2, 3), dy_live))
    if counts is not None:
        assert (got[0][~gm.occupancy_mask(counts, E, C)] == 0).all()
        assert all((g[0] == 0).all() for g in got[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("dims,counts", [
    ("ragged", None), ("served", None), ("ragged", (0, 40, 13, 1, 128)),
    ("served", (0, 40, 13, 1, 128)), ("served", (0, 200, 384, 65, 130))])
def test_cuda_gather_swiglu_scatter_bwd_matches_plain(cuda_device, dims,
                                                      counts):
    """HT's expert backward: a token in 40 slots (its gradient sums them),
    slots on the scratch row (its upstream is 0), an empty expert and a
    full one.  At C 384 (counts spanning several 64-row steps of the
    weight gradients' reduction over rows, ending inside one): the
    scratch row holds NaN and every slot past a count names it, as the HT
    plan fills empty slots; it must add nothing."""
    rng = np.random.default_rng(22)
    steps = counts is not None and max(counts) > 128
    (D, F), T, E = BWD_DIMS[dims], 300, 5
    C = 384 if steps else 128
    x_ext = _bf16(rng, (T + 1, D), cuda_device)
    x_ext[T] = float("nan") if steps else 0
    src = rng.integers(0, T + 1, E * C).astype(np.int32)
    src[:40] = 7
    if steps:
        live = np.arange(C)[None, :] < np.array(counts)[:, None]
        src = np.where(live.reshape(-1), src % T, T).astype(np.int32)
    else:
        src[C:C + 5] = T
    src = torch.from_numpy(src).to(cuda_device)
    w = torch.from_numpy(rng.random(E * C).astype(np.float32)).to(cuda_device)
    ws = _bf16_weights(rng, E, D, F, cuda_device)
    cnt = (None if counts is None
           else torch.tensor(counts, dtype=torch.int32, device=cuda_device))
    dout = torch.from_numpy(rng.standard_normal((T, D)).astype(
        np.float32)).to(cuda_device)
    before = gm.gather_swiglu_scatter_bwd_cuda.launches
    got = gm.gather_swiglu_scatter_bwd_cuda(x_ext, src, w, *ws, cnt, dout)
    assert gm.gather_swiglu_scatter_bwd_cuda.launches == before + 1
    _bwd_close(got, gm.gather_swiglu_scatter_bwd_plain(x_ext, src, w, *ws,
                                                       cnt, dout))
    _bwd_close(got, _autograd_plain(
        lambda x, s, ww, *rest: gm.gather_swiglu_scatter_plain(x, s, ww,
                                                               *rest),
        (x_ext, src, w, *ws, cnt), (0, 2, 3, 4, 5), dout))
    if cnt is not None:
        assert (got[1].reshape(E, C)[~gm.occupancy_mask(cnt, E, C)] == 0).all()
        assert all((g[0] == 0).all() for g in got[2:])


def _wire_case(rng, D, device, with_counts):
    """The wire table of _wire_table with a tied absmax (row 5's first
    block holds +m and -m, row 6's m three times), 4 buckets of 32 slots
    naming rows at random, duplicates and the scratch row among them."""
    T, E, C = 64, 4, 32
    x = _wire_table(rng, T, D, device)
    x[5, :128].clamp_(-1.0, 1.0)
    x[5, 3], x[5, 70] = 2.0, -2.0
    x[6, :128].clamp_(-1.0, 1.0)
    x[6, [0, 9, 127]] = 3.0
    src = rng.integers(0, T + 1, E * C).astype(np.int32)
    src[:12] = [0, 1, 2, 3, 5, 6, 5, 6, T, 5, 3, 6]
    counts = (torch.tensor([0, 32, 7, 19], dtype=torch.int32, device=device)
              if with_counts else None)
    return x, torch.from_numpy(src).to(device), counts


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["fp8", "int8"])
@pytest.mark.parametrize("D", [130, 200, 2048])
@pytest.mark.parametrize("with_counts", [False, True])
def test_cuda_wire_bwd_matches_plain(cuda_device, wire, D, with_counts):
    """The wire's gradient through the scales alone: dequantize_bwd's
    d_scales (fp32 sums of 128 products in another order: 1e-5 of their
    largest) and gather_quantize_bwd's table gradient, nonzero exactly at
    each occupied block's absmax element(s) (ties shared), the same
    elements as the plain version's; and the chain against autograd
    through the plain forward as core/ep.py chains it (the bytes through
    a uint8 view)."""
    rng = np.random.default_rng(23 + D)
    x, src, counts = _wire_case(rng, D, cuda_device, with_counts)
    q, s = qp.gather_quantize_cuda(x, src, counts, wire_dtype=wire)
    dy = torch.from_numpy(rng.standard_normal((src.shape[0], D)).astype(
        np.float32)).to(cuda_device)
    b0, g0 = qp.dequantize_bwd_cuda.launches, qp.gather_quantize_bwd_cuda.launches
    ds = qp.dequantize_bwd_cuda(q, s, dy)
    ds_ref = qp.dequantize_bwd_plain(q, s, dy)
    _range_close(ds, ds_ref, 1e-5)
    dx = qp.gather_quantize_bwd_cuda(x, src, counts, ds_ref, wire_dtype=wire)
    dx_ref = qp.gather_quantize_bwd_plain(x, src, counts, ds_ref,
                                          wire_dtype=wire)
    assert (qp.dequantize_bwd_cuda.launches, qp.gather_quantize_bwd_cuda.launches
            ) == (b0 + 1, g0 + 1)
    assert torch.equal(dx != 0, dx_ref != 0)
    _range_close(dx, dx_ref, 1e-6)
    xin = x.detach().requires_grad_(True)
    qp_, sp_ = qp.gather_quantize_plain(xin, src, counts, wire_dtype=wire)
    out = qp.dequantize_plain(qp_.view(torch.uint8).view(qp_.dtype), sp_)
    auto, = torch.autograd.grad(out, xin, dy)
    chain = qp.gather_quantize_bwd_cuda(x, src, counts, ds, wire_dtype=wire)
    assert torch.equal(chain != 0, auto != 0)
    _range_close(chain, auto, 1e-5)
    # one nonzero a tie at most, a tied block splits its gradient equally
    if not with_counts:
        assert int((chain[5, :128] != 0).sum()) in (0, 2)
        assert int((chain[6, :128] != 0).sum()) in (0, 3)
        assert (chain[0] == 0).all() and (chain[3, :128] == 0).all()


def _gather_bwd_case(rng, kind, D, device):
    """A wire gather's (table, src, counts) as the dispatches fill it:
    "ll_k6", LL's buckets of 8 experts x 16 slots (counts), 12 tokens of 6
    distinct choices each, row 2 named by all 6 of its slots; "ht_dedup",
    HT's dedup'd entries, 4 groups x 24 slots (no counts), each of 24
    tokens once in every group its 6 choices reach, the unfilled slots on
    the scratch row; "unnamed", slots naming only rows 0..9 of 64 (the
    rest, and the rows past the LL counts, named by no occupied slot)."""
    if kind == "ll_k6":
        T, E, C, K = 12, 8, 16, 6
        src = np.full((E, C), T, np.int32)
        counts = np.zeros(E, np.int32)
        for t in range(T):
            for e in rng.choice(E, K, replace=False):
                src[e, counts[e]] = t
                counts[e] += 1
        src, cnt = src.reshape(-1), torch.tensor(counts, dtype=torch.int32)
        assert (src == 2).sum() == K
    elif kind == "ht_dedup":
        T, G, C, K = 24, 4, 24, 6
        src = np.full((G, C), T, np.int32)
        fill = np.zeros(G, int)
        for t in range(T):
            for g in np.unique(rng.choice(16, K, replace=False) // 4):
                src[g, fill[g]] = t
                fill[g] += 1
        src, cnt = src.reshape(-1), None
    else:
        T = 64
        src = rng.integers(0, 10, 4 * 32).astype(np.int32)
        cnt = torch.tensor([0, 32, 7, 19], dtype=torch.int32)
    x = _wire_table(rng, T, D, device)
    return (x, torch.from_numpy(src).to(device),
            None if cnt is None else cnt.to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["fp8", "int8"])
@pytest.mark.parametrize("D", [200, 2048])
@pytest.mark.parametrize("kind", ["ll_k6", "ht_dedup", "unnamed"])
def test_cuda_gather_quantize_bwd_named_rows(cuda_device, wire, D, kind):
    """The table's gradient where one row is named by several slots (LL's
    K = 6 choices, HT's dedup'd entries: their scale gradients folded onto
    the row before it is read) and where rows are named by no occupied
    slot: exact zeros, written by the kernel into an output that starts as
    NaN (there is no memset).  The same nonzero elements as the plain
    version's, values within 1e-6 of the range."""
    rng = np.random.default_rng(61 + D)
    x, src, counts = _gather_bwd_case(rng, kind, D, cuda_device)
    nb = -(-D // 128)
    ds = torch.from_numpy(rng.standard_normal((src.shape[0], nb)).astype(
        np.float32)).to(cuda_device)
    g0 = qp.gather_quantize_bwd_cuda.launches
    _poisoned_allocation(tuple(x.shape), torch.float32, cuda_device)
    dx = qp.gather_quantize_bwd_cuda(x, src, counts, ds, wire_dtype=wire)
    ref = qp.gather_quantize_bwd_plain(x, src, counts, ds, wire_dtype=wire)
    assert qp.gather_quantize_bwd_cuda.launches == g0 + 1
    assert torch.equal(dx != 0, ref != 0)
    _range_close(dx, ref, 1e-6)
    named = torch.zeros(x.shape[0], dtype=torch.bool, device=cuda_device)
    named[src[qp._occupied_slots(src, counts)].long()] = True
    assert (dx[~named] == 0).all()
    if kind == "ll_k6":     # the 6 slots' values add up at row 2's ties
        assert (dx[2] != 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ll", "ht"])
def test_cuda_placement_dispatch_matches_plain(cuda_device, mode):
    """Dispatch under a greedy placement of 64 experts over 80 physical
    slots (20 a rank of an EP world of 4; top 6 of a skewed routing)
    through the kernels (LL: grouped_swiglu, HT: gather_swiglu_scatter)
    against the same dispatch through their plain versions on the card,
    and both against the logical dense oracle.  The capacity is lifted so
    that nothing drops (a physical slot takes at most T choices from a
    source)."""
    from repro_torch.core import ep
    from repro_torch.core import plan as planlib
    from repro_torch.core.moe import expert_fn
    rng = np.random.default_rng(80)
    E, R, T, K, D, F, n_phys = 64, 4, 64, 6, 256, 128, 80
    pop = np.exp(0.8 * rng.standard_normal(E))
    g = np.log(pop / pop.sum())[None, :] + rng.gumbel(size=(R * T, E))
    ti = np.argsort(-g, axis=1)[:, :K].astype(np.int32)
    tw = rng.random((R * T, K)).astype(np.float32)
    tw /= tw.sum(-1, keepdims=True)
    pl = planlib.greedy_placement(np.bincount(ti.reshape(-1), minlength=E),
                                  n_phys, R)
    assert pl.n_replicas.max() > 1
    x = _bf16(rng, (R, T, D), cuda_device)
    ws = _bf16_weights(rng, E, D, F, cuda_device)
    p2l = torch.from_numpy(pl.phys_to_logical).long().to(cuda_device)
    fn = expert_fn(*[w[p2l] for w in ws])
    spec = ep.EPSpec(axes=("model",), sizes=(R,), n_experts=E, top_k=K,
                     capacity_factor=n_phys / K, dtype=torch.bfloat16,
                     mode=mode, placement=pl.key())
    args = (spec, x, torch.from_numpy(ti).to(cuda_device).reshape(R, T, K),
            torch.from_numpy(tw).to(cuda_device).reshape(R, T, K), fn)
    run = ep.dispatch_combine_ll if mode == "ll" else ep.dispatch_combine_ht
    name = "grouped_swiglu" if mode == "ll" else "gather_swiglu_scatter"
    before = ops.KERNELS[name][0].launches
    got = run(*args)
    assert ops.KERNELS[name][0].launches == before + 1
    originals = {n: ops.KERNELS[n] for n in ("grouped_swiglu",
                                             "gather_swiglu_scatter")}
    try:
        ops.KERNELS.update({n: (p, p) for n, (_, p) in originals.items()})
        ref = run(*args)
    finally:
        ops.KERNELS.update(originals)
    assert tuple(got.aux["load_phys"].shape) == (n_phys,)
    assert torch.equal(got.aux["load_phys"], ref.aux["load_phys"])
    assert (got.aux["dropped"] == 0).all()
    _range_close(got.out.float(), ref.out.float(), 1e-2)
    dense = ep.moe_ref(x.reshape(-1, D), args[2].reshape(-1, K),
                       args[3].reshape(-1, K), *ws)
    _range_close(got.out.float().reshape(-1, D), dense.float(), 2e-2)


@pytest.mark.cuda
def test_cuda_ep_kernels_train_through_their_functions(cuda_device):
    """Under grad with an input that requires one, ops takes each kernel's
    autograd Function: the forward and the backward kernel launch once a
    call, and the gradients are autograd's through the plain forward."""
    rng = np.random.default_rng(24)
    T, E, C, D, F = 40, 4, 32, 136, 200
    x_ext = _bf16(rng, (T + 1, D), cuda_device)
    x_ext[T] = 0
    src = torch.from_numpy(rng.integers(0, T, E * C).astype(np.int32)).to(
        cuda_device)
    w = torch.rand(E * C, device=cuda_device)
    ws = _bf16_weights(rng, E, D, F, cuda_device)
    cnt = torch.tensor([3, 32, 0, 17], dtype=torch.int32, device=cuda_device)
    leaves = [t.clone().requires_grad_(True) for t in (x_ext, w, *ws)]
    counters = (gm.gather_swiglu_scatter_cuda,
                gm.gather_swiglu_scatter_bwd_cuda)
    before = [c.launches for c in counters]
    out = ops.gather_swiglu_scatter(leaves[0], src, leaves[1], *leaves[2:],
                                    cnt)
    dout = torch.randn_like(out)
    grads = torch.autograd.grad(out, leaves, dout)
    assert [c.launches for c in counters] == [b + 1 for b in before]
    _bwd_close(grads, gm.gather_swiglu_scatter_bwd_plain(
        x_ext, src, w, *ws, cnt, dout))
    xb = _bf16(rng, (E, C, D), cuda_device).requires_grad_(True)
    y = ops.grouped_swiglu(xb, *leaves[2:], cnt)
    dy = torch.randn_like(y)
    b0 = gm.grouped_swiglu_bwd_cuda.launches
    grads = torch.autograd.grad(y, [xb, *leaves[2:]], dy)
    assert gm.grouped_swiglu_bwd_cuda.launches == b0 + 1
    _bwd_close(grads, gm.grouped_swiglu_bwd_plain(xb.detach(), *ws, cnt, dy))
    xf, src_w, counts = _wire_case(rng, 256, cuda_device, True)
    xf.requires_grad_(True)
    q, s = ops.gather_quantize(xf, src_w, counts, wire_dtype="fp8")
    assert not q.requires_grad and s.requires_grad
    deq = ops.dequantize_tokens(q, s)
    dy = torch.randn_like(deq)
    auto_in = xf.detach().requires_grad_(True)
    qp_, sp_ = qp.gather_quantize_plain(auto_in, src_w, counts,
                                        wire_dtype="fp8")
    ref, = torch.autograd.grad(qp.dequantize_plain(qp_.view(torch.uint8).view(
        qp_.dtype), sp_), auto_in, dy)
    got, = torch.autograd.grad(deq, xf, dy)
    _range_close(got, ref, 1e-5)


@pytest.mark.cuda
def test_cuda_ep_kernels_serve_without_their_functions(cuda_device):
    """Under inference mode (serving, and a captured decode step) the EP
    kernels take their ctypes wrappers as before: no Function, no graph,
    no backward launch, the same bits as a call under no_grad."""
    rng = np.random.default_rng(25)
    T, E, C, D, F = 16, 2, 8, 64, 64
    x_ext = _bf16(rng, (T + 1, D), cuda_device)
    x_ext[T] = 0
    ws = [t.requires_grad_(True) for t in _bf16_weights(rng, E, D, F,
                                                        cuda_device)]
    src = torch.arange(E * C, device=cuda_device, dtype=torch.int32) % T
    w = torch.ones(E * C, device=cuda_device)
    counters = (gm.gather_swiglu_scatter_cuda,
                gm.gather_swiglu_scatter_bwd_cuda)
    before = [c.launches for c in counters]
    with torch.inference_mode():
        out = ops.gather_swiglu_scatter(x_ext, src, w, *ws)
    assert out.grad_fn is None and not out.requires_grad
    assert [c.launches for c in counters] == [before[0] + 1, before[1]]
    with torch.no_grad():
        again = ops.gather_swiglu_scatter(x_ext, src, w, *ws)
    torch.testing.assert_close(out, again, rtol=1e-6, atol=1e-6)


# a reduced qwen2-moe's gradients on the card against the CPU's, as a
# share of each leaf's norm: bf16 on both sides, every product summed in
# another order, so h, the expert outputs and the activations round apart;
# on the fp8 wire a token value that lands on the other side of a code
# boundary also moves by 2^-4 of itself
EP_TRAIN_TOL = 0.05


def _ep_train_setup(device, mode, wire):
    from repro_torch.configs import get_config, reduced_config
    T = importlib.import_module("repro_torch.training.train_loop")
    cfg = reduced_config(get_config("qwen2_moe_a2_7b"), n_layers=2,
                         d_model=128, vocab=512)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, wire_dtype=wire))
    return cfg, T.init_state(cfg, seed=0, device="cpu"), T.HParams(
        peak_lr=1e-3, warmup=1, total_steps=3, moe_mode=mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,wire", [("ht", "fp32"), ("ll", "fp32"),
                                       ("ht", "fp8")])
def test_cuda_train_ep_mesh_local(cuda_device, mode, wire):
    """``train_step`` over ``--mesh local`` (a rank-stacked EP world of 2)
    on a reduced qwen2-moe through the EP kernels and their backward
    kernels, against the same step on the CPU through the plain versions,
    from the same parameters, the CPU run taking the card's routing
    choices: the loss and the grad norm within bf16 rounding, and every
    gradient leaf within ``EP_TRAIN_TOL`` of its norm; the backward
    kernels launched."""
    from repro_torch.core import moe as tmoe
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.distributed.sharding import make_dist_ctx
    from repro_torch.models import model_zoo as Z
    from repro_torch.optim import adamw
    T = importlib.import_module("repro_torch.training.train_loop")
    cfg, cpu_state, hp = _ep_train_setup(cuda_device, mode, wire)
    dist = make_dist_ctx(cfg, model=2)
    batch = synth_batch(DataConfig(vocab_size=cfg.vocab_size, batch=2,
                                   seq_len=32, seed=1), 0)
    gpu_params = adamw.tree_map(
        lambda t: t.detach().to(cuda_device).requires_grad_(True),
        cpu_state.params)
    grads = []
    names = (("gather_swiglu_scatter_bwd",) if mode == "ht"
             else ("grouped_swiglu_bwd",))
    if wire != "fp32":
        names += ("gather_quantize_bwd", "dequantize_bwd")
    before = {n: ops.KERNELS[n][0].launches for n in names}
    route, taken = tmoe.route, []

    def record(mcfg, rp, t, n):
        out = route(mcfg, rp, t, n)
        taken.append(out.top_idx.cpu())
        return out

    def replay(mcfg, rp, t, n):
        """The card's choices (bf16 near-ties round apart on the two
        devices; each call of the forward and of its recompute in turn),
        weights and aux loss from this run's own probabilities"""
        out = route(mcfg, rp, t, n)
        top = taken.pop(0).to(t.device).long()
        top_p = torch.gather(out.probs, -1, top)
        onehot = torch.nn.functional.one_hot(top, out.probs.shape[-1]).to(
            torch.float32).sum(-2)
        aux = n * (onehot.mean(-2) * out.probs.mean(-2)).sum(-1) * (
            mcfg.aux_loss_weight)
        return out._replace(top_idx=top.to(torch.int32), aux_loss=aux,
                            top_w=(top_p / torch.clamp(top_p.sum(
                                -1, keepdim=True), min=1e-9)).to(
                                out.top_w.dtype))
    for params, router in ((gpu_params, record), (cpu_state.params, replay)):
        dev = params["embed"].device
        try:
            tmoe.route = router
            loss, _ = Z.loss_fn(cfg, params, torch.as_tensor(
                batch["tokens"], device=dev).long(), torch.as_tensor(
                batch["labels"], device=dev).long(), dist=dist, moe_mode=mode)
            loss.backward()
        finally:
            tmoe.route = route
        grads.append((float(loss.detach()), adamw.tree_map(
            lambda p: (p.grad if p.grad is not None
                       else torch.zeros_like(p)).detach().float().cpu(),
            params)))
        adamw.tree_map(lambda p: setattr(p, "grad", None), params)
    assert not taken
    assert all(ops.KERNELS[n][0].launches > before[n] for n in names)
    (l_gpu, g_gpu), (l_cpu, g_cpu) = grads
    assert abs(l_gpu - l_cpu) <= 2e-2 * abs(l_cpu)
    rel = []
    adamw.tree_map(lambda g, r: rel.append(
        (float((g - r).norm()) / max(float(r.norm()), 1e-6), tuple(r.shape),
         bool(torch.isfinite(g).all()))), g_gpu, g_cpu)
    assert all(f for _, _, f in rel)
    assert max(e for e, _, _ in rel) <= EP_TRAIN_TOL, sorted(
        rel, reverse=True)[:4]
    gpu_state = T.TrainState(gpu_params, adamw.init_state(gpu_params))
    _, m_gpu = T.train_step(cfg, hp, dist, gpu_state, batch)
    _, m_cpu = T.train_step(cfg, hp, dist, cpu_state, batch)
    assert abs(float(m_gpu["grad_norm"]) - float(m_cpu["grad_norm"])) <= (
        0.05 * float(m_cpu["grad_norm"]))


@pytest.mark.cuda
def test_cuda_train_cli_mesh_local_qwen2moe(cuda_device, capsys):
    """``launch.train --mesh local`` trains a reduced qwen2-moe expert
    parallel on the card: HT through the fused kernel and its backward."""
    from repro_torch.launch import train
    f0 = gm.gather_swiglu_scatter_cuda.launches
    b0 = gm.gather_swiglu_scatter_bwd_cuda.launches
    assert train.main(["--arch", "qwen2_moe_a2_7b", "--reduced", "--mesh",
                       "local", "--local-model-axis", "2", "--steps", "2",
                       "--batch", "2", "--seq", "16", "--log-every", "1"]) == 0
    assert "[train] finished: loss" in capsys.readouterr().out
    # 2 layers x 2 steps; the forward runs again under recomputation
    assert gm.gather_swiglu_scatter_cuda.launches - f0 == 8
    assert gm.gather_swiglu_scatter_bwd_cuda.launches - b0 == 4


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


# ---------------------------------------- RMSNorm, flash attention, decode --
def _bf16(rng, shape, device, s=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * s).astype(
        np.float32)).to(device, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,D", [(37, 128), (5, 2560), (9, 1024),
                                    (3, 1028), (300, 200), (4, 4096)])
def test_cuda_rmsnorm_matches_plain(cuda_device, rows, D):
    """One warp a row up to D = 1024, one block a row above (4 x 4096:
    falcon-mamba-7b's decode norms, 512 threads a row); bf16 x with rows of
    very different scales, fp32 scale."""
    rng = np.random.default_rng(D)
    x = _bf16(rng, (rows, D), cuda_device) * torch.from_numpy(
        rng.uniform(0.01, 50, (rows, 1)).astype(np.float32)).to(
            cuda_device, torch.bfloat16)
    scale = torch.from_numpy(rng.standard_normal(D).astype(np.float32)).to(
        cuda_device)
    got = na.rmsnorm_cuda(x, scale, 1e-5).float()
    ref = na.rmsnorm_plain(x, scale, 1e-5).float()
    # the same fp32 value up to summation order, rounded once: at most one
    # bf16 ulp (2^-7 of the value) apart, and almost never apart at all
    # (a kernel that rounded the fp32 scale to bf16 would move about a
    # quarter of the elements by an ulp)
    assert ((got - ref).abs() <= 2.0 ** -7 * ref.abs()).all()
    assert (got != ref).float().mean() < 0.01
    x3 = x.reshape(1, rows, D)
    assert torch.equal(na.rmsnorm_cuda(x3, scale).reshape(rows, D),
                       na.rmsnorm_cuda(x, scale))


def _rmsnorm_case(rng, rows, D, device):
    """Rows of very different scales, one of them all zeros (its output is
    0), and an N(0, 1) fp32 scale."""
    x = _bf16(rng, (rows, D), device) * torch.from_numpy(
        rng.uniform(0.01, 50, (rows, 1)).astype(np.float32)).to(
            device, torch.bfloat16)
    x[rows // 2] = 0
    scale = torch.from_numpy(rng.standard_normal(D).astype(np.float32)).to(
        device)
    return x, scale


def _rmsnorm_poisoned(x, scale):
    """rmsnorm_cuda whose output lands in memory just filled with NaN (the
    caching allocator hands the freed block of that size back), so an
    element the kernel leaves unwritten fails the comparison."""
    junk = torch.full_like(x, float("nan"))
    del junk
    return na.rmsnorm_cuda(x, scale, 1e-5)


def _assert_rmsnorm_close(got, ref):
    # one bf16 ulp (2^-7 of the value) at most, per element and so per row
    got, ref = got.float(), ref.float()
    assert ((got - ref).abs() <= 2.0 ** -7 * ref.abs()).all()
    assert (got != ref).float().mean() < 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 4, 37, 8192])
@pytest.mark.parametrize("D", [4, 200, 1028, 2560, 4096])
def test_cuda_rmsnorm_edge_shapes(cuda_device, rows, D):
    """The launch the wrapper picks at each shape (rows kernel or one row a
    block; 16- or 8-byte vectors) against the plain version; every element
    written (``_rmsnorm_poisoned``)."""
    rng = np.random.default_rng(rows * 7 + D)
    x, scale = _rmsnorm_case(rng, rows, D, cuda_device)
    ref = na.rmsnorm_plain(x, scale, 1e-5)
    before = na.rmsnorm_cuda.launches
    got = _rmsnorm_poisoned(x, scale)
    assert na.rmsnorm_cuda.launches == before + 1
    _assert_rmsnorm_close(got, ref)
    assert (got[rows // 2] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("D,threads", [
    (200, 4), (200, 8), (200, 32), (12, 4),        # rows kernel, 16/8-byte
    (1028, 32),                     # a row a block: 4 vectors kept, 5 read twice
    (1028, 64), (1028, 512), (2560, 160), (2560, 320), (4096, 256),
    (40000, 512),                   # past a block's registers: read twice
])
def test_cuda_rmsnorm_every_launch_shape(cuda_device, monkeypatch, D,
                                         threads):
    """Each kernel and register depth at a forced launch shape: the rows
    kernel (4 to 32 lanes a row) and one row a block (32 to 512 threads),
    at a row count that leaves a block part empty."""
    rng = np.random.default_rng(D + threads)
    x, scale = _rmsnorm_case(rng, 37, D, cuda_device)
    ref = na.rmsnorm_plain(x, scale, 1e-5)
    monkeypatch.setattr(na, "rmsnorm_threads_per_row",
                        lambda rows, width, sms: threads)
    _assert_rmsnorm_close(_rmsnorm_poisoned(x, scale), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("D,threads", [
    (128, 2), (128, 12), (128, 64),     # rows kernel: 4..32 lanes, a power of two
    (2560, 48), (2560, na.RMSNORM_ROW_MAX_THREADS + 32),   # a row a block
])
def test_cuda_rmsnorm_refuses_a_launch_its_kernel_cannot_take(
        cuda_device, monkeypatch, D, threads):
    """The wrapper picks within the kernels' own limits: a launch shape
    one step past them is refused by the C entry, launches nothing, and
    leaves the next launch unharmed."""
    rng = np.random.default_rng(D + threads)
    x, scale = _rmsnorm_case(rng, 37, D, cuda_device)
    before = na.rmsnorm_cuda.launches
    with monkeypatch.context() as m:
        m.setattr(na, "rmsnorm_threads_per_row",
                  lambda rows, width, sms: threads)
        with pytest.raises(RuntimeError, match="rmsnorm: CUDA error"):
            na.rmsnorm_cuda(x, scale, 1e-5)
    assert na.rmsnorm_cuda.launches == before
    _assert_rmsnorm_close(na.rmsnorm_cuda(x, scale, 1e-5),
                          na.rmsnorm_plain(x, scale, 1e-5))


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,causal", [
    (2, 200, 200, 8, 2, True),      # ragged against the 64-row tiles
    (2, 200, 200, 8, 2, False),
    (1, 64, 64, 4, 4, True),        # one tile, MHA
    (1, 130, 130, 8, 1, True),      # GQA rep 8
    (1, 70, 150, 4, 2, False),      # Sq != Skv
    (1, 150, 70, 4, 2, True),       # rows past Skv see every key
    (1, 2048, 2048, 32, 8, True),   # the qwen3-4b prefill's shape at batch 1
    # edges of the 128-query and 128-key tiles
    (1, 127, 127, 4, 2, True),
    (1, 128, 128, 4, 2, True),
    (1, 129, 129, 4, 2, True),
    (1, 257, 257, 4, 2, True),
    (1, 127, 257, 4, 1, False),
    (1, 257, 129, 8, 4, False),
    (1, 129, 257, 4, 2, True),      # Skv > Sq: keys past the last row unseen
    (2, 257, 129, 8, 4, True),      # Skv < Sq
    (1, 2048, 2048, 16, 2, True),   # GQA rep 8 at the qwen3 prefill length
    (4, 256, 256, 16, 16, True),    # the qwen2-moe (serve-fp32) prefill
])
def test_cuda_flash_attention_matches_plain(cuda_device, B, Sq, Skv, H, Hkv,
                                            causal):
    rng = np.random.default_rng(Sq * H + Skv)
    q = _bf16(rng, (B, Sq, H, 128), cuda_device)
    k = _bf16(rng, (B, Skv, Hkv, 128), cuda_device)
    v = _bf16(rng, (B, Skv, Hkv, 128), cuda_device)
    got = na.flash_attention_cuda(q, k, v, causal=causal).float()
    ref = na.flash_attention_plain(q, k, v, causal=causal).float()
    # the reference's bf16 tolerance (tests/test_kernels.py:235-236)
    torch.testing.assert_close(got, ref, rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_cuda_flash_attention_takes_strided_views(cuda_device):
    """q, k and v as views into one fused (B, S, H + 2 Hkv, D) projection."""
    rng = np.random.default_rng(3)
    B, S, H, Hkv = 2, 96, 4, 2
    qkv = _bf16(rng, (B, S, H + 2 * Hkv, 128), cuda_device)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + Hkv], qkv[:, :, H + Hkv:]
    assert not q.is_contiguous()
    got = na.flash_attention_cuda(q, k, v)
    ref = na.flash_attention_cuda(q.contiguous(), k.contiguous(),
                                  v.contiguous())
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,causal", [
    (2, 200, 200, 8, 2, 64, True),     # head dim 64: one swizzle half a tile
    (2, 200, 200, 8, 2, 64, False),
    (1, 64, 64, 4, 4, 64, True),       # one tile, MHA
    (1, 129, 257, 4, 4, 64, True),     # edges of the 128-row tiles
    (1, 257, 129, 8, 8, 64, False),
    (2, 257, 129, 8, 4, 64, True),     # Skv < Sq
    (1, 127, 127, 6, 1, 64, True),     # rep 6 at head dim 64
    (4, 1024, 1024, 32, 32, 64, True),   # musicgen-large's prefill
    (1, 300, 300, 12, 2, 128, True),   # rep 6 (internvl2-26b's)
    (1, 257, 129, 12, 2, 128, False),
    (1, 1024, 1024, 48, 8, 128, True),   # internvl2-26b's prefill, batch 1
])
def test_cuda_flash_attention_wide_matches_plain(cuda_device, B, Sq, Skv, H,
                                                 Hkv, D, causal):
    """The dense configs' head dim 64 (musicgen-large) and 6 query heads a
    kv head (internvl2-26b), row by row within the reference's bf16
    tolerance."""
    rng = np.random.default_rng(Sq * H + Skv + D)
    q = _bf16(rng, (B, Sq, H, D), cuda_device)
    k = _bf16(rng, (B, Skv, Hkv, D), cuda_device)
    v = _bf16(rng, (B, Skv, Hkv, D), cuda_device)
    got = na.flash_attention_cuda(q, k, v, causal=causal)
    _row_close(got, na.flash_attention_plain(q, k, v, causal=causal))


@pytest.mark.cuda
def test_cuda_flash_attention_head_dim_64_strided_and_empty(cuda_device):
    """At head dim 64: q, k and v as views into one fused projection (a
    row stride of 2 (H + 2 Hkv) 64 bytes), and no key at all (every row
    0)."""
    rng = np.random.default_rng(31)
    B, S, H, Hkv = 2, 96, 4, 2
    qkv = _bf16(rng, (B, S, H + 2 * Hkv, 64), cuda_device)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + Hkv], qkv[:, :, H + Hkv:]
    got = na.flash_attention_cuda(q, k, v)
    assert torch.equal(got, na.flash_attention_cuda(
        q.contiguous(), k.contiguous(), v.contiguous()))
    _row_close(got, na.flash_attention_plain(q, k, v))
    none = na.flash_attention_cuda(q, k[:, :0], v[:, :0], causal=False)
    assert none.shape == q.shape and (none == 0).all()


def _pos(p, device):
    """A position as the decode kernel takes it: a 0-d int32 on the card."""
    return torch.full((), p, dtype=torch.int32, device=device)


def _decode_chunk(q, k):
    """The chunk the wrapper cuts this call's cache slice into."""
    B, H, D = q.shape
    S, Hkv = k.shape[1:3]
    return na.decode_chunk(B, S, Hkv, *na._decode_slots_of(
        na.build.library(), q.device, H // Hkv, D))


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,pos,start", [
    (2, 600, 8, 2, 0, 0),          # one live position
    (2, 600, 8, 2, 100, 0),        # inside the first chunk
    (2, 600, 8, 2, 255, 0),
    (2, 600, 8, 2, 256, 0),
    (2, 600, 8, 2, 599, 0),        # pos = S - 1: the whole cache
    (2, 600, 8, 2, 5000, 0),       # pos past the slice: all of it live
    (2, 400, 8, 2, 300, 50),       # a slice starting at 50
    (2, 400, 8, 2, 20, 50),        # pos before the slice: nothing live
    (2, 400, 8, 2, 449, 50),       # the slice's last position
    (3, 300, 16, 16, 290, 0),      # MHA (qwen2-moe)
    (3, 301, 16, 16, 300, 0),      # S not a multiple of any chunk
    (1, 300, 8, 1, 200, 0),        # rep 8
    (1, 333, 8, 1, 332, 0),        # rep 8, S - 1, ragged
    (2, 257, 4, 2, 256, 0),        # rep 2
    (4, 2080, 32, 8, 2079, 0),     # the qwen3-4b decode's shape, S - 1
    (4, 2080, 32, 8, 2048, 0),     # its first decode step
    (4, 272, 16, 16, 270, 0),      # the qwen2-moe decode's shape
    (1, 4, 4, 1, 3, 0),            # a slice shorter than one step
])
def test_cuda_decode_attention_matches_plain(cuda_device, B, S, H, Hkv, pos,
                                             start):
    rng = np.random.default_rng(S + pos)
    q = _bf16(rng, (B, H, 128), cuda_device)
    k = _bf16(rng, (B, S, Hkv, 128), cuda_device)
    v = _bf16(rng, (B, S, Hkv, 128), cuda_device)
    got = na.decode_attention_cuda(q, k, v, _pos(pos, cuda_device),
                                   start=start).float()
    ref = na.decode_attention_plain(q, k, v, pos, start=start).float()
    torch.testing.assert_close(got, ref, rtol=2e-2, atol=2e-2)
    if pos < start:
        assert (got == 0).all()
    # positions past pos are never read: NaN there changes nothing
    n_live = min(max(pos - start + 1, 0), S)
    k[:, n_live:] = float("nan")
    v[:, n_live:] = float("nan")
    again = na.decode_attention_cuda(q, k, v, _pos(pos, cuda_device),
                                     start=start).float()
    assert torch.equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,D,pos,start", [
    (2, 600, 8, 8, 64, 0, 0),          # head dim 64: 16 row groups of 8 lanes
    (2, 600, 8, 8, 64, 255, 0),
    (2, 600, 8, 8, 64, 599, 0),
    (2, 400, 8, 2, 64, 300, 50),       # a slice starting at 50
    (2, 400, 8, 2, 64, 20, 50),        # nothing live
    (2, 333, 12, 2, 64, 200, 0),       # rep 6 at head dim 64
    (1, 4, 6, 1, 64, 3, 0),            # a slice shorter than one step
    (4, 1040, 32, 32, 64, 1039, 0),    # musicgen-large's decode, S - 1
    (3, 301, 12, 2, 128, 300, 0),      # rep 6 (internvl2-26b's)
    (1, 333, 6, 1, 128, 100, 0),
    (4, 1040, 48, 8, 128, 1030, 0),    # internvl2-26b's decode
])
def test_cuda_decode_attention_wide_matches_plain(cuda_device, B, S, H, Hkv,
                                                  D, pos, start):
    """Head dim 64 and 6 query heads a kv head against the plain version
    row by row; the rows past pos NaN change nothing."""
    rng = np.random.default_rng(S + pos + D)
    q = _bf16(rng, (B, H, D), cuda_device)
    k = _bf16(rng, (B, S, Hkv, D), cuda_device)
    v = _bf16(rng, (B, S, Hkv, D), cuda_device)
    got = na.decode_attention_cuda(q, k, v, _pos(pos, cuda_device),
                                   start=start)
    ref = na.decode_attention_plain(q, k, v, pos, start=start)
    if pos < start:
        assert (got == 0).all()
    else:
        _row_close(got, ref)
    n_live = min(max(pos - start + 1, 0), S)
    k[:, n_live:] = float("nan")
    v[:, n_live:] = float("nan")
    assert torch.equal(na.decode_attention_cuda(
        q, k, v, _pos(pos, cuda_device), start=start), got)


@pytest.mark.cuda
@pytest.mark.parametrize("D,rep", [(64, 1), (64, 2), (64, 6), (64, 8),
                                   (128, 6)])
@pytest.mark.parametrize("edge", [-1, 0, 1])
def test_cuda_decode_attention_wide_chunk_edges(cuda_device, D, rep, edge):
    """As test_cuda_decode_attention_chunk_edges, at head dim 64 and at
    rep 6."""
    rng = np.random.default_rng(D * 100 + rep * 10 + edge)
    B, Hkv, S = 2, 2, 2080
    q = _bf16(rng, (B, Hkv * rep, D), cuda_device)
    k = _bf16(rng, (B, S, Hkv, D), cuda_device)
    v = _bf16(rng, (B, S, Hkv, D), cuda_device)
    chunk = _decode_chunk(q, k)
    assert chunk % na.DECODE_STEP == 0 and chunk < S
    for pos in (chunk + edge, 2 * chunk + edge):
        ref = na.decode_attention_plain(q, k, v, pos).float()
        kp, vp = k.clone(), v.clone()
        kp[:, pos + 1:] = float("nan")
        vp[:, pos + 1:] = float("nan")
        got = na.decode_attention_cuda(q, kp, vp, _pos(pos, cuda_device))
        _row_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("D,rep", [(64, 1), (64, 6), (128, 6)])
def test_cuda_decode_attention_wide_graph_replays(cuda_device, D, rep):
    """Captured once, replayed at several positions, at head dim 64 and at
    rep 6: each replay matches the plain version there, and the arrival
    counters are back at 0."""
    rng = np.random.default_rng(40 + D + rep)
    q = _bf16(rng, (4, 4 * rep, D), cuda_device)
    k = _bf16(rng, (4, 1040, 4, D), cuda_device)
    v = _bf16(rng, (4, 1040, 4, D), cuda_device)
    pos = _pos(0, cuda_device)
    na.decode_attention_cuda(q, k, v, pos)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = na.decode_attention_cuda(q, k, v, pos)
    for p in (1030, 0, 191, 192, 1039, 1030):
        pos.fill_(p)
        graph.replay()
        torch.cuda.synchronize()
        _row_close(out, na.decode_attention_plain(q, k, v, p))
    assert int(na._arrival_counters(q.device, 1).abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("edge", [-1, 0, 1])
def test_cuda_decode_attention_chunk_edges(cuda_device, rep, edge):
    """pos at the last position of a chunk, the first of the next and the
    one after, for each rep, at the qwen3 decode's cache length; the rows
    past pos NaN."""
    rng = np.random.default_rng(rep * 10 + edge)
    B, Hkv, S = 2, 4, 2080
    q = _bf16(rng, (B, Hkv * rep, 128), cuda_device)
    k = _bf16(rng, (B, S, Hkv, 128), cuda_device)
    v = _bf16(rng, (B, S, Hkv, 128), cuda_device)
    chunk = _decode_chunk(q, k)
    assert chunk % na.DECODE_STEP == 0 and chunk < S
    for pos in (chunk + edge, 2 * chunk + edge):
        ref = na.decode_attention_plain(q, k, v, pos).float()
        kp, vp = k.clone(), v.clone()
        kp[:, pos + 1:] = float("nan")
        vp[:, pos + 1:] = float("nan")
        got = na.decode_attention_cuda(q, kp, vp, _pos(pos, cuda_device))
        _row_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("rep", [1, 4, 8])
def test_cuda_decode_attention_dead_chunks_add_nothing(cuda_device, rep):
    """Scores far below 0 (every live key close to -q's direction), pos in
    the first chunk, so most blocks are dead: a dead chunk must merge as
    m = -inf, l = 0, o = 0; a finite m there would swamp the live chunks'
    weights (2^-200 underflows) and zero the output."""
    rng = np.random.default_rng(rep)
    B, Hkv, S = 2, 2, 1000
    u = rng.standard_normal((B, 1, Hkv, 128)).astype(np.float32)
    k = u + 0.3 * rng.standard_normal((B, S, Hkv, 128)).astype(np.float32)
    q = -20.0 * np.repeat(u[:, 0], rep, axis=1)
    q, k = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
            for a in (q, k))
    v = _bf16(rng, (B, S, Hkv, 128), cuda_device)
    for pos in (0, 40, S - 1):
        ref = na.decode_attention_plain(q, k, v, pos).float()
        s = torch.einsum("bhd,bshd->bhs", q.float()[:, ::rep], k.float())
        # base-2 scores, as the kernel keeps them: below -150 on every key
        assert float(s[..., :pos + 1].max()) / np.sqrt(128) * 1.4427 < -150
        got = na.decode_attention_cuda(q, k, v, _pos(pos, cuda_device))
        _row_close(got, ref)


@pytest.mark.cuda
def test_cuda_decode_attention_resets_its_counters(cuda_device):
    """The merging block sets its arrival counter back to 0: the same call
    twice, and after a call at another shape, gives the same bits."""
    rng = np.random.default_rng(9)
    q = _bf16(rng, (4, 32, 128), cuda_device)
    k = _bf16(rng, (4, 2080, 8, 128), cuda_device)
    v = _bf16(rng, (4, 2080, 8, 128), cuda_device)
    pos = _pos(2078, cuda_device)
    first = na.decode_attention_cuda(q, k, v, pos)
    assert torch.equal(na.decode_attention_cuda(q, k, v, pos), first)
    na.decode_attention_cuda(q[:2, :8].contiguous(), k[:2, :100, :2].contiguous(),
                             v[:2, :100, :2].contiguous(), _pos(50, cuda_device))
    assert torch.equal(na.decode_attention_cuda(q, k, v, pos), first)
    assert int(na._arrival_counters(q.device, 1).abs().sum()) == 0


@pytest.mark.cuda
def test_cuda_decode_attention_graph_replays(cuda_device):
    """One CUDA graph, captured once with pos in a static buffer, replayed
    at several positions: each replay matches the plain version there."""
    rng = np.random.default_rng(10)
    q = _bf16(rng, (4, 32, 128), cuda_device)
    k = _bf16(rng, (4, 2080, 8, 128), cuda_device)
    v = _bf16(rng, (4, 2080, 8, 128), cuda_device)
    pos = _pos(0, cuda_device)
    na.decode_attention_cuda(q, k, v, pos)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = na.decode_attention_cuda.launches
    with torch.cuda.graph(graph):
        out = na.decode_attention_cuda(q, k, v, pos)
    assert na.decode_attention_cuda.launches == before + 1
    for p in (2078, 0, 191, 192, 1000, 2079, 2078):
        pos.fill_(p)
        graph.replay()
        torch.cuda.synchronize()
        _row_close(out, na.decode_attention_plain(q, k, v, p))


@pytest.mark.cuda
def test_cuda_attention_and_norm_refuse_grad(cuda_device):
    """The three kernels have no backward: an input that requires a
    gradient under grad mode raises; under inference mode they launch."""
    rng = np.random.default_rng(4)
    x = _bf16(rng, (4, 128), cuda_device)
    scale = torch.ones(128, device=cuda_device, requires_grad=True)
    q = _bf16(rng, (1, 64, 4, 128), cuda_device).requires_grad_(True)
    k = _bf16(rng, (1, 64, 2, 128), cuda_device)
    before = (na.rmsnorm_cuda.launches, na.flash_attention_cuda.launches,
              na.decode_attention_cuda.launches)
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        ops.rmsnorm(x, scale)
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        ops.flash_attention(q, k, k)
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        ops.decode_attention(q[:, 0], k, k, _pos(10, cuda_device))
    assert (na.rmsnorm_cuda.launches, na.flash_attention_cuda.launches,
            na.decode_attention_cuda.launches) == before
    with torch.inference_mode():
        ops.rmsnorm(x, scale)
        ops.flash_attention(q, k, k)
        ops.decode_attention(q[:, 0].contiguous(), k, k, _pos(10, cuda_device))
    assert (na.rmsnorm_cuda.launches, na.flash_attention_cuda.launches,
            na.decode_attention_cuda.launches) == tuple(b + 1 for b in before)


@pytest.mark.cuda
def test_cuda_attention_wrappers_raise_on_inputs_they_do_not_take(
        cuda_device):
    rng = np.random.default_rng(5)
    q = _bf16(rng, (1, 8, 4, 96), cuda_device)           # head dim 96
    with pytest.raises(ValueError, match="head dim"):
        na.flash_attention_cuda(q, q[:, :, :2], q[:, :, :2])
    q = _bf16(rng, (1, 8, 4, 128), cuda_device)
    with pytest.raises(ValueError, match="bfloat16"):
        na.flash_attention_cuda(q.float(), q, q)
    with pytest.raises(ValueError, match="kv heads"):
        na.flash_attention_cuda(q, q[:, :, :3], q[:, :, :3])
    k = _bf16(rng, (1, 32, 1, 128), cuda_device)
    with pytest.raises(ValueError, match="query heads a kv head"):
        na.decode_attention_cuda(_bf16(rng, (1, 16, 128), cuda_device), k, k,
                                 _pos(5, cuda_device))
    # pos: a 0-d int32 on q's device, nothing else
    q1 = _bf16(rng, (1, 8, 128), cuda_device)
    before = na.decode_attention_cuda.launches
    for bad in (5, torch.tensor(5, dtype=torch.int32),
                torch.tensor(5, device=cuda_device),
                torch.tensor([5], dtype=torch.int32, device=cuda_device)):
        with pytest.raises(ValueError, match="0-d int32 tensor"):
            na.decode_attention_cuda(q1, k, k, bad)
    assert na.decode_attention_cuda.launches == before
    x = _bf16(rng, (3, 128), cuda_device)
    with pytest.raises(ValueError, match="float32"):
        na.rmsnorm_cuda(x, torch.ones(128, device=cuda_device,
                                      dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        na.rmsnorm_cuda(_bf16(rng, (128, 3), cuda_device).T,
                        torch.ones(128, device=cuda_device))


@pytest.mark.cuda
def test_cuda_serve_cli_reduced_qwen3(cuda_device, capsys):
    """A reduced qwen3 (head dim 128) served on the card goes through the
    three kernels; the decode step's are counted where Python calls them:
    its two warm-up steps and its capture, not its replays."""
    from repro_torch.launch import serve
    before = (na.rmsnorm_cuda.launches, na.flash_attention_cuda.launches,
              na.decode_attention_cuda.launches)
    assert serve.main(["--arch", "qwen3_4b", "--reduced", "--d-model", "512",
                       "--batch", "2", "--prompt-len", "40", "--gen",
                       "4"]) == 0
    assert "[serve] generated 8 tokens" in capsys.readouterr().out
    after = (na.rmsnorm_cuda.launches, na.flash_attention_cuda.launches,
             na.decode_attention_cuda.launches)
    # the prefill, 2 warm-up steps and the capture, each 2 layers of 4
    # norms and the final one; 2 prefill attentions, 2 x 3 decode ones
    assert [a - b for a, b in zip(after, before)] == [4 * 9, 2, 6]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,world", [("qwen3_4b", None),
                                        ("qwen2_moe_a2_7b", 2)])
def test_cuda_generate_graph_matches_eager(cuda_device, arch, world):
    """``generate`` through the captured decode step (the default on the
    card) and through the eager step, on the same prompts: the same tokens
    bit for bit.  qwen2-moe runs over an EP world of 2, so its prompt too
    runs through decode steps (LL), replayed from the graph, as the
    reference serves ``--mesh local``.  The capture counts each kernel of
    a step once."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.distributed.sharding import make_dist_ctx
    from repro_torch.launch.serve import generate
    from repro_torch.models import model_zoo as Z
    cfg = reduced_config(get_config(arch), n_layers=2, d_model=512,
                         vocab=512)
    dist = make_dist_ctx(cfg, model=world) if world else None
    params = Z.init_params(cfg, seed=0, device=cuda_device,
                           dtype=Z.compute_dtype(cfg))
    B, S, n_gen = 4, 24, 8
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.
                            Generator().manual_seed(0)).to(cuda_device)
    eager = generate(cfg, params, prompts, n_gen, dist=dist,
                     cuda_graph=False)
    graph = generate(cfg, params, prompts, n_gen, dist=dist)
    assert graph["cuda_graph"] and not eager["cuda_graph"]
    assert graph["capture_s"] > 0 and eager["capture_s"] is None
    assert graph["tokens"].shape == (B, n_gen)
    assert torch.equal(graph["tokens"], eager["tokens"])
    # a layer's ln1 and ln2 (and q_norm, k_norm under qk_norm), the final
    assert graph["captured_launches"]["rmsnorm"] == (
        4 if cfg.qk_norm else 2) * cfg.n_layers + 1
    assert graph["captured_launches"]["decode_attention"] == cfg.n_layers
    assert graph["graph_replays"] == (n_gen - 1 if world is None
                                      else S - 1 + n_gen)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,heads", [
    ("musicgen_large", (4, 4, 64)),      # MHA at head dim 64
    ("internvl2_26b", (12, 2, 128)),     # 6 query heads a kv head
])
def test_cuda_generate_dense_head_structures(cuda_device, arch, heads):
    """Reduced musicgen-large and internvl2-26b with their models' head
    structures served through the three kernels, the captured decode step
    against the eager one (the same tokens bit for bit); the prefill's
    last logits against the plain versions' (chip_smoke's
    SERVE_PLAIN_TOL)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import model_zoo as Z
    h, hkv, hd = heads
    cfg = dataclasses.replace(
        reduced_config(get_config(arch), n_layers=2, d_model=256, vocab=512),
        n_heads=h, n_kv_heads=hkv, head_dim=hd)
    params = Z.init_params(cfg, seed=0, device=cuda_device,
                           dtype=Z.compute_dtype(cfg))
    B, S, n_gen = 4, 40, 6
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.
                            Generator().manual_seed(0)).to(cuda_device)
    before = (na.flash_attention_cuda.launches,
              na.decode_attention_cuda.launches)
    graph = generate(cfg, params, prompts, n_gen)
    assert na.flash_attention_cuda.launches > before[0]
    assert na.decode_attention_cuda.launches > before[1]
    eager = generate(cfg, params, prompts, n_gen, cuda_graph=False)
    assert torch.equal(graph["tokens"], eager["tokens"])
    def prefill():
        cache = Z.init_cache(cfg, B, S, dtype=Z.compute_dtype(cfg),
                             device=cuda_device)
        with torch.inference_mode():
            return Z.prefill(cfg, params, cache, prompts)[0]
    got = prefill()
    originals = {n: ops.KERNELS[n] for n in ("rmsnorm", "flash_attention",
                                             "decode_attention")}
    try:
        ops.KERNELS.update({n: (p, p) for n, (_, p) in originals.items()})
        ref = prefill()
    finally:
        ops.KERNELS.update(originals)
    err = float((got - ref).abs().max())
    assert err <= 0.04 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("arch,world", [("falcon_mamba_7b", None),
                                        ("jamba_1_5_large_398b", 2)])
def test_cuda_generate_graph_matches_eager_mamba(cuda_device, arch, world):
    """A Mamba model (and the jamba hybrid over an EP world of 2) served
    through the captured decode step and through the eager step: the same
    tokens and last logits bit for bit.  The capture's warm-up steps
    advance the conv and ssm states; without the reset after the capture
    the replayed steps would start from them."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.distributed.sharding import make_dist_ctx
    from repro_torch.launch.serve import generate
    from repro_torch.models import model_zoo as Z
    cfg = reduced_config(get_config(arch), n_layers=2, d_model=512,
                         vocab=512)
    dist = make_dist_ctx(cfg, model=world) if world else None
    params = Z.init_params(cfg, seed=0, device=cuda_device,
                           dtype=Z.compute_dtype(cfg))
    B, S, n_gen = 4, 24, 8
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.
                            Generator().manual_seed(0)).to(cuda_device)
    eager = generate(cfg, params, prompts, n_gen, dist=dist,
                     cuda_graph=False)
    graph = generate(cfg, params, prompts, n_gen, dist=dist)
    assert graph["cuda_graph"] and not graph["batched_prefill"]
    assert graph["tokens"].shape == (B, n_gen)
    assert torch.equal(graph["tokens"], eager["tokens"])
    assert torch.equal(graph["logits"], eager["logits"])
    attn = sum(cfg.is_attn_layer(i) for i in range(cfg.n_layers))
    assert graph["captured_launches"]["rmsnorm"] == 2 * cfg.n_layers + 1
    assert graph["captured_launches"]["decode_attention"] == attn
    assert graph["graph_replays"] == S - 1 + n_gen


def _range_close(got, ref, tol=1e-2):
    """max |got - ref| within tol of max |ref| (chip_smoke.py's limit for
    the grouped kernels): h and y round to bf16 after fp32 sums taken in
    another order, so an element may move by an ulp of the typical value,
    not of its own."""
    assert torch.isfinite(got).all()
    err = float((got - ref).abs().max())
    assert err <= tol * float(ref.abs().max()), (err, float(ref.abs().max()))


def _poisoned_allocation(shape, dtype, device):
    """Leave a NaN-filled block of this size in the caching allocator, so
    that the next allocation of the same size (a wrapper's output) starts
    as NaN rather than as whatever the card held: rows a kernel must write
    as zeros then show if it skips them."""
    t = torch.full(shape, float("nan"), dtype=dtype, device=device)
    del t


@pytest.mark.cuda
@pytest.mark.parametrize("counts_kind", ["none", "flat"])
def test_cuda_grouped_matmul_matches_plain(cuda_device, counts_kind):
    rng = np.random.default_rng(11)
    G, M, K, N = 5, 70, 136, 200     # ragged against the 128 x 128 x 64 tiles
    x = _bf16(rng, (G, M, K), cuda_device)
    w = _bf16(rng, (G, K, N), cuda_device, 0.1)
    counts = (None if counts_kind == "none" else torch.tensor(
        [0, 1, 70, 64, 33], dtype=torch.int32, device=cuda_device))
    before = gm.grouped_matmul_cuda.launches
    _poisoned_allocation((G, M, N), torch.bfloat16, cuda_device)
    got = ops.grouped_matmul(x, w, counts).float()
    ref = gm.grouped_matmul_plain(x, w, counts).float()
    assert gm.grouped_matmul_cuda.launches == before + 1
    # fp32 sums in another order, then one bf16 rounding on each side
    _range_close(got, ref)
    if counts is not None:
        dead = ~gm.occupancy_mask(counts, G, M)
        assert (got[dead] == 0).all()


# The tile loop of swiglu_tiles.cuh: 128-row tiles of two 64-row consumer
# warpgroups, 128 columns (256 in the down pass), K in steps of 64 through
# a ring of 4 stages.  D 200 and F 136 make every pass ragged in K (not a
# multiple of 64) and in N (not of 128); D 1000 and F 520 also wrap the
# ring (16 and 9 steps), and qwen2-moe's D 2048 and F 1408 wrap it 8 and 5
# times, so that a stage refilled before its products are done can show.
# Counts sit on either side of the consumers' and the tile's edges; C 129
# and 192 give a second, partly filled row tile.
TILE_DIMS = {"ragged": (200, 136), "deep": (1000, 520),
             "served": (2048, 1408)}
TILE_FLAT = [(128, (63, 64, 65, 127, 128)),
             (129, (128, 129, 0, 65, 64)),
             (192, (127, 192, 63, 0, 129)),
             (128, (0, 0, 0, 0, 0))]                 # every group empty
# bucketed (E, 4) counts: several sub-buckets of one expert occupied,
# others empty; at C 192 a sub-bucket of 48 straddles the two consumers
TILE_BUCKETED = [(64, ((16, 0, 5, 1), (0, 0, 0, 0), (0, 16, 16, 0),
                       (3, 0, 0, 0), (16, 16, 16, 16))),
                 (192, ((48, 0, 0, 1), (0, 0, 33, 0), (0, 0, 0, 0),
                        (17, 48, 0, 2), (0, 0, 0, 48)))]
TILE_KERNELS = ("grouped_matmul", "grouped_swiglu", "gather_swiglu_scatter")
TILE_CASES = ([(k, C, c, "ragged") for k in TILE_KERNELS
               for C, c in TILE_FLAT]
              + [("grouped_swiglu", C, c, "ragged") for C, c in TILE_BUCKETED]
              + [(k, 128, (128, 127, 65, 64, 0), "deep")
                 for k in TILE_KERNELS]
              + [("grouped_swiglu", *TILE_BUCKETED[1], "deep")]
              + [(k, 128, (128, 127, 65, 64, 0), "served")
                 for k in TILE_KERNELS]
              + [("grouped_swiglu", *TILE_BUCKETED[1], "served")])


def _tile_case(kernel, C, counts, dims, device):
    """(args, plain args, output shape or None, dead rows or None) of one
    tile-loop kernel: 5 experts of C rows, seeded bf16 inputs."""
    rng = np.random.default_rng(C + 7 * len(counts))
    E, (D, F) = len(counts), TILE_DIMS[dims]
    cnt = torch.tensor(counts, dtype=torch.int32, device=device)
    if kernel == "grouped_matmul":
        args = (_bf16(rng, (E, C, D), device),
                _bf16(rng, (E, D, F), device, 0.1), cnt)
        return args, args, (E, C, F), ~gm.occupancy_mask(cnt, E, C)
    ws = [torch.from_numpy(a).to(device, torch.bfloat16)
          for a in _w(rng, E, D, F)]
    if kernel == "grouped_swiglu":
        args = (_bf16(rng, (E, C, D), device), *ws, cnt)
        return args, args, (E, C, D), ~gm.occupancy_mask(cnt, E, C)
    T = 300
    x_ext = _bf16(rng, (T + 1, D), device)
    x_ext[T] = 0
    src = torch.from_numpy(rng.integers(0, T, E * C).astype(np.int32))
    src[:40] = 7                                    # duplicate tokens add
    # out-of-range rows: the gather clamps them, the scatter skips them,
    # as the plain version does for a slot on the scratch row T
    oob = torch.zeros(E * C, dtype=torch.bool)
    oob[1::C] = True
    src[1::C] = torch.tensor([-3, T + 1, 10 ** 6, -1, T + 5][:E],
                             dtype=torch.int32)
    w = torch.from_numpy(rng.random(E * C).astype(np.float32))
    src, w, oob = (t.to(device) for t in (src, w, oob))
    args = (x_ext, src, w, *ws, cnt)
    plain = (x_ext, torch.where(oob, T, src), w, *ws, cnt)
    return args, plain, None, None


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,C,counts,dims", TILE_CASES)
def test_cuda_tile_loop_geometry(cuda_device, kernel, C, counts, dims):
    args, plain_args, out_shape, dead = _tile_case(kernel, C, counts, dims,
                                                   cuda_device)
    E = len(counts)
    # NaN-poisoned output and h (as _poisoned_allocation, both held at once
    # so that the wrapper's two allocations land in the poisoned span): a
    # skipped zero row, or an unwritten h row read into a written one, shows
    F = TILE_DIMS[dims][1]
    shapes = [s for s in (out_shape, (E * C, F)
                          if kernel != "grouped_matmul" else None) if s]
    poison = [torch.full(s, float("nan"), dtype=torch.bfloat16,
                         device=cuda_device) for s in shapes]
    del poison
    cuda = getattr(gm, kernel + "_cuda")
    before = cuda.launches
    got = cuda(*args).float()
    ref = getattr(gm, kernel + "_plain")(*plain_args).float()
    torch.cuda.synchronize()
    assert cuda.launches == before + 1
    if ref.abs().max() == 0:            # every group empty
        assert (got == 0).all()
    else:
        _range_close(got, ref)
    if dead is not None:
        assert (got[dead] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("C,counts", [
    (67, (0, 1, 67, 64, 65, 30)),     # C with no divisor >= 8, ragged tiles
    (128, (128, 0, 0, 5, 127, 64)),   # the served HT buffer's C
    (40, None)])
def test_cuda_grouped_swiglu_db_matches_plain(cuda_device, C, counts):
    rng = np.random.default_rng(C)
    E, D, F = 6, 136, 200
    x = _bf16(rng, (E, C, D), cuda_device)
    ws = [torch.from_numpy(a).to(cuda_device, torch.bfloat16)
          for a in _w(rng, E, D, F)]
    cnt = (None if counts is None else
           torch.tensor(counts, dtype=torch.int32, device=cuda_device))
    before = gm.grouped_swiglu_db_cuda.launches
    _poisoned_allocation((E, C, D), torch.bfloat16, cuda_device)
    got = gm.grouped_swiglu_db_cuda(x, *ws, cnt).float()
    ref = gm.grouped_swiglu_db_plain(x, *ws, cnt).float()
    assert gm.grouped_swiglu_db_cuda.launches == before + 1
    _range_close(got, ref)
    if cnt is not None:
        dead = ~gm.occupancy_mask(cnt, E, C)
        assert (got[dead] == 0).all()
    with pytest.raises(ValueError, match="bucketed"):
        gm.grouped_swiglu_db_cuda(x, *ws, torch.ones(
            (E, 2), dtype=torch.int32, device=cuda_device))
    assert gm.grouped_swiglu_db_cuda.launches == before + 1


@pytest.mark.cuda
def test_cuda_swiglu_db_env_routing(cuda_device, monkeypatch):
    """Under REPRO_SWIGLU_DB=1 flat counts launch the double-buffered
    kernel and bucketed counts the grouped one; without it, the grouped
    one always."""
    rng = np.random.default_rng(12)
    E, C, D, F = 4, 32, 64, 96
    x = _bf16(rng, (E, C, D), cuda_device)
    ws = [torch.from_numpy(a).to(cuda_device, torch.bfloat16)
          for a in _w(rng, E, D, F)]
    flat = torch.tensor([3, 0, 32, 17], dtype=torch.int32, device=cuda_device)
    bucketed = torch.full((E, 2), 5, dtype=torch.int32, device=cuda_device)
    counters = (gm.grouped_swiglu_db_cuda, gm.grouped_swiglu_cuda)
    for env, cnt, moved in (("1", flat, 0), ("1", bucketed, 1),
                            ("0", flat, 1), (None, flat, 1)):
        if env is None:
            monkeypatch.delenv("REPRO_SWIGLU_DB", raising=False)
        else:
            monkeypatch.setenv("REPRO_SWIGLU_DB", env)
        before = [c.launches for c in counters]
        with torch.no_grad():
            ops.grouped_swiglu(x, *ws, cnt)
        assert [c.launches - b for c, b in zip(counters, before)] == [
            int(moved == 0), int(moved == 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("parts_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,K,D", [(1024, 4, 2048), (37, 3, 200),
                                   (9, 2, 7)])
def test_cuda_combine_reduce_matches_plain(cuda_device, parts_dtype, w_dtype,
                                           T, K, D):
    """Bit for bit: both sum in fp32 in k order, rounding each product and
    each sum, and round once to the parts' dtype (D = 7: the scalar path)."""
    rng = np.random.default_rng(T + D)
    parts = torch.from_numpy(rng.standard_normal((T, K, D)).astype(
        np.float32)).to(cuda_device, parts_dtype)
    w = torch.from_numpy(rng.random((T, K)).astype(np.float32)).to(
        cuda_device, w_dtype)
    before = cr.combine_reduce_cuda.launches
    got = ops.combine_reduce(parts, w)
    assert cr.combine_reduce_cuda.launches == before + 1
    assert got.dtype == parts_dtype and got.shape == (T, D)
    assert torch.equal(got, cr.combine_reduce_plain(parts, w))


def _paged_case(rng, device, pos, B=4, H=32, Hkv=8, bs=16, extra_cols=3):
    """qwen3-4b's decode heads over pools whose tables a KVBlockPool makes:
    sequences grown round-robin a block at a time (their blocks
    interleave), sequence 1 released and grown again (LIFO reuse), -1 past
    each table; every pool block no live position reads, and the rows past
    pos in each last block, are NaN."""
    n_live = [p + 1 for p in pos]
    nb = max(-(-n // bs) for n in n_live) + extra_cols
    pool = KVBlockPool(n_blocks=sum(-(-n // bs) for n in n_live) + 8,
                       block_size=bs)
    for step in range(max(n_live)):
        for b in range(B):
            if step * bs < n_live[b]:
                pool.grow(b, min((step + 1) * bs, n_live[b]))
    pool.release(1)
    pool.grow(1, n_live[1])
    pool.assert_consistent()
    tables = pool.block_tables(range(B), width=nb, device=device)
    shape = (pool.n_blocks, bs, Hkv, 128)
    k = torch.full(shape, float("nan"), device=device, dtype=torch.bfloat16)
    v = torch.full(shape, float("nan"), device=device, dtype=torch.bfloat16)
    for b in range(B):
        for j, blk in enumerate(pool.block_table(b)):
            rows = min(bs, n_live[b] - j * bs)
            k[blk, :rows] = _bf16(rng, (rows, Hkv, 128), device)
            v[blk, :rows] = _bf16(rng, (rows, Hkv, 128), device)
    q = _bf16(rng, (B, H, 128), device)
    return q, k, v, tables, torch.tensor(pos, dtype=torch.int32,
                                         device=device)


def _row_close(got, ref, tol=2e-2):
    """Each output row (a query head) within tol of its largest value."""
    err = (got.float() - ref.float()).abs().amax(-1)
    scale = ref.float().abs().amax(-1).clamp_min(1e-30)
    assert torch.isfinite(got.float()).all()
    assert (err <= tol * scale).all(), float((err / scale).max())


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [(2078, 2047, 1031, 17), (0, 15, 16, 300),
                                 (255, 256, 511, 512)])
def test_cuda_decode_attention_paged_matches_plain(cuda_device, pos):
    rng = np.random.default_rng(sum(pos))
    q, k, v, tables, posv = _paged_case(rng, cuda_device, pos)
    before = na.decode_attention_paged_cuda.launches
    got = ops.decode_attention_paged(q, k, v, tables, posv)
    ref = na.decode_attention_paged_plain(q, k, v, tables, posv)
    assert na.decode_attention_paged_cuda.launches == before + 1
    _row_close(got, ref)
    # a -1 inside sequence 0's live prefix is skipped, as by the plain version
    tables[0, 1] = -1
    _row_close(ops.decode_attention_paged(q, k, v, tables, posv),
               na.decode_attention_paged_plain(q, k, v, tables, posv))
    # nothing live: pos -1, or a table of -1 only
    posv[2] = -1
    tables[3] = -1
    out = ops.decode_attention_paged(q, k, v, tables, posv)
    assert (out[2:] == 0).all() and torch.isfinite(out.float()).all()


@pytest.mark.cuda
def test_cuda_decode_attention_paged_equals_contiguous(cuda_device,
                                                       monkeypatch):
    """One pos for every sequence.  The pool's rows copied into fresh
    blocks in table order (an identity table: sequence b's column j is
    block b * nb + j): the paged kernel does the same arithmetic in the
    same order through either table, so the two agree bit for bit, and a
    live block read twice or in another's place shows.  The rows gathered
    back into a contiguous cache of nb * 16 positions: both kernels run
    one body (csrc/decode_common.cuh), so at the same chunk the paged and
    the contiguous kernels agree bit for bit too."""
    rng = np.random.default_rng(7)
    pos = (2078,) * 4
    q, k, v, tables, posv = _paged_case(rng, cuda_device, pos)
    B, nb = tables.shape
    S = nb * 16
    idx = tables.clamp_min(0).long()
    paged = ops.decode_attention_paged(q, k, v, tables, posv)
    ident = torch.arange(B * nb, dtype=torch.int32,
                         device=cuda_device).reshape(B, nb)
    ident = torch.where(tables >= 0, ident, tables)
    k_id, v_id = (t[idx.flatten()].contiguous() for t in (k, v))
    assert torch.equal(
        ops.decode_attention_paged(q, k_id, v_id, ident, posv), paged)
    kc = k[idx].reshape(4, S, 8, 128).contiguous()
    vc = v[idx].reshape(4, S, 8, 128).contiguous()
    slots = na._decode_slots_of(na.build.library(), q.device, 4, 128)
    chunk = na.decode_chunk(B, S, 8, *slots)
    monkeypatch.setattr(na, "decode_chunk", lambda *a: chunk)
    assert torch.equal(ops.decode_attention_paged(q, k, v, tables, posv),
                       na.decode_attention_cuda(q, kc, vc,
                                                _pos(pos[0], cuda_device)))


def _paged_bulk(rng, device, pos, H, Hkv, bs, nb, spare=5, D=128):
    """Pools in bulk for the sequences' positions ``pos``: each table row
    nb pool blocks of a random permutation (every column allocated, those
    wholly past pos too), ``spare`` blocks no table names; every pool row
    no live position reads is NaN."""
    B = len(pos)
    NB = B * nb + spare
    tables = torch.from_numpy(rng.permutation(NB)[:B * nb].astype(
        np.int32)).reshape(B, nb).to(device)
    k = _bf16(rng, (NB, bs, Hkv, D), device)
    v = _bf16(rng, (NB, bs, Hkv, D), device)
    posv = torch.tensor(pos, dtype=torch.int32, device=device)
    j = torch.arange(nb * bs, device=device)
    rows = tables.long()[:, j // bs] * bs + j % bs
    read = torch.zeros(NB * bs, dtype=torch.bool, device=device)
    read[rows[j[None, :] <= posv.long()[:, None]]] = True
    for t in (k, v):
        t.view(NB * bs, Hkv, D)[~read] = float("nan")
    q = _bf16(rng, (B, H, D), device)
    return q, k, v, tables, posv


@pytest.mark.cuda
@pytest.mark.parametrize("rep", na.DECODE_REPS)
@pytest.mark.parametrize("bs", [8, 16, 32, 64])
def test_cuda_decode_attention_paged_blocks_and_reps(cuda_device, bs, rep):
    """Every rep at block sizes 8 to 64, ragged pos about block and chunk
    edges, allocated blocks wholly past pos and NaN in every unread row."""
    Hkv = 8 // rep
    pos = (2 * bs - 1, 2 * bs, 700, 1500, 0)
    nb = 1500 // bs + 3
    rng = np.random.default_rng(bs * 10 + rep)
    q, k, v, tables, posv = _paged_bulk(rng, cuda_device, pos, Hkv * rep,
                                        Hkv, bs, nb)
    got = na.decode_attention_paged_cuda(q, k, v, tables, posv)
    _row_close(got, na.decode_attention_paged_plain(q, k, v, tables, posv))


@pytest.mark.cuda
@pytest.mark.parametrize("D,rep", [(64, 1), (64, 6), (128, 6)])
@pytest.mark.parametrize("bs", [8, 16])
def test_cuda_decode_attention_paged_wide(cuda_device, D, rep, bs):
    """Head dim 64 (musicgen-large's cache) and rep 6 (internvl2-26b's)
    through block tables: ragged pos about block and chunk edges, NaN in
    every unread row, against the plain version; and, with one pos for
    every sequence and the rows gathered back into a contiguous cache,
    against the contiguous kernel at the same chunk, bit for bit."""
    Hkv = 2
    pos = (2 * bs - 1, 2 * bs, 700, 1030, 0)
    nb = 1030 // bs + 3
    rng = np.random.default_rng(D + rep * 10 + bs)
    q, k, v, tables, posv = _paged_bulk(rng, cuda_device, pos, Hkv * rep,
                                        Hkv, bs, nb, D=D)
    got = na.decode_attention_paged_cuda(q, k, v, tables, posv)
    _row_close(got, na.decode_attention_paged_plain(q, k, v, tables, posv))
    B, S = len(pos), nb * bs
    posv.fill_(S - 1)
    k, v = (torch.nan_to_num(t) for t in (k, v))
    paged = na.decode_attention_paged_cuda(q, k, v, tables, posv)
    kc, vc = (t[tables.long()].reshape(B, S, Hkv, D).contiguous()
              for t in (k, v))
    slots = na._decode_slots_of(na.build.library(), q.device, rep, D,
                                "decode_attention_paged")
    chunk = na.paged_chunk(B, nb, bs, Hkv, *slots)
    saved = na.decode_chunk
    na.decode_chunk = lambda *a: chunk
    try:
        cont = na.decode_attention_cuda(q, kc, vc, _pos(S - 1, cuda_device))
    finally:
        na.decode_chunk = saved
    assert torch.equal(paged, cont)


@pytest.mark.cuda
def test_cuda_decode_attention_paged_ids_past_the_pool(cuda_device):
    """Table ids >= NB (and below -1) inside the live prefix are
    unallocated, as -1 is: skipped, never read."""
    rng = np.random.default_rng(11)
    q, k, v, tables, posv = _paged_bulk(rng, cuda_device, (900, 513, 64),
                                        32, 8, 16, 60)
    NB = k.shape[0]
    tables[0, 3] = NB
    tables[0, 20] = NB + 1000
    tables[1, 0] = 2 ** 31 - 1
    tables[2, 1] = -7
    got = na.decode_attention_paged_cuda(q, k, v, tables, posv)
    _row_close(got, na.decode_attention_paged_plain(q, k, v, tables, posv))


@pytest.mark.cuda
def test_cuda_decode_attention_paged_wide_tables(cuda_device):
    """Tables wider than 256 columns: at 8-token blocks, and at 1-token
    blocks with more (sequence, kv head) pairs than resident blocks, where
    the rule's chunk stops at the 256 columns a block stages and the
    chunks run past one wave."""
    rng = np.random.default_rng(12)
    q, k, v, tables, posv = _paged_bulk(rng, cuda_device, (2390, 1200, 5),
                                        32, 8, 8, 300)
    _row_close(na.decode_attention_paged_cuda(q, k, v, tables, posv),
               na.decode_attention_paged_plain(q, k, v, tables, posv))
    B, Hkv, nb = 128, 8, 300
    pos = tuple(int(p) for p in rng.integers(0, nb, B))
    q, k, v, tables, posv = _paged_bulk(rng, cuda_device, pos, Hkv, Hkv, 1,
                                        nb)
    slots = na._decode_slots_of(na.build.library(), q.device, 1, 128,
                                "decode_attention_paged")
    assert na.paged_chunk(B, nb, 1, Hkv, *slots) == na.PAGED_MAX_COLS
    _row_close(na.decode_attention_paged_cuda(q, k, v, tables, posv),
               na.decode_attention_paged_plain(q, k, v, tables, posv))


@pytest.mark.cuda
def test_cuda_decode_attention_paged_graph_replays(cuda_device):
    """One CUDA graph, captured once with pos and the tables in static
    buffers, replayed after both (and the pools) are changed in place:
    each replay matches the plain version on what the buffers then hold."""
    rng = np.random.default_rng(13)
    pos = (2078, 2047, 1031, 17)
    q, k, v, tables, posv = _paged_case(rng, cuda_device, pos)
    na.decode_attention_paged_cuda(q, k, v, tables, posv)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = na.decode_attention_paged_cuda.launches
    with torch.cuda.graph(graph):
        out = na.decode_attention_paged_cuda(q, k, v, tables, posv)
    assert na.decode_attention_paged_cuda.launches == before + 1
    first = tables.clone()
    # each new pos at most the table row's old one: no NaN row is live
    for new_pos, order in (((2078, 2047, 1031, 17), (0, 1, 2, 3)),
                           ((12, 931, 2040, 2078), (3, 2, 1, 0)),
                           ((0, 1030, -1, 1999), (1, 2, 3, 0)),
                           ((2078, 2047, 1031, 17), (0, 1, 2, 3))):
        tables.copy_(first[list(order)])
        posv.copy_(torch.tensor(new_pos, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        _row_close(out, na.decode_attention_paged_plain(q, k, v, tables,
                                                        posv))
    # the pools too: a live row changed in place is read on the next replay
    k[int(tables[0, 0])] *= 2
    graph.replay()
    torch.cuda.synchronize()
    _row_close(out, na.decode_attention_paged_plain(q, k, v, tables, posv))
    assert int(na._arrival_counters(q.device, 1).abs().sum()) == 0


@pytest.mark.cuda
def test_cuda_new_kernels_refuse_grad_and_bad_inputs(cuda_device):
    """No backward kernels: an input that requires a gradient raises under
    grad mode; and each wrapper raises on inputs its kernel does not
    take, launching nothing."""
    rng = np.random.default_rng(8)
    x = _bf16(rng, (2, 8, 16), cuda_device).requires_grad_(True)
    w = _bf16(rng, (2, 16, 16), cuda_device)
    counters = (gm.grouped_matmul_cuda, gm.grouped_swiglu_db_cuda,
                cr.combine_reduce_cuda, na.decode_attention_paged_cuda)
    before = [c.launches for c in counters]
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        ops.grouped_matmul(x, w)
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        ops.combine_reduce(x, torch.ones((2, 8), device=cuda_device))
    x = x.detach()
    with pytest.raises(ValueError, match="multiples of 8"):
        gm.grouped_matmul_cuda(x[..., :12].contiguous(), w[:, :12].contiguous())
    with pytest.raises(ValueError, match="bucketed"):
        gm.grouped_matmul_cuda(x, w, torch.ones((2, 2), dtype=torch.int32,
                                                device=cuda_device))
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        cr.combine_reduce_cuda(x.half(), torch.ones((2, 8), device=cuda_device))
    q, k, v, tables, posv = _paged_case(rng, cuda_device, (40, 3, 17, 0))
    with pytest.raises(ValueError, match="int32"):
        na.decode_attention_paged_cuda(q, k, v, tables.long(), posv)
    with pytest.raises(ValueError, match="head dim"):
        na.decode_attention_paged_cuda(q[..., :96].contiguous(),
                                       k[..., :96].contiguous(),
                                       v[..., :96].contiguous(), tables, posv)
    with pytest.raises(ValueError, match="query heads a kv head"):
        na.decode_attention_paged_cuda(q[:, :24].contiguous(), k, v, tables,
                                       posv)
    assert [c.launches for c in counters] == before


@pytest.mark.cuda
@pytest.mark.parametrize("over", [
    dict(wire_dtype="fp32"),
    dict(wire_dtype="fp8", replicas_per_expert=2, route_alpha=1.0),
], ids=["fp32", "fp8-replicas2"])
def test_cuda_serving_engine_launch_path(cuda_device, over):
    """The serving engine with its experts on the card: one
    ``grouped_swiglu`` kernel launch a launched expert of each layer (the
    executor's own count), no other kernel, and the same event clock,
    counters, latencies and KV statistics as the engine with its experts on
    the CPU; each step's last-layer outputs within 2e-2 of their range
    (bf16 weights on the card, fp32 on the CPU)."""
    from repro_torch.serving import (EngineConfig, ServingEngine,
                                     poisson_arrivals)
    cfg = EngineConfig(n_layers=2, n_experts=8, top_k=2, d_model=128,
                       d_ff=96, ep_degree=4, token_budget=16,
                       prefill_chunk=8, block_size=8, n_blocks=64,
                       nonmoe_us=10.0, **over)
    reqs = poisson_arrivals(100_000.0, 8, seed=13, prompt_len=(1, 20),
                            gen_len=(1, 8))
    got = {}
    for where in ("cpu", "cuda"):
        eng = ServingEngine(cfg, device=where)
        eng.submit_all(reqs)
        outs, per_step = [], []
        before = ops.launch_counts()
        while True:
            n0 = ops.launch_counts()["grouped_swiglu"]
            if not eng.step():
                break
            outs.append(eng.last_outs[-1].copy())
            per_step.append((ops.launch_counts()["grouped_swiglu"] - n0,
                             len(eng.backend.last_world.timeline[
                                 "compute_start_us"])))
        launched = {n: k - before[n] for n, k in ops.launch_counts().items()}
        got[where] = eng, outs, per_step, launched
    cpu, card = got["cpu"], got["cuda"]
    assert card[0]._wg.dtype == torch.bfloat16 and card[0]._wg.is_cuda
    s_cpu, s_card = cpu[0].stats(), card[0].stats()
    assert s_cpu == s_card and s_card["sched_completed"] == 8
    assert all(k == 0 for k in cpu[3].values())
    assert all(n == e > 0 for n, e in card[2])
    assert card[3]["grouped_swiglu"] == sum(e for _, e in card[2])
    assert {n for n, k in card[3].items() if k} == {"grouped_swiglu"}
    for a, b in zip(cpu[1], card[1]):
        assert np.isfinite(b).all()
        assert np.abs(a - b).max() <= 2e-2 * np.abs(a).max()


# ---- repro_torch.tracing on the card ---------------------------------------
@pytest.mark.cuda
def test_cuda_tracing_span_device_interval_matches_events(cuda_device,
                                                          monkeypatch):
    """A span's device interval around a run of matmuls agrees with CUDA
    events recorded around the span, within 10%."""
    from repro_torch import tracing
    monkeypatch.setattr(tracing, "SAMPLE", 1)      # time every span
    tracing.reset()
    a = torch.randn(4096, 4096, device=cuda_device, dtype=torch.bfloat16)
    for _ in range(3):
        a @ a
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    with tracing.span("tracing.matmul"):
        for _ in range(50):
            a @ a
    e1.record()
    torch.cuda.synchronize()
    ref = e0.elapsed_time(e1)
    got = tracing.snapshot()["spans"]["tracing.matmul"]["unprofiled"]
    tracing.reset()
    assert got["count"] == got["device_count"] == 1
    assert abs(got["device_ms"] - ref) <= 0.1 * ref, (got, ref)


@pytest.mark.cuda
def test_cuda_tracing_capture_adds_no_node(cuda_device):
    """Code that opens spans, captured under ``tracing.suspended()``,
    gives a graph of as many nodes, of each kind, as the same code without
    spans, and records nothing."""
    import contextlib

    from repro_torch import tracing
    x = torch.randn(256, 256, device=cuda_device)

    def body(traced):
        sp = tracing.span if traced else (
            lambda name: contextlib.nullcontext())
        with sp("tracing.outer"):
            y = x @ x
            with sp("tracing.inner"):
                y = y + 1
            return y.sum()
    nodes = []
    for traced in (False, True):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body(traced)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        tracing.reset()
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with tracing.suspended(), torch.cuda.graph(g):
            body(traced)
        assert tracing.snapshot()["spans"] == {}
        nodes.append(tracing.graph_nodes(g.raw_cuda_graph()))
        g.instantiate()
        g.replay()
        torch.cuda.synchronize()
    assert nodes[0] == nodes[1] and nodes[0]["kernel"] >= 2, nodes


@pytest.mark.cuda
def test_cuda_tracing_capture_decode_step_counts_its_graph(cuda_device,
                                                           monkeypatch):
    """``capture_decode_step`` sets the gauge ``serve.graph_nodes`` (the
    total of the kinds), and each replay records ``serve.step`` and
    ``serve.graph_launch``, the sampled ones with their device
    intervals."""
    from repro_torch import tracing
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.distributed.sharding import make_dist_ctx
    from repro_torch.launch import serve
    from repro_torch.models import model_zoo as Z
    cfg = reduced_config(get_config("qwen2_moe_a2_7b"), n_layers=2,
                         d_model=512, vocab=512)
    dist = make_dist_ctx(cfg, model=2)
    params = Z.init_params(cfg, seed=0, device=cuda_device,
                           dtype=Z.compute_dtype(cfg))
    cache = Z.init_cache(cfg, 4, 16, dtype=Z.compute_dtype(cfg),
                         device=cuda_device)
    tok = torch.zeros((4, 1), dtype=torch.int64, device=cuda_device)
    monkeypatch.setattr(tracing, "SAMPLE", 2)
    tracing.reset()
    with torch.inference_mode():
        step, _ = serve.capture_decode_step(cfg, params, cache, tok,
                                            dist=dist)
        for t in range(3):
            step(tok, t)
    snap = tracing.snapshot()
    tracing.reset()
    g = snap["gauges"]
    kinds = sum(g[f"serve.graph_nodes.{k}"]
                for k in ("kernel", "memcpy", "memset", "other"))
    assert g["serve.graph_nodes"] == kinds and g[
        "serve.graph_nodes.kernel"] > 0
    for p in ("serve.step", "serve.step/serve.graph_launch"):
        b = snap["spans"][p]["unprofiled"]
        assert b["count"] == 3 and b["device_count"] == 1     # the 2nd
    # the warm-up steps ran eagerly (every layer an MoE layer); the
    # capture recorded nothing
    assert snap["spans"]["ep.plan"]["unprofiled"]["count"] == (
        serve.WARMUP_STEPS * cfg.n_layers)


@pytest.mark.cuda
def test_cuda_tracing_train_step_records_every_phase(cuda_device,
                                                     monkeypatch):
    """A reduced qwen2-moe train step over an EP world of 2 (HT) on the
    card: every train span, and the MoE layer's spans under the forward
    and under the backward's recompute (autograd's device thread), each
    with a device interval."""
    from repro_torch import tracing
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.distributed.sharding import make_dist_ctx
    T = importlib.import_module("repro_torch.training.train_loop")
    cfg, _, hp = _ep_train_setup(cuda_device, "ht", "fp32")
    state = T.init_state(cfg, seed=0, device=cuda_device)
    batch = synth_batch(DataConfig(vocab_size=cfg.vocab_size, batch=2,
                                   seq_len=32, seed=1), 0)
    monkeypatch.setattr(tracing, "SAMPLE", 1)
    tracing.reset()
    T.train_step(cfg, hp, make_dist_ctx(cfg, model=2), state, batch)
    spans = tracing.snapshot()["spans"]
    tracing.reset()
    want = {"train.step", "train.step/train.forward",
            "train.step/train.backward", "train.step/train.optimizer",
            "train.step/train.router_bias",
            "train.step/train.forward/moe.shared"}
    for phase in ("forward", "backward"):
        want |= {f"train.step/train.{phase}/{n}" for n in (
            "moe.route", "ep.plan", "ep.dispatch", "ep.experts",
            "ep.combine")}
    assert want <= set(spans), sorted(want - set(spans))
    for p in want:
        b = spans[p]["unprofiled"]
        assert b["count"] == b["device_count"] > 0 and b["device_ms"] > 0, p


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,pos", [
    (128, 1024, 0),        # the cell's first position: one live row
    (128, 1024, 63),       # one whole tile
    (128, 1024, 64),       # a tile and one row
    (128, 1024, 700),      # mid-cycle, a ragged last tile
    (128, 1024, 1023),     # the cell's last position
    (4, 288, 0),           # a small batch: the sequence cut into chunks
    (4, 288, 130),
    (4, 288, 287),
    (3, 100, 99),          # S no multiple of a tile
    (2, 500, 499),
])
def test_cuda_mla_decode_matches_plain(cuda_device, B, S, pos):
    """The absorbed-MLA decode kernel against its plain version at
    Moonlight's widths (16 heads, rows of 576, values of 512): one block a
    sequence (B 128) and chunks merged by the last block (small B)."""
    from repro_torch.kernels import mla
    rng = np.random.default_rng(B * 7 + S + pos)
    q = _bf16(rng, (B, 16, 576), cuda_device)
    cache = _bf16(rng, (B, S, 576), cuda_device)
    scale = 192 ** -0.5
    got = mla.mla_decode_cuda(q, cache, _pos(pos, cuda_device), scale=scale,
                              v_dim=512).float()
    ref = mla.mla_decode_plain(q, cache, pos, scale=scale, v_dim=512).float()
    # P rounds to bf16 on both sides before the product; sums in another
    # order; one bf16 rounding of the output
    torch.testing.assert_close(got, ref, rtol=2e-2, atol=2e-2)
    # rows past pos are never read: NaN there changes nothing, and the
    # arrival counters were set back, so a second launch repeats the first
    cache[:, pos + 1:] = float("nan")
    again = mla.mla_decode_cuda(q, cache, _pos(pos, cuda_device),
                                scale=scale, v_dim=512).float()
    assert torch.equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S", [(128, 1024), (4, 288)])
def test_cuda_mla_decode_replays_at_new_positions(cuda_device, B, S):
    """One captured launch replayed at other positions gives what an eager
    launch at each gives: nothing of the launch depends on pos."""
    from repro_torch.kernels import mla
    rng = np.random.default_rng(S)
    q = _bf16(rng, (B, 16, 576), cuda_device)
    cache = _bf16(rng, (B, S, 576), cuda_device)
    pos = _pos(0, cuda_device)
    scale = 192 ** -0.5
    mla.mla_decode_cuda(q, cache, pos, scale=scale, v_dim=512)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = mla.mla_decode_cuda(q, cache, pos, scale=scale, v_dim=512)
    for p in (5, S // 2, S - 1):
        pos.fill_(p)
        graph.replay()
        eager = mla.mla_decode_cuda(q, cache, _pos(p, cuda_device),
                                    scale=scale, v_dim=512)
        assert torch.equal(out, eager), p


# --------------------------------- the LL exchange in the receive layout --
# the decode cells' exchanges: qwen2-moe (K 4, receive buffer (64, 128,
# 2048), fp32 wire) and Moonlight (K 6, (64, 192, 2048), fp8 wire); an EP
# world of 4 ranks of 128 tokens, 64 experts
LL_CELLS = {"qwen2moe": (4, 2.0, "fp32"), "moonlight": (6, 4.0, "fp8")}


def _ll_case(rng, cell, device, skew=0.0):
    """(spec, x (4, 128, 2048) bf16, top (4, 128, K), w (4, 128, K) fp32,
    C, the LL plan) from a seeded routing (Gumbel top-K over 64 experts,
    ``skew`` added to expert 0's logit so that it drops)."""
    from repro_torch.core import ep
    K, cf, wire = LL_CELLS[cell]
    E, R, T, D = 64, 4, 128, 2048
    spec = ep.EPSpec(axes=("model",), sizes=(R,), n_experts=E, top_k=K,
                     capacity_factor=cf, dtype=torch.bfloat16, mode="ll",
                     wire_dtype=wire)
    g = rng.gumbel(size=(R * T, E))
    g[:, 0] += skew
    ti = np.argsort(-g, axis=1)[:, :K].astype(np.int32)
    tw = rng.random((R * T, K)).astype(np.float32)
    tw /= tw.sum(-1, keepdims=True)
    x = _bf16(rng, (R, T, D), device)
    top = torch.from_numpy(ti).to(device).reshape(R, T, K)
    w = torch.from_numpy(tw).to(device).reshape(R, T, K)
    C = ep._cap(T * K / E, cf, hard_max=T * K)
    return spec, x, top, w, C, ep._ll_plan(spec, top, C)


def _bf16_ulp_close(got, want):
    """Within one bf16 rounding of each other: the same fp32 products,
    summed over K in k order here and in the reduction's own order there
    (a few fp32 ulps of the terms apart, which a sum that cancels to near
    zero magnifies: the 1e-5 of the largest), rounded once to bf16."""
    g, r = got.float(), want.float()
    assert torch.isfinite(g).all()
    bad = (g - r).abs() > 2.0 ** -7 * r.abs() + 1e-5 * r.abs().max()
    assert not bad.any(), (int(bad.sum()), float((g - r).abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(LL_CELLS))
def test_cuda_gather_rows_matches_plain(cuda_device, cell):
    """The row gather into the receive layout at the cells' shapes,
    bit for bit its plain version, into an output that starts as NaN:
    zeros at and past every count; its weighted form too; one launch a
    call."""
    from repro_torch.kernels import gather_rows as gr
    rng = np.random.default_rng(370)
    _, x, _, _, C, pl = _ll_case(rng, cell, cuda_device, skew=3.0)
    table = x.reshape(-1, x.shape[-1])
    counts = pl.cnt_recv.reshape(-1)
    n = pl.src_recv.shape[0]
    before = gr.gather_rows_cuda.launches
    _poisoned_allocation((n, table.shape[1]), torch.bfloat16, cuda_device)
    got = gr.gather_rows_cuda(table, pl.src_recv, counts)
    assert gr.gather_rows_cuda.launches == before + 1
    assert torch.equal(got.view(torch.int16),
                       gr.gather_rows_plain(table, pl.src_recv,
                                            counts).view(torch.int16))
    live = gr.live_rows(pl.src_recv, counts, table.shape[0])
    assert (got[~live] == 0).all() and (~live).any() and live.any()
    w = torch.rand(n, device=cuda_device) * 3 - 1
    _poisoned_allocation((n, table.shape[1]), torch.bfloat16, cuda_device)
    got = gr.gather_rows_cuda(table, pl.src_recv, counts, w)
    assert torch.equal(got.view(torch.int16),
                       gr.gather_rows_plain(table, pl.src_recv, counts,
                                            w).view(torch.int16))
    assert (got[~live] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 131),
                                     (torch.float32, 37),
                                     (torch.float32, 200),
                                     (torch.bfloat16, 8)])
def test_cuda_gather_rows_narrow_rows(cuda_device, dtype, D):
    """Rows whose bytes take 2-, 4- and 16-byte vectors, a table base off
    16 bytes, sources outside the table and no counts: zeros there."""
    from repro_torch.kernels import gather_rows as gr
    rng = np.random.default_rng(D)
    base = torch.from_numpy(rng.standard_normal((41 * D + 1,)).astype(
        np.float32)).to(cuda_device, dtype)
    table = base[1:].reshape(41, D)                  # a base 2 or 4 off
    src = torch.from_numpy(rng.integers(-3, 45, 96).astype(np.int32)).to(
        cuda_device)
    for counts in (None, torch.tensor([0, 5, 24, 30], dtype=torch.int32,
                                      device=cuda_device)):
        got = gr.gather_rows_cuda(table, src, counts)
        ref = gr.gather_rows_plain(table, src, counts)
        assert torch.equal(got, ref)
        assert (got[~gr.live_rows(src, counts, 41)] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["fp8", "int8"])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_cuda_dequantize_rows_matches_plain(cuda_device, wire, out_dtype):
    """``dequantize`` with counts over Moonlight's receive buffer (64, 192,
    2048) as ``gather_quantize`` writes it from the receive-order tables:
    bit for bit the plain version (the fp32 product rounded once to bf16),
    into an output that starts as NaN, zeros past every count; and the
    same rows as the fp32 dequantize followed by a cast."""
    from repro_torch.core import ep
    rng = np.random.default_rng(371)
    _, x, _, _, C, pl = _ll_case(rng, "moonlight", cuda_device, skew=2.0)
    counts = pl.cnt_recv.reshape(-1)
    q, s = qp.gather_quantize_cuda(ep._ext(x, torch.float32), pl.src_recv,
                                   counts, wire_dtype=wire)
    before = qp.dequantize_cuda.launches
    _poisoned_allocation(tuple(q.shape), out_dtype, cuda_device)
    got = qp.dequantize_cuda(q, s, counts, out_dtype)
    assert qp.dequantize_cuda.launches == before + 1
    bits = torch.int16 if out_dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), qp.dequantize_plain(
        q, s, counts, out_dtype).view(bits))
    assert torch.equal(got.view(bits), qp.dequantize_cuda(q, s).to(
        out_dtype).view(bits))
    occ = qp._occupied_slots(q, counts)
    assert (got[~occ] == 0).all() and (~occ).any()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(LL_CELLS))
@pytest.mark.parametrize("w_dtype,out_dtype", [
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)])
def test_cuda_combine_gathered_matches_plain(cuda_device, cell, w_dtype,
                                             out_dtype):
    """The gathered combine over the expert rows where they lie, at the
    cells' shapes with drops (-1 slots): bit for bit its plain version,
    and the (T, K, D) kernel on the gathered rows (a dropped choice's row
    zero); one launch a call."""
    rng = np.random.default_rng(372)
    _, x, _, w, C, pl = _ll_case(rng, cell, cuda_device, skew=3.0)
    sel = pl.sel_recv
    assert (sel < 0).any()
    rows = _bf16(rng, (pl.src_recv.shape[0], x.shape[-1]), cuda_device)
    wt = w.reshape(sel.shape).to(w_dtype)
    before = cr.combine_reduce_cuda.launches
    got = cr.combine_reduce_cuda(rows, wt, sel=sel, out_dtype=out_dtype)
    assert cr.combine_reduce_cuda.launches == before + 1
    bits = torch.int16 if out_dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), cr.combine_reduce_plain(
        rows, wt, sel, out_dtype).view(bits))
    parts = torch.where((sel >= 0)[..., None], rows[sel.long().clamp(min=0)],
                        0.0).to(torch.bfloat16)
    tkd = cr.combine_reduce_cuda(parts, wt).to(out_dtype)
    if out_dtype == torch.bfloat16:
        assert torch.equal(got.view(bits), tkd.view(bits))


@pytest.mark.cuda
def test_cuda_ll_functions_give_the_plain_gradients(cuda_device):
    """Under grad, ``ops`` takes the row gather's, the gathered combine's
    and the counted dequantize's autograd Functions: their backwards
    (the combine with unit weights; the weighted row gather and
    ``combine_dot``; ``dequantize_bwd`` on the rows below their counts)
    against autograd through the plain versions in fp32; each backward
    kernel launched."""
    from repro_torch.core import ep
    from repro_torch.kernels import gather_rows as gr
    rng = np.random.default_rng(373)
    _, x, _, w, C, pl = _ll_case(rng, "moonlight", cuda_device, skew=3.0)
    table = x.reshape(-1, x.shape[-1]).clone().requires_grad_(True)
    counts, sel = pl.cnt_recv.reshape(-1), pl.sel_recv
    g0, c0, b0 = (gr.gather_rows_cuda.launches,
                  cr.combine_reduce_cuda.launches,
                  cr.combine_reduce_bwd_cuda.launches)
    recv = ops.gather_rows(table, pl.src_recv, counts, sel=sel)
    dy = _bf16(rng, tuple(recv.shape), cuda_device)
    got = torch.autograd.grad(recv, table, dy)
    assert cr.combine_reduce_cuda.launches == c0 + 1
    ref = _autograd_plain(lambda t: gr.gather_rows_plain(
        t, pl.src_recv, counts), [table], (0,), dy)
    _bwd_close(got, ref)
    rows = _bf16(rng, tuple(recv.shape), cuda_device).requires_grad_(True)
    wt = w.reshape(sel.shape).clone().requires_grad_(True)
    out = ops.combine_reduce(rows, wt, sel=sel, out_dtype=torch.bfloat16)
    dout = _bf16(rng, tuple(out.shape), cuda_device)
    got = torch.autograd.grad(out, [rows, wt], dout)
    assert cr.combine_reduce_bwd_cuda.launches == b0 + 1
    assert gr.gather_rows_cuda.launches == g0 + 2
    ref = _autograd_plain(lambda r, v: cr.combine_reduce_plain(
        r, v, sel, torch.float32), [rows, wt], (0, 1), dout)
    _bwd_close(got, ref)
    assert (got[0][gr.live_rows(pl.src_recv, counts, table.shape[0])
                   .logical_not()] == 0).all()
    q, s = qp.gather_quantize_cuda(ep._ext(x, torch.float32), pl.src_recv,
                                   counts, wire_dtype="fp8")
    s = s.requires_grad_(True)
    d0 = qp.dequantize_bwd_cuda.launches
    deq = ops.dequantize_tokens(q, s, counts, torch.bfloat16)
    dy = _bf16(rng, tuple(deq.shape), cuda_device)
    got = torch.autograd.grad(deq, s, dy)
    assert qp.dequantize_bwd_cuda.launches == d0 + 1
    ref = _autograd_plain(lambda qq, v: qp.dequantize_plain(
        qq, v, counts, torch.float32), [q, s], (1,), dy)
    _bwd_close(got, ref, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(LL_CELLS))
def test_cuda_ll_exchange_matches_the_all_to_all(cuda_device, cell):
    """``dispatch_combine_ll`` on the card, eager and replayed from a
    captured graph, against the composition through the all-to-all
    (``chip_smoke.all_to_all_ll_exchange``) at
    the cells' shapes with drops: the expert kernel's input rows and
    counts bit for bit, the output within one bf16 rounding, the same
    statistics; a replay at new inputs equals an eager call on them bit
    for bit; the counter ``ep.ll_exchanges`` counts the eager calls and
    the capture, not the replays, and ``ep.ll_recv_rows`` reads E P C."""
    from repro_torch import tracing
    from repro_torch.core import ep
    from repro_torch.core.moe import expert_fn
    rng = np.random.default_rng(374)
    spec, x, top, w, C, pl = _ll_case(rng, cell, cuda_device, skew=3.0)
    assert (pl.valid & ~pl.keep).any()
    fn = expert_fn(*_bf16_weights(rng, 64, x.shape[-1], 256, cuda_device))
    seen = []

    def recording(tokens, counts):
        seen.append((tokens.clone(), counts.clone()))
        return fn(tokens, counts)
    tracing.reset()
    with torch.inference_mode():
        got = ep.dispatch_combine_ll(spec, x, top, w, recording)
        want, recv, cnt, _ = all_to_all_ll_exchange(spec, x, top, w,
                                                    recording)
    assert torch.equal(seen[0][0].view(torch.int16), recv.view(torch.int16))
    assert torch.equal(seen[0][1], cnt)
    _bf16_ulp_close(got.out, want)
    wp = ep.planlib.make_world_plan(top, spec.n_physical, C)
    assert torch.equal(got.aux["load_phys"], wp.counts.sum(0))
    snap = tracing.snapshot()
    assert snap["counters"]["ep.ll_exchanges"] == 1
    assert snap["gauges"]["ep.ll_recv_rows"] == 64 * 4 * C
    # captured once, replayed at other inputs
    sx, st, sw = x.clone(), top.clone(), w.clone()
    with torch.inference_mode():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            ep.dispatch_combine_ll(spec, sx, st, sw, fn)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            res = ep.dispatch_combine_ll(spec, sx, st, sw, fn)
        for seed in (375, 376):
            _, x2, t2, w2, _, _ = _ll_case(np.random.default_rng(seed), cell,
                                           cuda_device, skew=3.0)
            sx.copy_(x2), st.copy_(t2), sw.copy_(w2)
            graph.replay()
            eager = ep.dispatch_combine_ll(spec, x2, t2, w2, fn)
            torch.cuda.synchronize()
            assert torch.equal(res.out.view(torch.int16),
                               eager.out.view(torch.int16)), seed
            assert torch.equal(res.aux["dropped"], eager.aux["dropped"])
    assert tracing.snapshot()["counters"]["ep.ll_exchanges"] == 1 + 2 + 2
