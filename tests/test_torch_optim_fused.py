"""The optimizer's update: on the CPU ``apply_updates``' plain path
(``adamw_leaf``) against the eager chain it ran before the kernel, bit for
bit; on the card (marked ``cuda``, skipped without one) the hand-written
kernel (``kernels.optim.adamw_cuda``, ``csrc/adamw.cu``) against the plain
path.  This file imports no JAX, so
its card tests run where only the port is installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_optim_fused.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tracing  # noqa: E402
from repro_torch.kernels import optim as fused  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

# odd sizes against the 4-wide vectors, and a 0-d leaf
SHAPES = {"scalar": (), "one": (1,), "three": (3,), "odd": (2047,),
          "ragged": (4099,), "matrix": (24, 33)}
HYPER = {"b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1}
# the clip by each step's global gradient norm: engaged, not engaged, none
CLIPS = {"engaged": (1.0, 60.0), "loose": (1.0, 0.06), "none": (None, 60.0)}
STEPS = 3


def _inputs(shapes, norm, seed=0):
    """Parameters, and ``STEPS`` gradient trees each of global norm
    ``norm``."""
    rng = np.random.default_rng(seed)

    def draw(s):
        return torch.from_numpy(np.asarray(rng.standard_normal(s),
                                           dtype=np.float32))
    params = {k: draw(s) for k, s in shapes.items()}
    grads = []
    for _ in range(STEPS):
        g = {k: draw(s) for k, s in shapes.items()}
        k = norm / float(adamw.global_norm(g))
        grads.append({n: t * k for n, t in g.items()})
    return params, grads


def _chain_step(params, grads, mu, nu, step, *, lr, b1, b2, eps,
                weight_decay, max_grad_norm):
    """``apply_updates``' non-factored update as it was before the kernel,
    kept here verbatim as the plain path's reference."""
    stepf = torch.tensor(step, dtype=torch.float32)
    gnorm = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2)
                           for g in grads.values()))
    scale = None
    if max_grad_norm is not None:
        scale = torch.clamp(max_grad_norm / (gnorm + 1e-9), max=1.0)
    c1 = 1.0 - b1 ** stepf
    c2 = 1.0 - b2 ** stepf
    for k, p in params.items():
        g = grads[k].to(torch.float32)
        if scale is not None:
            g = g * scale
        mu[k].mul_(b1).add_(g, alpha=1 - b1)
        nu[k].mul_(b2).addcmul_(g, g, value=1 - b2)
        u = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
        p.sub_(lr * (u + weight_decay * p))
    return gnorm


def _plain(p, g, mu, nu, *, max_grad_norm, **hyper):
    """``apply_updates``' plain path over lists of leaves: the global norm,
    the clip scale, ``adamw_leaf`` a leaf; the norm."""
    gnorm = adamw.global_norm(list(g))
    scale = None
    if max_grad_norm is not None:
        scale = torch.clamp(max_grad_norm / (gnorm + 1e-9), max=1.0)
    for quad in zip(p, g, mu, nu):
        adamw.adamw_leaf(*quad, scale, **hyper)
    return gnorm


def _fused_leaves():
    return tracing.snapshot()["counters"].get("optim.fused_leaves", 0)


@pytest.mark.parametrize("lr_kind", ["tensor", "float"])
@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_plain_path_matches_chain(clip, lr_kind):
    """Three steps of ``apply_updates`` on CPU leaves (the plain path)
    equal the chain it ran before the kernel, bit for bit, and leave the
    counter ``optim.fused_leaves`` where it was."""
    max_grad_norm, norm = CLIPS[clip]
    params, grads = _inputs(SHAPES, norm)
    ref = {k: v.clone() for k, v in params.items()}
    ref_mu = {k: torch.zeros_like(v) for k, v in params.items()}
    ref_nu = {k: torch.zeros_like(v) for k, v in params.items()}
    state = adamw.init_state(params)
    lr = torch.tensor(1e-2) if lr_kind == "tensor" else 1e-2
    before = _fused_leaves()
    for i, g in enumerate(grads):
        params, state, m = adamw.apply_updates(
            params, g, state, lr=lr, max_grad_norm=max_grad_norm, **HYPER)
        want = _chain_step(ref, g, ref_mu, ref_nu, i + 1, lr=lr,
                           max_grad_norm=max_grad_norm, **HYPER)
        assert torch.equal(m["grad_norm"], want)
    if clip == "engaged":
        assert float(want) > 1.0
    elif clip == "loose":
        assert float(want) < 1.0
    assert int(state.step) == STEPS
    for k in SHAPES:
        for got, exp in ((params[k], ref[k]), (state.mu[k], ref_mu[k]),
                         (state.nu[k], ref_nu[k])):
            assert got.shape == SHAPES[k]
            assert torch.equal(got, exp), k
    assert _fused_leaves() == before


def test_factored_and_cpu_take_no_kernel():
    """The factored update keeps its own chain, and no CPU leaf reaches
    the kernel: the counter stays, and the kernel refuses CPU leaves."""
    params, grads = _inputs({"w": (128, 160), "b": (160,)}, 60.0)
    state = adamw.init_state(params, factored=True)
    before = _fused_leaves()
    params, state, _ = adamw.apply_updates(params, grads[0], state,
                                           lr=1e-2, factored=True)
    assert set(state.nu["w"]) == {"row", "col"}
    assert _fused_leaves() == before
    leaves = [params["b"]]
    with pytest.raises(ValueError, match="not a CUDA device"):
        fused.adamw_cuda(leaves, leaves, leaves, leaves, lr=1e-2, c1=0.1,
                         c2=0.05, max_grad_norm=1.0, **HYPER)


@pytest.mark.parametrize("n,blocks", [(1, 1), (1024, 1), (1025, 2),
                                      (2 ** 20, 1024), (2 ** 24 + 5, 1024),
                                      (0, 0)])
def test_norm_blocks(n, blocks):
    """The norm's partials a leaf depend on its size alone."""
    assert fused.norm_blocks(n) == blocks


# ------------------------------------------------------------ the card --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


# the card's cases add a leaf past 2^24 elements and a leaf whose base is
# 16-byte aligned but whose size is not a multiple of 4 ("ragged")
CUDA_SHAPES = {**SHAPES, "large": (2 ** 24 + 5,)}


def _card_steps(fn, leaves, grads, max_grad_norm):
    """``STEPS`` steps of ``fn`` (``adamw_cuda`` or ``_plain``) over
    ``leaves`` (p, mu, nu lists) with the bias corrections computed on the
    host as ``apply_updates`` computes them; the norms."""
    p, mu, nu = leaves
    norms = []
    for i, g in enumerate(grads):
        stepf = torch.tensor(i + 1, dtype=torch.float32)
        norms.append(fn(p, g, mu, nu, lr=torch.tensor(1e-2),
                        c1=1.0 - HYPER["b1"] ** stepf,
                        c2=1.0 - HYPER["b2"] ** stepf,
                        max_grad_norm=max_grad_norm, **HYPER))
    return norms


def _card_inputs(shapes, norm, dev, misaligned=False):
    params, grads = _inputs(shapes, norm)
    names = list(shapes)

    def put(t):
        if not misaligned:
            return t.to(dev).contiguous()
        # contiguous, but 4 bytes past a 16-byte boundary
        buf = torch.empty(t.numel() + 1, dtype=torch.float32, device=dev)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out
    p = [put(params[k]) for k in names]
    g = [[put(gs[k]) for k in names] for gs in grads]
    return p, g


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_cuda_adamw_matches_plain(cuda_device, clip, misaligned):
    """The kernel against the plain path on the card over three steps:
    p, mu and nu within rtol 1e-6 (the kernel contracts products into
    FMAs and sums the norm in fp64, where the chain rounds each operation
    and the card's division by a CPU scalar multiplies by its reciprocal),
    with an absolute floor of 1e-6 of the tensor's largest value (where
    b1 mu and (1 - b1) g nearly cancel, one rounding of either is large
    against their sum); the norm within 1e-6 of ``vector_norm`` over the
    concatenated gradients; the same bits on a second run; the launches
    and the counter."""
    max_grad_norm, norm = CLIPS[clip]
    p, g = _card_inputs(CUDA_SHAPES, norm, cuda_device, misaligned)
    # misaligned gradients send every leaf's update to the scalar loads
    assert all((t.data_ptr() % 16 != 0) == misaligned for t in g[0])
    nonempty = sum(t.numel() > 0 for t in p)

    def fresh():
        return ([t.clone() for t in p], [torch.zeros_like(t) for t in p],
                [torch.zeros_like(t) for t in p])
    plain = fresh()
    want = _card_steps(_plain, plain, g, max_grad_norm)
    runs = []
    for _ in range(2):
        launches, counted = fused.adamw_cuda.launches, _fused_leaves()
        leaves = fresh()
        norms = _card_steps(fused.adamw_cuda, leaves, g, max_grad_norm)
        torch.cuda.synchronize()
        assert fused.adamw_cuda.launches - launches == STEPS * (
            2 * nonempty + 1)
        assert _fused_leaves() - counted == STEPS * len(p)
        runs.append((leaves, norms))
    (got, norms), (again, norms2) = runs
    for a, b in zip(got, again):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert all(torch.equal(x, y) for x, y in zip(norms, norms2))
    for i, gs in enumerate(g):
        exact = torch.linalg.vector_norm(torch.cat(
            [t.reshape(-1) for t in gs]).double())
        assert norms[i].device.type == "cuda"
        assert abs(float(norms[i]) - float(exact)) <= 1e-6 * float(exact)
        assert abs(float(want[i]) - norm) <= 1e-4 * norm
    for what, a, b in zip(("p", "mu", "nu"), got, plain):
        for k, x, y in zip(CUDA_SHAPES, a, b):
            torch.testing.assert_close(
                x, y, rtol=1e-6, atol=1e-6 * float(y.abs().max()),
                msg=lambda m: f"{what} {k}: {m}")


@pytest.mark.cuda
def test_cuda_adamw_refuses(cuda_device):
    """A non-contiguous leaf, a leaf in another dtype and a learning rate
    on the card raise instead of launching or waiting."""
    p = torch.zeros((8, 6), device=cuda_device)
    ok = [p, torch.ones_like(p), torch.zeros_like(p), torch.zeros_like(p)]
    kw = dict(c1=0.1, c2=0.05, max_grad_norm=1.0, **HYPER)
    with pytest.raises(ValueError, match="contiguous"):
        fused.adamw_cuda([p.t()], [ok[1].t()], [ok[2].t()], [ok[3].t()],
                         lr=1e-2, **kw)
    with pytest.raises(ValueError, match="float32"):
        fused.adamw_cuda([p], [ok[1].bfloat16()], [ok[2]], [ok[3]], lr=1e-2,
                         **kw)
    with pytest.raises(ValueError, match="lr"):
        fused.adamw_cuda(*([t] for t in ok),
                         lr=torch.tensor(1e-2, device=cuda_device), **kw)


@pytest.mark.cuda
def test_cuda_apply_updates_takes_the_kernel(cuda_device):
    """``apply_updates`` sends non-factored CUDA leaves to the kernel (every
    leaf counted, its launches made) and the factored update to its
    chain; the norm stays on the card."""
    params, grads = _inputs(SHAPES, 60.0)
    params = {k: v.to(cuda_device).requires_grad_(True)
              for k, v in params.items()}
    g = {k: v.to(cuda_device) for k, v in grads[0].items()}
    launches, counted = fused.adamw_cuda.launches, _fused_leaves()
    params, state, m = adamw.apply_updates(params, g, adamw.init_state(params),
                                           lr=torch.tensor(1e-2))
    assert _fused_leaves() - counted == len(SHAPES)
    assert fused.adamw_cuda.launches - launches == 2 * len(SHAPES) + 1
    assert m["grad_norm"].device.type == "cuda"
    counted = _fused_leaves()
    adamw.apply_updates(params, g, adamw.init_state(params, factored=True),
                        lr=torch.tensor(1e-2), factored=True)
    assert _fused_leaves() == counted
