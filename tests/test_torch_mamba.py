"""The port's Mamba-1 scan and layer against the reference, on the same
numpy inputs: the plain scan (the CPU path, and the oracle of the CUDA
kernels) against ``mamba_scan_pallas(interpret=True)`` and the jnp oracle
``mamba_scan_ref``; autograd through it against ``jax.grad`` of the
oracle; ``mamba_apply`` against the reference's with parameters converted
by ``params_from_jax``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.kernels.mamba_scan import mamba_scan_pallas  # noqa: E402
from repro.kernels.ref import mamba_scan_ref  # noqa: E402
from repro.models import mamba as JM  # noqa: E402
from repro.models import model_zoo as JZ  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import mamba as TM  # noqa: E402
from repro_torch.models import model_zoo as Z  # noqa: E402

# fp32 on every side; the C . h contraction and the products sum in
# another order, so results agree to a few ulps of the output range
RTOL, ATOL = 1e-5, 1e-5

# (Bt, S, Di, N, bd, chunk): S not a multiple of the Pallas chunk, Di not
# a multiple of its channel block, a d_state other than 16
SCAN_CASES = [(2, 16, 32, 16, 512, 128), (2, 20, 48, 16, 32, 8),
              (1, 13, 40, 8, 16, 4)]


def _scan_inputs(rng, Bt, S, Di, N):
    f = np.float32
    return (rng.standard_normal((Bt, S, Di)).astype(f),
            rng.uniform(1e-3, 0.5, (Bt, S, Di)).astype(f),
            -np.exp(rng.standard_normal((Di, N))).astype(f),
            rng.standard_normal((Bt, S, N)).astype(f),
            rng.standard_normal((Bt, S, N)).astype(f),
            rng.standard_normal((Di,)).astype(f))


@pytest.mark.parametrize("case", SCAN_CASES, ids=lambda c: "x".join(map(str, c)))
def test_plain_scan_matches_pallas_and_ref(case):
    Bt, S, Di, N, bd, chunk = case
    ins = _scan_inputs(np.random.default_rng(Di), Bt, S, Di, N)
    got = ms.mamba_scan_plain(*map(torch.from_numpy, ins)).numpy()
    pallas = np.asarray(mamba_scan_pallas(*ins, bd=bd, chunk=chunk,
                                          interpret=True))
    ref = np.asarray(mamba_scan_ref(*ins))
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", SCAN_CASES[1:], ids=lambda c: "x".join(map(str, c)))
def test_plain_scan_grads_match_jax(case):
    """All six gradients of the scan: autograd through the plain version
    (what the CUDA backward kernel is held to) against jax.grad."""
    Bt, S, Di, N, _, _ = case
    rng = np.random.default_rng(S)
    ins = _scan_inputs(rng, Bt, S, Di, N)
    dy = rng.standard_normal((Bt, S, Di)).astype(np.float32)
    ref = jax.grad(lambda *a: jnp.sum(mamba_scan_ref(*a) * dy),
                   argnums=tuple(range(6)))(*ins)
    got = ms.mamba_scan_bwd_plain(*map(torch.from_numpy, ins), None,
                                  torch.from_numpy(dy))
    for name, g, r in zip(("x", "dt", "A", "B", "C", "D"), got, ref):
        # dA and dD sum over batch and time: compare against their range
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(r).max()),
                                   err_msg=name)


@pytest.mark.parametrize("Bt,S,Di", [(2, 20, 48), (1, 16, 8), (3, 1, 5),
                                     (1, 33, 12)])
def test_plain_scan_states_match_jax(Bt, S, Di):
    """The chunk states the plain scan returns (what the forward kernel's
    saved states are held to on the card): the state before step 8 c,
    against the jnp oracle's h at t = 8 c - 1, read out of its y with
    D = 0 and C one-hot in each state n."""
    N = 16
    x, dt, A, B, _, D = _scan_inputs(np.random.default_rng(S + Di), Bt, S,
                                     Di, N)
    y, states = ms.mamba_scan_plain(*map(torch.from_numpy,
                                         (x, dt, A, B, B, D)),
                                    with_states=True)
    assert states.shape == (Bt, ms.n_chunks(S), Di, N)
    assert torch.equal(y, ms.mamba_scan_plain(*map(torch.from_numpy,
                                                   (x, dt, A, B, B, D))))
    assert (states[:, 0] == 0).all()
    zero_d = np.zeros_like(D)
    h = np.stack([np.asarray(mamba_scan_ref(
        x, dt, A, B, np.broadcast_to(np.eye(N, dtype=np.float32)[n],
                                     (Bt, S, N)), zero_d))
        for n in range(N)], -1)                             # (Bt, S, Di, N)
    for c in range(1, ms.n_chunks(S)):
        np.testing.assert_allclose(states[:, c].numpy(),
                                   h[:, ms.SCAN_CHUNK * c - 1],
                                   rtol=RTOL, atol=ATOL, err_msg=f"chunk {c}")


def test_ops_mamba_scan_cpu_takes_plain():
    """A CPU tensor takes the plain version (differentiable), launching
    nothing."""
    ins = [torch.from_numpy(a).requires_grad_(True) for a in
           _scan_inputs(np.random.default_rng(0), 1, 9, 12, 16)]
    f0, b0 = ms.mamba_scan_cuda.launches, ms.mamba_scan_bwd_cuda.launches
    y = ops.mamba_scan(*ins)
    y.sum().backward()
    assert all(t.grad is not None for t in ins)
    torch.testing.assert_close(y, ms.mamba_scan_plain(*ins), rtol=0, atol=0)
    assert (ms.mamba_scan_cuda.launches, ms.mamba_scan_bwd_cuda.launches) \
        == (f0, b0)


def test_scan_cuda_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch their kernel or raise: on CPU tensors they
    raise before touching the kernel library and count no launch."""
    ins = [torch.from_numpy(a) for a in
           _scan_inputs(np.random.default_rng(0), 1, 9, 12, 16)]
    f0, b0 = ms.mamba_scan_cuda.launches, ms.mamba_scan_bwd_cuda.launches
    with pytest.raises(ValueError):
        ms.mamba_scan_cuda(*ins)
    states = torch.zeros((1, ms.n_chunks(9), 12, 16))
    with pytest.raises(ValueError):
        ms.mamba_scan_bwd_cuda(*ins, states, torch.zeros(1, 9, 12))
    assert (ms.mamba_scan_cuda.launches, ms.mamba_scan_bwd_cuda.launches) \
        == (f0, b0)


def _cfgs(dtype="float32"):
    kw = dict(n_layers=2, d_model=64, vocab=512)
    return (dataclasses.replace(jreduced(jget_config("falcon_mamba_7b"), **kw),
                                dtype=dtype),
            dataclasses.replace(reduced_config(get_config("falcon_mamba_7b"),
                                               **kw), dtype=dtype))


def _layer_params(jcfg, cfg, seed=3):
    """Layer 1's Mamba parameters from the reference's ``init_params``, on
    both sides (the JAX tree stacks layer i of a period-1 stack at index i
    of slot 0), each cast to the compute dtype by its own ``cast_params``,
    as ``loss_fn`` casts them."""
    jp = JZ.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    jmp = jax.tree.map(lambda a: a[1], jp["blocks"]["slot0"])["mamba"]
    jmp = JZ.cast_params({"mamba": jmp}, jnp.dtype(jcfg.dtype))["mamba"]
    p = Z.cast_params({"mamba": tp["blocks"][1]["mamba"]},
                      getattr(torch, cfg.dtype))["mamba"]
    assert set(p) == set(jmp)
    return jmp, p


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# bf16 keeps 8 significant bits: an ulp at the top of a tensor's range is
# 2^-7 of the range.  The port and the reference round in different places
# inside an op (torch's silu rounds once, XLA's x * sigmoid(x) twice), so a
# layer's outputs and gradients land a few ulps apart; 4 ulps of the range.
# Two such bf16 computations lie as far apart as bf16 lies from fp32, so
# no tolerance can tell a port that computes in fp32 from one in bf16:
# the bf16 tests also check where the values were rounded (_bf16_exact)
BF16_TOL = 2.0 ** -5


def record_scan(monkeypatch) -> list:
    """Wraps ``ops.mamba_scan``: the list it returns gains each call's
    six inputs."""
    calls, real = [], ops.mamba_scan

    def rec(*args):
        calls.append([a.detach().clone() for a in args])
        return real(*args)
    monkeypatch.setattr(ops, "mamba_scan", rec)
    return calls


def bf16_exact(t) -> bool:
    """Whether an fp32 tensor holds only bf16 values: it was computed in
    bf16 and cast up (computed in fp32, almost no element would be)."""
    return bool(torch.equal(t, t.to(torch.bfloat16).float()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_apply_matches_jax(dtype, monkeypatch):
    """``mamba_apply`` and its gradients (to x and to every parameter as
    the layer receives it, cast to the compute dtype) against the
    reference's.  fp32: a few fp32 ulps.  bf16: the output comes back in
    bf16, within ``BF16_TOL`` of the range, and the scan in between takes
    fp32 (``ops.mamba_scan`` refuses anything else on either device) whose
    x, B and C were computed in bf16, as the reference computes them."""
    jcfg, cfg = _cfgs(dtype)
    jmp, p = _layer_params(jcfg, cfg)
    x = np.random.default_rng(1).standard_normal((2, 24, 64)).astype(np.float32)
    jx = jnp.asarray(x, jcfg.dtype)
    ref, vjp = jax.vjp(lambda pp, xx: JM.mamba_apply(jcfg, pp, xx), jmp, jx)
    ct = np.random.default_rng(2).standard_normal(ref.shape).astype(np.float32)
    ref_gp, ref_gx = vjp(jnp.asarray(ct, ref.dtype))
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    calls = record_scan(monkeypatch)
    got = TM.mamba_apply(cfg, leaves, xt)
    assert got.dtype == xt.dtype and len(calls) == 1
    if dtype == "bfloat16":
        sx, _, _, sB, sC, _ = calls[0]
        assert bf16_exact(sx) and bf16_exact(sB) and bf16_exact(sC)
    got.backward(torch.from_numpy(ct).to(got.dtype))
    pairs = [("y", got, ref), ("dx", xt.grad, ref_gx)]
    pairs += [(k, v.grad, ref_gp[k]) for k, v in leaves.items()]
    for name, g, r in pairs:
        r = _f32(r)
        scale = max(float(np.abs(r).max()), 1e-30)
        g = g.detach().float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5 * max(
                scale, 1.0), err_msg=name)
        else:
            err = float(np.abs(g - r).max())
            assert err <= BF16_TOL * scale, (name, err, scale)


def test_ssm_inputs_bf16_match_jax():
    """The scan's inputs in bf16 compute: on the same bf16 activations the
    port's ``_ssm_inputs`` gives fp32 A, B and C equal bit for bit to the
    reference's (a bf16 projection, then a cast), and step sizes from the
    fp32 ``dt_w`` projection within fp32 roundings.  Left in bf16, or
    projected in fp32, B and C would differ in most elements; a ``dt_w``
    projection in bf16 would move the step sizes by ~2^-9."""
    jcfg, cfg = _cfgs("bfloat16")
    jmp, p = _layer_params(jcfg, cfg)
    xc = np.random.default_rng(4).standard_normal((2, 24, 128)).astype(
        np.float32)
    ref = JM._ssm_inputs(jcfg, jmp, jnp.asarray(xc, jnp.bfloat16))
    got = TM._ssm_inputs(cfg, p, torch.from_numpy(xc).to(torch.bfloat16))
    for name, g, r in zip(("dts", "A", "B", "C"), got, ref):
        assert g.dtype == torch.float32 and r.dtype == jnp.float32, name
        if name == "dts":
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                       atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), name)


def test_ops_mamba_scan_refuses_non_fp32():
    """The CPU path refuses what the CUDA kernels refuse: an input that is
    not float32 (say, A from an ``A_log`` cast to bf16)."""
    ins = [torch.from_numpy(a) for a in
           _scan_inputs(np.random.default_rng(0), 1, 9, 12, 16)]
    ins[2] = ins[2].to(torch.bfloat16)
    with pytest.raises(ValueError, match="A must be float32"):
        ops.mamba_scan(*ins)


def test_mamba_init_layout_matches_jax():
    jcfg, cfg = _cfgs()
    ref = JM.mamba_init(jcfg, jax.random.PRNGKey(0))
    got = TM.mamba_init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert list(got) == list(ref)
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape, k
        assert got[k].dtype == torch.float32
    # the deterministic leaves agree (log rounds within an ulp); the
    # step-size bias lands in the softplus-inverse of [1e-3, 1e-1] on both
    np.testing.assert_allclose(got["A_log"].numpy(), np.asarray(ref["A_log"]),
                               rtol=2e-7, atol=0)
    np.testing.assert_array_equal(got["D"].numpy(), np.asarray(ref["D"]))
    dt0 = torch.nn.functional.softplus(got["dt_b"])
    assert float(dt0.min()) >= 1e-3 * 0.999 and float(dt0.max()) <= 1e-1 * 1.001
    assert TM.mamba_dims(cfg) == JM.mamba_dims(jcfg)
