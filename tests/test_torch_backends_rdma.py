"""The model seam of the ``simulated_rdma`` backend in the port:
``moe_apply`` through the host transport substrate against the
reference's (LL and HT; without an EP world, and with one, whose degree
the reference's rule gives without a mesh), within 1e-5 relative in fp32
and within ``MOE_TOL`` in bf16; its expert compute through
``ops.grouped_swiglu`` in both of the substrate's shapes; ``forward`` with
one session backend instance across its layers; ``generate`` with the
host backend (eager, and ``cuda_graph=True`` raises); and no fallback: an
unknown backend, and the host backend under autograd, raise."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.core import moe as jmoe  # noqa: E402
from repro.core.backend import get_backend as jget_backend  # noqa: E402
from repro.models import model_zoo as JZ  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import moe as tmoe  # noqa: E402
from repro_torch.core.backend import (SimulatedRDMABackend,  # noqa: E402
                                      TorchCollectivesBackend,
                                      available_backends, get_backend)
from repro_torch.distributed.sharding import make_dist_ctx  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model_zoo as Z  # noqa: E402

pytestmark = pytest.mark.timeout(120)

# fp32: the experts' sums run in another order (numpy einsum against
# torch matmul); bf16: chip_smoke's MOE_TOL, the port's experts rounding
# h and y to bf16 where the reference computes them in fp32
FP32_RTOL = 1e-5
MOE_TOL = {"fp32": 2e-2, "fp8": 0.2, "int8": 0.05}


def _cfgs(dtype="float32", wire="fp32", n_layers=2, backend=None):
    """(reference, port) reduced qwen2-moe: 8 experts padded to 16, top 2,
    d_model 64, a shared expert."""
    out = []
    for get, red in ((jget_config, jreduced), (get_config, reduced_config)):
        c = red(get("qwen2_moe_a2_7b"), n_layers=n_layers, d_model=64,
                n_experts=8, vocab=256)
        moe = dataclasses.replace(c.moe, wire_dtype=wire,
                                  **({"ep_backend": backend} if backend
                                     else {}))
        out.append(dataclasses.replace(c, dtype=dtype, remat=False, moe=moe))
    return tuple(out)


def _moe_params(jcfg, dtype):
    """The reference's MoE-layer parameters (jax, cast to ``dtype`` like
    the model casts them) and the port's copy."""
    p = jmoe.moe_init(jcfg, jax.random.PRNGKey(3))
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]

    def cast(k, v):
        return v if k.startswith("router") else v.astype(jd)
    pj = {k: ({kk: cast(kk, vv) for kk, vv in v.items()} if isinstance(
        v, dict) else cast(k, v)) for k, v in p.items()}

    def to(k, v):
        t = torch.from_numpy(np.array(np.asarray(v, np.float32)))
        return t if k.startswith("router") else t.to(td)
    pt = {k: ({kk: to(kk, vv) for kk, vv in v.items()} if isinstance(
        v, dict) else to(k, v)) for k, v in pj.items()}
    return pj, pt


def _x(B, S, D, dtype, seed=4):
    x = np.random.default_rng(seed).standard_normal((B, S, D)).astype(
        np.float32)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("world", ["none", "model4", "pod2x2"])
@pytest.mark.parametrize("wire", ["fp32", "fp8", "int8"])
@pytest.mark.parametrize("mode", ["ll", "ht"])
def test_moe_apply_rdma_matches_reference_fp32(mode, wire, world):
    """fp32 config: the port's host path against the reference's, within
    1e-5 relative (the same routing, wire bytes and combine; only the
    expert sums' order differs).  With an EP world the port's spec has its
    degree (4); the reference without a mesh picks 4 from T and the padded
    experts, so both substrates run 4 ranks."""
    jcfg, cfg = _cfgs(wire=wire)
    pj, pt = _moe_params(jcfg, "float32")
    xj, xt = _x(2, 8, 64, "float32")
    dist = {"none": None, "model4": make_dist_ctx(cfg, model=4),
            "pod2x2": make_dist_ctx(cfg, model=2, pod=2)}[world]
    yr, auxr = jmoe.moe_apply(jcfg, None, pj, xj, mode=mode,
                              backend="simulated_rdma")
    with torch.no_grad():
        yt, auxt = tmoe.moe_apply(cfg, dist, pt, xt, mode=mode,
                                  backend="simulated_rdma")
    assert yt.shape == xt.shape and yt.dtype == torch.float32
    assert _rel(yt.numpy(), yr) <= FP32_RTOL
    assert float(auxt["dropped"]) == float(auxr["dropped"]) == 0.0
    np.testing.assert_array_equal(auxt["load"].numpy(),
                                  np.asarray(auxr["load"]))
    assert abs(float(auxt["imbalance"]) - float(auxr["imbalance"])) < 1e-6
    np.testing.assert_allclose(float(auxt["aux_loss"]),
                               float(auxr["aux_loss"]), rtol=1e-5)


@pytest.mark.parametrize("wire", ["fp32", "fp8"])
@pytest.mark.parametrize("mode", ["ll", "ht"])
def test_moe_apply_rdma_matches_reference_bf16(mode, wire):
    jcfg, cfg = _cfgs(dtype="bfloat16", wire=wire)
    pj, pt = _moe_params(jcfg, "bfloat16")
    xj, xt = _x(2, 8, 64, "bfloat16")
    yr, _ = jmoe.moe_apply(jcfg, None, pj, xj, mode=mode,
                           backend="simulated_rdma")
    with torch.inference_mode():
        yt, aux = tmoe.moe_apply(cfg, None, pt, xt, mode=mode,
                                 backend="simulated_rdma")
    assert yt.dtype == torch.bfloat16
    assert _rel(yt.float().numpy(), np.asarray(yr, np.float32)) <= \
        MOE_TOL["fp32"]
    assert float(aux["dropped"]) == 0.0


def test_moe_apply_rdma_matches_dense_oracle():
    """The substrate is lossless: the port's host path equals its dense
    oracle (``mode="ref"``) to fp32 rounding, LL and HT."""
    _, cfg = _cfgs()
    _, pt = _moe_params(_cfgs()[0], "float32")
    _, xt = _x(4, 4, 64, "float32", seed=7)
    with torch.no_grad():
        ref, _ = tmoe.moe_apply(cfg, None, pt, xt, mode="ref")
        for mode in ("ll", "ht"):
            y, _ = tmoe.moe_apply(cfg, None, pt, xt, mode=mode,
                                  backend="simulated_rdma")
            assert _rel(y.numpy(), ref.numpy()) <= FP32_RTOL


def test_host_expert_fn_calls_grouped_swiglu_both_shapes(monkeypatch):
    """The substrate's expert calls reach ``ops.grouped_swiglu`` in the
    weights' dtype: LL's grouped barrier with bucketed (E, R) counts, one
    call a layer, and HT's one call a (source, chunk) bucket with flat
    (E,) counts, of which only the destination's experts are occupied."""
    jcfg, cfg = _cfgs()
    _, pt = _moe_params(jcfg, "float32")
    _, xt = _x(2, 8, 64, "float32")
    calls = []
    real = ops.grouped_swiglu

    def spy(x, wg, wu, wd, counts=None):
        calls.append((tuple(x.shape), x.dtype, None if counts is None
                      else tuple(counts.shape), counts))
        return real(x, wg, wu, wd, counts)
    monkeypatch.setattr(ops, "grouped_swiglu", spy)
    E = pt["w_gate"].shape[0]
    with torch.no_grad():
        tmoe.moe_apply(cfg, None, pt, xt, mode="ll",
                       backend="simulated_rdma")
        assert len(calls) == 1
        (shape, dt, cshape, _), = calls
        assert dt == torch.float32 and cshape == (E, 4)
        assert shape[0] == E and shape[1] % 4 == 0
        calls.clear()
        tmoe.moe_apply(cfg, None, pt, xt, mode="ht",
                       backend="simulated_rdma")
    assert len(calls) > 1
    eps = E // 4
    for shape, dt, cshape, counts in calls:
        assert cshape == (E,) and shape[0] == E
        occupied = torch.nonzero(counts).reshape(-1)
        # one destination's experts only
        assert len(set((occupied // eps).tolist())) == 1


def test_forward_session_instance_matches_reference():
    """``forward`` with ONE session backend instance shared by every MoE
    layer (``session_layers`` = the MoE layers) against the reference's
    ``forward`` with its own instance (unrolled, outside jit), and bit for
    bit against the port's forward with a fresh backend a layer."""
    jcfg, cfg = _cfgs(n_layers=3)
    params = JZ.init_params(jcfg, jax.random.PRNGKey(1))
    tokens = np.random.default_rng(2).integers(0, 256, (2, 8)).astype(
        np.int32)
    jinst = jget_backend("simulated_rdma", session_layers=3)
    hr, _ = JZ.forward(jcfg, params, jnp.asarray(tokens), unroll=True,
                       moe_backend=jinst)
    tparams = params_from_jax(cfg, jax.tree.map(np.asarray, params),
                              device="cpu")
    tinst = get_backend("simulated_rdma", session_layers=3)
    t = torch.from_numpy(tokens)
    with torch.no_grad():
        h_sess, aux = Z.forward(cfg, tparams, t, moe_backend=tinst)
        h_fresh, _ = Z.forward(cfg, tparams, t, moe_backend="simulated_rdma")
        h_sess2, _ = Z.forward(cfg, tparams, t, moe_backend=tinst)
    assert len(tinst._sessions) == 1          # one world for all layers
    world = next(iter(tinst._sessions.values()))
    assert world.n_layers == 3 and len(world._slots) == 3
    torch.testing.assert_close(h_sess, h_fresh, rtol=0, atol=0)
    torch.testing.assert_close(h_sess2, h_sess, rtol=0, atol=0)
    np.testing.assert_allclose(h_sess.numpy(), np.asarray(hr), rtol=2e-4,
                               atol=2e-4)
    assert len(aux["loads"]) == 3


def test_loss_fn_and_block_apply_take_moe_backend():
    """``loss_fn`` and ``block_apply`` hand ``moe_backend`` to every MoE
    layer: a counting instance sees one call a MoE layer."""
    _, cfg = _cfgs()

    class Counting(SimulatedRDMABackend):
        calls = 0

        def dispatch_combine(self, *a, **k):
            Counting.calls += 1
            return super().dispatch_combine(*a, **k)
    params = Z.init_params(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        loss, m = Z.loss_fn(cfg, params, tokens, tokens,
                            moe_backend=Counting())
        ref, _ = Z.loss_fn(cfg, params, tokens, tokens,
                           moe_backend="torch_collectives")
    assert Counting.calls == cfg.n_layers
    assert torch.isfinite(loss)
    # the collectives without an EP world run the dense oracle: the same
    # function, summed in another order
    torch.testing.assert_close(loss, ref, rtol=1e-5, atol=1e-5)


def test_generate_host_backend_decodes_eagerly():
    """``generate`` with ``simulated_rdma``: ``cuda_graph`` None resolves
    to False and the result says so; ``cuda_graph=True`` raises for the
    host backend (a capture cannot hold its host reads)."""
    _, cfg = _cfgs(backend="simulated_rdma")
    params = Z.init_params(cfg, seed=0, device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (4, 8),
                            generator=torch.Generator().manual_seed(0))
    dist = make_dist_ctx(cfg, model=4)
    res = serve.generate(cfg, params, prompts, 3, dist=dist,
                         batched_prefill=True)
    assert res["cuda_graph"] is False and res["graph_replays"] == 0
    assert res["tokens"].shape == (4, 3)
    assert torch.isfinite(res["logits"]).all()
    assert res["prefill_dropped"] == 0.0 and res["decode_dropped"] == 0.0
    assert serve.host_backend(cfg)
    assert not serve.host_backend(dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe,
                                     ep_backend="torch_collectives")))
    with pytest.raises(ValueError, match="host EP backend"):
        serve.generate(cfg, params, prompts, 2, dist=dist, cuda_graph=True)
    # the same greedy tokens as the collectives with no capacity to drop
    cf = float(params["blocks"][0]["moe"]["w_gate"].shape[0] / cfg.moe.top_k)
    ccfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, ep_backend="torch_collectives", capacity_factor=cf,
        ll_capacity_factor=cf))
    ref = serve.generate(ccfg, params, prompts, 3, dist=dist,
                         batched_prefill=True)
    torch.testing.assert_close(res["logits"], ref["logits"], rtol=1e-4,
                               atol=1e-4)


def test_serve_cli_host_backend_cpu(capsys):
    argv = ["--arch", "qwen2_moe_a2_7b", "--reduced", "--mesh", "local",
            "--ep-backend", "simulated_rdma", "--device", "cpu",
            "--prompt-len", "8", "--gen", "4"]
    assert serve.main(argv) == 0
    assert "[serve] generated 16 tokens" in capsys.readouterr().out


def test_rdma_under_grad_raises():
    """The substrate is numpy and carries no gradient: ``moe_apply`` and
    ``loss_fn`` through it raise under autograd, rather than return a
    result the gradient would silently skip."""
    jcfg, cfg = _cfgs()
    _, pt = _moe_params(jcfg, "float32")
    _, xt = _x(2, 8, 64, "float32")
    with pytest.raises(RuntimeError, match="carries no gradient"):
        tmoe.moe_apply(cfg, None, pt, xt.requires_grad_(), mode="ht",
                       backend="simulated_rdma")
    params = Z.init_params(cfg, seed=0, device="cpu")
    for v in params["blocks"][0]["moe"].values():
        if isinstance(v, torch.Tensor):
            v.requires_grad_()
    tokens = torch.zeros((2, 8), dtype=torch.int64)
    with pytest.raises(RuntimeError, match="carries no gradient"):
        Z.loss_fn(cfg, params, tokens, tokens, moe_backend="simulated_rdma")


def test_unknown_backend_raises_and_registry():
    _, cfg = _cfgs()
    _, pt = _moe_params(_cfgs()[0], "float32")
    _, xt = _x(2, 8, 64, "float32")
    with pytest.raises(KeyError, match="unknown EP backend"):
        tmoe.moe_apply(cfg, None, pt, xt, mode="ht", backend="ragged_a2a")
    assert available_backends() == ["simulated_rdma", "torch_collectives"]
    assert SimulatedRDMABackend.jit_compatible is False
    assert TorchCollectivesBackend.jit_compatible is True
    assert isinstance(get_backend("simulated_rdma"), SimulatedRDMABackend)
