"""Moonlight-16B-A3B's mechanisms in the port against the benchmark's
plain reference (``epbench/reference/mla.py``: fp32, non-absorbed,
nothing of the port), at ``reduced_config`` size on the CPU: the absorbed
MLA decode against the non-absorbed attention, prefill then decode
through the latent cache against the full forward, the sigmoid router
with its scale, the softmax router unchanged, the dense first layer,
``ops.mla_decode``'s plain version, the training loss and every MLA
leaf's gradient, and the configuration's registry."""
import dataclasses
import math
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from epbench import weights_mla  # noqa: E402
from epbench.reference import mla as RM  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import routing  # noqa: E402
from repro_torch.kernels import mla as kmla  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import mla  # noqa: E402
from repro_torch.models import model_zoo as Z  # noqa: E402


def _cfg(**moe):
    cfg = configs.reduced_config(configs.get_config("moonlight_16b_a3b"))
    return dataclasses.replace(cfg, dtype="float32",
                               moe=dataclasses.replace(cfg.moe, **moe))


def _sizes(cfg):
    return RM.sizes(dataclasses.asdict(cfg), {"ep_world": 4})


def _params(cfg, seed=3):
    p = weights_mla.make_params(cfg, seed, "cpu", torch.float32)
    return p


@pytest.mark.parametrize("S", [1, 5, 12])
def test_absorbed_decode_matches_expanded_attention(S):
    """Layer by layer: the absorbed decode of each position through the
    latent cache equals the non-absorbed attention over the sequence."""
    cfg = _cfg()
    p = _params(cfg)["blocks"][1]["attn"]
    g = torch.Generator().manual_seed(S)
    x = torch.randn((2, S, cfg.d_model), generator=g)
    full = mla.mla_attention(cfg, p, x, torch.arange(S)[None].expand(2, S))
    latent = torch.zeros((2, S, mla.cache_width(cfg)))
    for t in range(S):
        got = mla.mla_decode(cfg, p, x[:, t:t + 1], latent,
                             torch.tensor(t, dtype=torch.int32))
        torch.testing.assert_close(got[:, 0], full[:, t], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("S,N", [(6, 4), (16, 1)])
def test_prefill_then_decode_match_the_reference(S, N):
    """Prefill of S tokens, then N decode steps through the latent cache,
    against the reference's full forward: every position's logits and
    every layer's latent rows."""
    cfg = _cfg()
    sz = _sizes(cfg)
    params = _params(cfg)
    g = torch.Generator().manual_seed(S * 10 + N)
    tokens = torch.randint(0, cfg.vocab_size, (2, S + N), generator=g)
    cache = Z.init_cache(cfg, 2, S + N, dtype=torch.float32, device="cpu")
    with torch.inference_mode():
        first, _, _ = Z.prefill(cfg, params, cache, tokens[:, :S])
        got = [first]
        for t in range(S, S + N):
            logits, _, _ = Z.decode_step(cfg, params, cache,
                                         tokens[:, t:t + 1], t)
            got.append(logits)
    got = torch.stack(got, 1)[..., :cfg.vocab_size]
    with torch.no_grad():
        ref = RM.head(params, RM.hidden(params, tokens, sz, "all"), sz)
        x = params["embed"][tokens]
        for i, b in enumerate(params["blocks"]):
            Wl = RM.layer_weights(b)
            h = RM.M.rmsnorm(x, Wl["ln1"], sz["eps"])
            torch.testing.assert_close(cache[i]["latent"],
                                       RM.latent_rows(h, Wl, sz),
                                       rtol=1e-5, atol=1e-5)
            x = RM.block(x, Wl, sz, "all")
    torch.testing.assert_close(got, ref[:, S - 1:], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("n_real", [16, 12])
def test_sigmoid_routing(bias, n_real):
    """Selection on sigmoid scores plus the bias (never a pad), the
    chosen scores renormalised and times 2.446, against the reference's
    rule and a hand check of one token."""
    cfg = _cfg(n_experts=n_real)
    g = torch.Generator().manual_seed(n_real + bias)
    x = torch.randn((2, 40, cfg.d_model), generator=g)
    w = torch.randn((cfg.d_model, 16), generator=g) / 4
    b = torch.randn((16,), generator=g) * 0.5 if bias else None
    out = routing.route(cfg.moe, routing.RouterParams(w, b), x, n_real)
    ids, wts, probs = RM.route_sigmoid(x.reshape(-1, cfg.d_model), w, b,
                                       n_real, cfg.moe.top_k, 2.446)
    assert torch.equal(out.top_idx.reshape(-1, 2).long(), ids)
    torch.testing.assert_close(out.top_w.reshape(-1, 2), wts)
    torch.testing.assert_close(out.probs.reshape(-1, 16), probs)
    assert (out.top_idx < n_real).all()
    torch.testing.assert_close(out.top_w.sum(-1),
                               torch.full((2, 40), 2.446))
    s = torch.sigmoid(x[0, 0] @ w)
    sel = s + (b if bias else 0)
    sel[n_real:] = -math.inf
    top = torch.topk(sel, 2).indices
    assert set(top.tolist()) == set(out.top_idx[0, 0].tolist())
    torch.testing.assert_close(out.top_w[0, 0].sum(), torch.tensor(2.446))


def _softmax_route_before(moe, p, x, n_real):
    """The softmax router as it was before the sigmoid rule came in."""
    e_pad = p.w.shape[1]
    logits = (x.to(torch.float32) @ p.w).to(torch.float32)
    if e_pad > n_real:
        pad = torch.arange(e_pad, device=x.device) >= n_real
        logits = logits.masked_fill(pad, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    sel = logits if p.bias is None else logits + p.bias
    top_idx = torch.topk(sel, moe.top_k, dim=-1).indices
    top_p = torch.gather(probs, -1, top_idx)
    top_w = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    onehot = torch.nn.functional.one_hot(top_idx, e_pad).to(
        torch.float32).sum(-2)
    aux = n_real * (onehot.mean(-2) * probs.mean(-2)).sum(-1) \
        * moe.aux_loss_weight
    return top_idx.to(torch.int32), top_w.to(x.dtype), probs, aux


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_routing_unchanged(dtype):
    """qwen2-moe's tiny config: the softmax branch bit for bit as before."""
    cfg = configs.reduced_config(configs.get_config("qwen2_moe_a2_7b"))
    assert cfg.moe.scoring == "softmax" and cfg.moe.routed_scale == 1.0
    g = torch.Generator().manual_seed(4)
    x = torch.randn((3, 32, cfg.d_model), generator=g).to(dtype)
    p = routing.RouterParams(torch.randn((cfg.d_model, 16), generator=g),
                             torch.randn((16,), generator=g) * 0.1)
    got = routing.route(cfg.moe, p, x, 12)
    want = _softmax_route_before(cfg.moe, p, x, 12)
    for a, b in zip((got.top_idx, got.top_w, got.probs, got.aux_loss),
                    want):
        assert torch.equal(a, b)


def test_dense_first_layer():
    """Layer 0 is the dense d_ff SwiGLU (no router, no experts); the rest
    are MoE layers; the layer equals the reference's."""
    cfg = _cfg()
    assert [cfg.is_moe_layer(i) for i in range(cfg.n_layers)] == [
        False, True, True]
    params = _params(cfg)
    b0 = params["blocks"][0]
    assert set(b0) == {"ln1", "ln2", "attn", "mlp"}
    assert tuple(b0["mlp"]["w_gate"].shape) == (cfg.d_model, cfg.d_ff)
    port = Z.init_params(cfg, seed=0, device="cpu")
    assert set(port["blocks"][0]) == set(b0)
    from repro_torch.models import blocks
    x = torch.randn((2, 5, cfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    got, aux = blocks.block_apply(cfg, None, b0, x,
                                  torch.arange(5)[None].expand(2, 5))
    assert aux == {}
    want = RM.block(x, RM.layer_weights(b0), _sizes(cfg), "all")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pos", [0, 9, 23])
def test_ops_mla_decode_plain(pos):
    """The plain version at the first, a middle and the last position,
    against a softmax written out: fp32 in, so P's rounding is none."""
    g = torch.Generator().manual_seed(pos)
    q = torch.randn((3, 4, 40), generator=g)
    cache = torch.randn((3, 24, 40), generator=g)
    got = ops.mla_decode(q, cache, torch.tensor(pos, dtype=torch.int32),
                         scale=0.2, v_dim=32)
    s = torch.einsum("bhk,bsk->bhs", q, cache[:, :pos + 1]) * 0.2
    want = torch.einsum("bhs,bsv->bhv", torch.softmax(s, -1),
                        cache[:, :pos + 1, :32])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert torch.equal(got, kmla.mla_decode_plain(q, cache, pos, scale=0.2,
                                                  v_dim=32))


def test_training_loss_and_mla_gradients_match_the_reference():
    """The port's loss (no EP world, every choice kept, no balance term)
    and the gradient of every MLA leaf against autograd through the
    reference."""
    cfg = _cfg(aux_loss_weight=0.0)
    sz = _sizes(cfg)
    mine = _params(cfg, seed=7)
    ref = torch.utils._pytree.tree_map(lambda t: t.clone(), mine)
    for tree in (mine, ref):
        for _, t in weights_mla.W.leaves(tree):
            t.requires_grad_(True)
    g = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
    labels = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
    loss, _ = Z.loss_fn(cfg, mine, tokens, labels)
    loss.backward()
    want = RM.loss(ref, tokens, labels, sz)
    want.backward()
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=1e-6)
    names = ("wq", "w_dkv", "kv_norm", "w_ukv", "wo")
    for i in range(cfg.n_layers):
        for n in names:
            a = mine["blocks"][i]["attn"][n].grad
            b = ref["blocks"][i]["attn"][n].grad
            assert a is not None and float(b.norm()) > 0, (i, n)
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def test_registry_finds_moonlight_and_keeps_arch_ids():
    assert tuple(configs.ARCH_IDS) == tuple(jconfigs.ARCH_IDS)
    assert "moonlight_16b_a3b" not in configs.all_configs()
    for name in ("moonlight_16b_a3b", "moonlight-16b-a3b"):
        cfg = configs.get_config(name)
        assert cfg.arch_id == "moonlight_16b_a3b"
    assert (cfg.n_layers, cfg.kv_lora_rank, cfg.qk_nope_head_dim,
            cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.first_k_dense,
            cfg.d_ff) == (27, 512, 128, 64, 128, 1, 11_264)
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_shared,
            cfg.moe.scoring, cfg.moe.routed_scale) == (64, 6, 2816,
                                                       "sigmoid", 2.446)
    assert cfg.param_count() == 15_960_106_496
    red = configs.reduced_config(cfg)
    assert (red.kv_lora_rank, red.qk_rope_head_dim, red.qk_nope_head_dim,
            red.v_head_dim, red.first_k_dense, red.n_layers) == (
        32, 8, 16, 16, 1, 3)
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("moonlight_no_such")


def test_cache_is_the_latent_and_its_gauge():
    from repro_torch import tracing
    cfg = configs.get_config("moonlight_16b_a3b")
    cache = Z.init_cache(cfg, 2, 8, device="meta")
    assert all(set(c) == {"latent"} and tuple(c["latent"].shape) == (
        2, 8, 576) for c in cache)
    assert tracing.snapshot()["gauges"]["serve.cache_bytes_per_token"] == \
        31_104
    Z.init_cache(configs.get_config("qwen2_moe_a2_7b"), 2, 8, device="meta")
    assert tracing.snapshot()["gauges"]["serve.cache_bytes_per_token"] == \
        196_608


def test_serve_cli_runs_moonlight_reduced(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "moonlight_16b_a3b", "--reduced",
                       "--device", "cpu", "--mesh", "local",
                       "--local-model-axis", "4", "--batch", "2",
                       "--prompt-len", "8", "--gen", "4"]) == 0
    assert "generated 8 tokens" in capsys.readouterr().out
