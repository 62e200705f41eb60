"""The plain reference against the port at a tiny size on the CPU, with
the port computing in fp32 (so that only a difference of semantics, not
bf16 rounding, can part them): decode steps through the LL dispatch and
its capacity, the fp8 wire, the batched HT prefill with its capacity
drops, and three training steps (loss, first gradient, change)."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from epbench import checks, weights
from epbench.common import model_config
from epbench.reference import model as M
from epbench.reference import train as RT

PORT = {"arch_id": "tiny", "n_layers": 2, "d_model": 64, "n_heads": 4,
        "n_kv_heads": 4, "head_dim": 16, "vocab_size": 512, "qkv_bias": True,
        "rope_theta": 1e4, "norm_eps": 1e-5, "tie_embeddings": False,
        "moe": {"n_experts": 12, "top_k": 3, "n_shared_experts": 1,
                "d_expert": 32, "d_shared": 32, "moe_every": 1,
                "aux_loss_weight": 0.01, "router_aux_free_bias": True}}


def setup(traffic, seed=5, port=PORT):
    cfg = dataclasses.replace(model_config({"port": port}, traffic),
                              dtype="float32")
    sz = M.sizes(port, traffic)
    return cfg, sz


def fp32_params(cfg, seed):
    p = weights.make_params(cfg, seed, "cpu", torch.bfloat16)
    return torch.utils._pytree.tree_map(lambda t: t.to(torch.float32), p)


@pytest.mark.parametrize("wire", ["fp32", "fp8"])
@pytest.mark.parametrize("cf", [4.0, 0.5])
def test_decode_steps_match(wire, cf):
    from repro_torch.distributed.sharding import make_dist_ctx
    from repro_torch.models import model_zoo as Z
    tr = {"ep_world": 4, "wire_dtype": wire, "ll_capacity_factor": cf}
    cfg, sz = setup(tr)
    params = fp32_params(cfg, 5)
    # 32 slots an expert at least: 128 x 3 choices over 12 experts
    # overflow some
    B, L = (6, 7) if cf > 1 else (128, 3)
    tokens = torch.randint(0, 512, (B, L), generator=torch.Generator()
                           .manual_seed(1))
    cache = Z.init_cache(cfg, B, L, dtype=torch.float32, device="cpu")
    dist = make_dist_ctx(cfg, model=4)
    got, dropped = [], []
    with torch.inference_mode():
        for t in range(L):
            logits, _, aux = Z.decode_step(cfg, params, cache,
                                           tokens[:, t:t + 1], t, dist=dist,
                                           moe_mode="ll")
            got.append(logits[:, :512])
            dropped.append(float(aux["dropped"]))
    got = torch.stack(got, 1)
    ref = M.served_logits(params, tokens, sz, "ll", list(range(B)),
                          list(range(L)))
    assert torch.allclose(got, ref, atol=2e-4, rtol=2e-4), \
        (got - ref).abs().max()
    if cf < 1:
        assert max(dropped) > 0       # the capacity rule was exercised


@pytest.mark.parametrize("wire", ["fp32", "fp8"])
@pytest.mark.parametrize("cf", [2.0, 0.3])
def test_prefill_matches(wire, cf):
    from repro_torch.distributed.sharding import make_dist_ctx
    from repro_torch.models import model_zoo as Z
    tr = {"ep_world": 4, "wire_dtype": wire, "capacity_factor": cf}
    cfg, sz = setup(tr)
    params = fp32_params(cfg, 9)
    # 128 tokens a rank: an expert's capacity at cf 0.3 (32 rows) overflows
    B, S = 2, 256
    tokens = torch.randint(0, 512, (B, S), generator=torch.Generator()
                           .manual_seed(2))
    cache = Z.init_cache(cfg, B, S, dtype=torch.float32, device="cpu")
    with torch.inference_mode():
        logits, _, aux = Z.prefill(cfg, params, cache, tokens,
                                   dist=make_dist_ctx(cfg, model=4),
                                   moe_mode="ht")
    ref = M.served_logits(params, tokens, sz, "ht", [0, 1], [S - 1])[:, 0]
    assert torch.allclose(logits[:, :512], ref, atol=2e-4, rtol=2e-4), \
        (logits[:, :512] - ref).abs().max()
    if cf < 1:
        assert float(aux["dropped"]) > 0


def test_train_steps_match():
    from repro_torch.distributed.sharding import make_dist_ctx
    from repro_torch.optim import adamw
    from repro_torch.training.train_loop import (HParams, TrainState,
                                                 make_train_step)
    from epbench.traffic import train as T
    tr = {"ep_world": 4, "capacity_factor": 0.6, "peak_lr": 3e-3,
          "warmup": 1, "total_steps": 10, "layers": 2}
    cfg, sz = setup(tr)
    hp = T.hparams(tr)
    step = make_train_step(cfg, HParams(peak_lr=3e-3, warmup=1,
                                        total_steps=10, moe_mode="ht"),
                           make_dist_ctx(cfg, model=4))
    params = weights.make_params(cfg, 3, "cpu", torch.float32)
    state = TrainState(params, adamw.init_state(params))
    batches = [T.batch(3, i, 2, 16, 512, "cpu") for i in range(3)]
    losses, first = [], None
    for i, b in enumerate(batches):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        if i == 0:
            first = {p: float(t.norm()) / 0.1
                     for p, t in weights.leaves(state.opt.mu)}
    cur = dict(weights.leaves(state.params))
    change = {p: float((cur[p].detach() - p0).norm())
              for p, p0 in weights.initial_leaves(cfg, 3, "cpu")}
    ref = RT.run(T._Initial(cfg, 3, "cpu"),
                 [(b["tokens"], b["labels"]) for b in batches], sz, hp, 3)
    for a, b in zip(losses, ref["losses"]):
        assert abs(a - b) < 1e-4 * abs(b)
    n = checks.train_numbers({"losses": losses, "grad_norms": first,
                              "change_norms": change}, ref)
    assert n["grad_gap"] < 1e-3 and n["change_gap"] < 1e-2, n
    assert "blocks/0/moe/router_b" in n["_left_out"]
