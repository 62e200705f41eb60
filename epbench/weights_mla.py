"""The weights of an MLA cell (``reference/mla.py``'s layout, the port's
``models/mla.py``), drawn on the device from the run's seed as
``weights.py`` draws the MHA cells': a generator a group of leaves,
seeded from the run's seed and the group's index, each group one stacked
tensor in the served dtype (norm scales and the router in fp32), a view a
layer.  ``weights.py`` is used as it is (its seeds, padding and tree
helpers); only the groups differ: ``attn`` holds ``wq``, ``w_dkv``,
``kv_norm``, ``w_ukv`` and ``wo``; the leading dense layers ``mlp``, the
rest ``moe``.

The router of a sigmoid-scored model.  Selection takes the top 6 of
sigmoid(logit) + bias, so the spread of the logits and of the bias
decide whose choice it is:

- ``ROUTER_SPREAD_MLA`` 1.0: the logits' standard deviation over the
  experts.  A token's 6th and 7th largest scores of 64 then lie a median
  0.011 apart (sigmoid's slope ~0.16 there).  At the spread of 3 and the
  bias of 0.05 that ``weights.py`` gives a softmax router, a token's top
  logits lie at 4.5-7, where sigmoid flattens (slope ~0.017, a median gap
  of 0.0036), and the bias alone would change 98% of the tokens' top 6;
- ``ROUTER_BIAS_MLA`` 0.005: the selection bias's standard deviation,
  half that median gap: the bias-free top 6 differs in 16% of tokens (by
  one expert at the margin), and a relative 2^-9 error in every logit
  (bf16 rounding of the router's input) changes it in 1.5%: neither
  decides most tokens' choice.  (Drawn from 200,000 sets of 64 normal
  logits; on the card the bf16 program's first MoE layer chooses other
  experts than the fp32 reference for 2.2-2.7% of tokens, and LL's
  capacity drops no choice: ``PERF.md`` 4.)
"""
from __future__ import annotations

import math

import torch

from epbench import weights as W

ROUTER_SPREAD_MLA = 1.0
ROUTER_BIAS_MLA = 0.005


def groups(cfg) -> list[tuple]:
    """(path, per-layer shape, mean, std, fp32?, layers) of every group,
    in drawing order; ``layers`` the layer indices a ``blocks/`` group
    covers (None at the top)."""
    d, h = cfg.d_model, cfg.n_heads
    c, r = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    nope, v = cfg.qk_nope_head_dim, cfg.v_head_dim
    vp, ep = W.padded_vocab(cfg.vocab_size), W.padded_experts(
        cfg.moe.n_experts)
    f, fs, ff = cfg.moe.d_expert, cfg.moe.d_shared, cfg.d_ff
    every = list(range(cfg.n_layers))
    dense = [i for i in every if i < cfg.first_k_dense]
    moe = [i for i in every if i >= cfg.first_k_dense]
    out = [("embed", (vp, d), 0.0, 1.0, False, None),
           ("lm_head", (d, vp), 0.0, 1 / math.sqrt(d), False, None),
           ("final_ln", (d,), 1.0, 0.1, True, None),
           ("blocks/ln1", (d,), 1.0, 0.1, True, every),
           ("blocks/ln2", (d,), 1.0, 0.1, True, every),
           ("blocks/attn/wq", (d, h, nope + r), 0.0, 1 / math.sqrt(d), False,
            every),
           ("blocks/attn/w_dkv", (d, c + r), 0.0, 1 / math.sqrt(d), False,
            every),
           ("blocks/attn/kv_norm", (c,), 1.0, 0.1, True, every),
           ("blocks/attn/w_ukv", (c, h, nope + v), 0.0, 1 / math.sqrt(c),
            False, every),
           ("blocks/attn/wo", (h, v, d), 0.0, 1 / math.sqrt(h * v), False,
            every)]
    if dense:
        out += [("blocks/mlp/w_gate", (d, ff), 0.0, 1 / math.sqrt(d), False,
                 dense),
                ("blocks/mlp/w_up", (d, ff), 0.0, 1 / math.sqrt(d), False,
                 dense),
                ("blocks/mlp/w_down", (ff, d), 0.0, 1 / math.sqrt(ff), False,
                 dense)]
    out += [("blocks/moe/router_w", (d, ep), 0.0,
             ROUTER_SPREAD_MLA / math.sqrt(d), True, moe),
            ("blocks/moe/router_b", (ep,), 0.0, ROUTER_BIAS_MLA, True, moe),
            ("blocks/moe/w_gate", (ep, d, f), 0.0, 1 / math.sqrt(d), False,
             moe),
            ("blocks/moe/w_up", (ep, d, f), 0.0, 1 / math.sqrt(d), False, moe),
            ("blocks/moe/w_down", (ep, f, d), 0.0, 1 / math.sqrt(f), False,
             moe)]
    if fs:
        out += [("blocks/moe/shared/w_gate", (d, fs), 0.0, 1 / math.sqrt(d),
                 False, moe),
                ("blocks/moe/shared/w_up", (d, fs), 0.0, 1 / math.sqrt(d),
                 False, moe),
                ("blocks/moe/shared/w_down", (fs, d), 0.0, 1 / math.sqrt(fs),
                 False, moe)]
    return out


def make_params(cfg, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The cell's parameters from ``seed`` on ``device``: stacked groups in
    ``dtype`` (norm scales and the router fp32), a view a layer."""
    device = torch.device(device)
    params: dict = {"blocks": [{} for _ in range(cfg.n_layers)]}
    for gi, (path, shape, mean, std, keep32, layers) in enumerate(
            groups(cfg)):
        g = W._gen(seed, gi, device)
        dt = torch.float32 if keep32 else dtype
        keys = path.split("/")
        if layers is None:
            t = torch.empty(shape, dtype=dt, device=device)
            t.normal_(mean, std, generator=g)
            W._put(params, keys, t)
            continue
        stack = torch.empty((len(layers), *shape), dtype=dt, device=device)
        for i, layer in enumerate(layers):
            stack[i].normal_(mean, std, generator=g)
            W._put(params["blocks"][layer], keys[1:], stack[i])
    return params
