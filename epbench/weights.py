"""The weights of a cell, drawn on the device from the run's seed.

The benchmark makes them, in the port's parameter layout (``embed``,
``lm_head``, ``final_ln``, ``blocks[i]`` with ``ln1``, ``ln2``, ``attn``
and ``moe``), and hands the same tensors to the port and to the plain
reference.  Each group of leaves (every layer's ``w_gate``, say) has a
generator of its own, seeded from the run's seed and the group's index,
and is drawn layer by layer: a few large calls, each a fixed function of
the seed.  Serving holds each group as one stacked tensor in the served
dtype (bf16; norm scales and the router in fp32, as the port keeps
them) and hands the port a view a layer; training makes each leaf its
own fp32 tensor.  :func:`initial_leaves` draws the same fp32 values again,
one leaf at a time.

Norm scales are drawn around 1 and the q/k/v biases and router bias
around 0, so that a fault in any of them shows.  The embedding rows have
unit scale, as the residual stream of a trained model carries its token's
own content: at the port's 0.02 the attention's near-mean over a long
prefix (and the value bias) dominates every token's residual, the
routers send nearly every token to the same experts, and the capacity
drops most choices, which a trained router does not.  The router's
logits have a spread of ``ROUTER_SPREAD``, so that its top-k choice is
as confident as a trained router's: at a spread of 1 the k-th and
(k+1)-th experts of most tokens lie within bf16 rounding of each other,
and which expert a token reaches turns on rounding.
"""
from __future__ import annotations

import math

import torch

from epbench.common import mix_seed

WEIGHT_STREAM = 100          # streams WEIGHT_STREAM + group index
# the router logits' spread (their standard deviation over the experts)
ROUTER_SPREAD = 3.0


def padded_experts(n: int) -> int:
    """The routed experts the port holds: padded to a multiple of 32 (16
    below 32 experts); the router masks the pads."""
    m = 32 if n >= 32 else 16
    return -(-n // m) * m


def padded_vocab(v: int) -> int:
    return -(-v // 256) * 256


def groups(cfg) -> list[tuple]:
    """(path in a block or at the top, per-layer shape, mean, std, fp32?)
    of every group of leaves, in drawing order; a path starting with
    ``blocks/`` repeats over the layers."""
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    vp, ep = padded_vocab(cfg.vocab_size), padded_experts(cfg.moe.n_experts)
    f, fs = cfg.moe.d_expert, cfg.moe.d_shared
    out = [("embed", (vp, d), 0.0, 1.0, False),
           ("lm_head", (d, vp), 0.0, 1 / math.sqrt(d), False),
           ("final_ln", (d,), 1.0, 0.1, True),
           ("blocks/ln1", (d,), 1.0, 0.1, True),
           ("blocks/ln2", (d,), 1.0, 0.1, True),
           ("blocks/attn/wq", (d, h, hd), 0.0, 1 / math.sqrt(d), False),
           ("blocks/attn/wk", (d, hkv, hd), 0.0, 1 / math.sqrt(d), False),
           ("blocks/attn/wv", (d, hkv, hd), 0.0, 1 / math.sqrt(d), False),
           ("blocks/attn/wo", (h, hd, d), 0.0, 1 / math.sqrt(h * hd), False)]
    if cfg.qkv_bias:
        out += [("blocks/attn/bq", (h, hd), 0.0, 0.02, False),
                ("blocks/attn/bk", (hkv, hd), 0.0, 0.02, False),
                ("blocks/attn/bv", (hkv, hd), 0.0, 0.02, False)]
    out += [("blocks/moe/router_w", (d, ep), 0.0, ROUTER_SPREAD / math.sqrt(d),
             True),
            ("blocks/moe/router_b", (ep,), 0.0, 0.05, True),
            ("blocks/moe/w_gate", (ep, d, f), 0.0, 1 / math.sqrt(d), False),
            ("blocks/moe/w_up", (ep, d, f), 0.0, 1 / math.sqrt(d), False),
            ("blocks/moe/w_down", (ep, f, d), 0.0, 1 / math.sqrt(f), False)]
    if fs:
        out += [("blocks/moe/shared/w_gate", (d, fs), 0.0, 1 / math.sqrt(d),
                 False),
                ("blocks/moe/shared/w_up", (d, fs), 0.0, 1 / math.sqrt(d),
                 False),
                ("blocks/moe/shared/w_down", (fs, d), 0.0, 1 / math.sqrt(fs),
                 False)]
    return out


def _put(tree: dict, path: list, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _gen(seed: int, gi: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        mix_seed(seed, WEIGHT_STREAM + gi))


def make_params(cfg, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The cell's parameters from ``seed`` on ``device``.  ``dtype``
    bf16: serving (stacked groups, views a layer, norm scales and router
    fp32); fp32: training (every leaf its own tensor, requiring grad)."""
    device = torch.device(device)
    train = dtype == torch.float32
    params: dict = {"blocks": [{} for _ in range(cfg.n_layers)]}
    for gi, (path, shape, mean, std, keep32) in enumerate(groups(cfg)):
        g = _gen(seed, gi, device)
        dt = torch.float32 if (keep32 or train) else dtype
        keys = path.split("/")
        if keys[0] != "blocks":
            t = torch.empty(shape, dtype=dt, device=device)
            t.normal_(mean, std, generator=g)
            _put(params, keys, t)
            continue
        if train:
            for layer in range(cfg.n_layers):
                t = torch.empty(shape, dtype=dt, device=device)
                t.normal_(mean, std, generator=g)
                _put(params["blocks"][layer], keys[1:], t)
        else:
            stack = torch.empty((cfg.n_layers, *shape), dtype=dt,
                                device=device)
            for layer in range(cfg.n_layers):
                stack[layer].normal_(mean, std, generator=g)
                _put(params["blocks"][layer], keys[1:], stack[layer])
    if train:
        for _, t in leaves(params):
            t.requires_grad_(True)
    return params


def initial_leaves(cfg, seed: int, device):
    """(path, fp32 tensor) of every leaf as :func:`make_params` draws it in
    fp32, one at a time, in :func:`leaves` order of each group."""
    device = torch.device(device)
    for gi, (path, shape, mean, std, _) in enumerate(groups(cfg)):
        g = _gen(seed, gi, device)
        keys = path.split("/")
        n = cfg.n_layers if keys[0] == "blocks" else 1
        for layer in range(n):
            t = torch.empty(shape, dtype=torch.float32, device=device)
            t.normal_(mean, std, generator=g)
            name = (path if keys[0] != "blocks"
                    else "/".join(["blocks", str(layer), *keys[1:]]))
            yield name, t


def leaves(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path, tensor) of every tensor of a nested dict / list tree."""
    out = []
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, list) else None)
    if items is None:
        return [(prefix, tree)]
    for k, v in items:
        out += leaves(v, f"{prefix}/{k}" if prefix else str(k))
    return out

