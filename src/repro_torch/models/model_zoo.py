"""Model init, cache, prefill and decode for the serving path (the port of
``repro.models.model_zoo``).

The JAX package stacks each layer slot's parameters over ``n_periods`` and
scans them; here ``params["blocks"]`` is a list of per-layer dicts and a
Python loop runs them.  ``cast_params`` casts to the compute dtype once,
at load; ``prefill`` and ``decode_step`` take parameters already cast.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import DistCtx
from repro_torch.models import blocks as B
from repro_torch.models.layers import rmsnorm, rmsnorm_init

Tensor = torch.Tensor

# float parameters whose name contains one of these stay fp32
_FP32_NAMES = ("ln", "norm", "A_log", "dt_b", "router", "D", "conv_b")


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def cast_params(params, dtype, name: str = ""):
    """Cast float32 tensors to ``dtype``, keeping norm scales, the router
    and the rest of ``_FP32_NAMES`` in fp32 (the filter of the JAX
    package's ``cast_params``)."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype, k) for k, v in params.items()}
    if isinstance(params, list):
        return [cast_params(v, dtype, name) for v in params]
    if params.dtype == torch.float32 and not any(t in name
                                                 for t in _FP32_NAMES):
        return params.to(dtype)
    return params


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                dtype: Optional[torch.dtype] = None) -> dict:
    """Random parameters from ``seed`` (a torch.Generator; the numbers
    differ from the JAX package's).  With ``dtype``, each layer is cast as
    soon as it is made, which keeps the fp32 peak to one layer."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    d, vp = cfg.d_model, cfg.padded_vocab()

    def done(p, name=""):
        return cast_params(p, dtype, name) if dtype is not None else p

    params: dict = {
        "embed": done(torch.randn((vp, d), generator=gen, device=device)
                      * 0.02, "embed"),
        "final_ln": rmsnorm_init(d, device),
    }
    params["lm_head"] = done(torch.randn((d, vp), generator=gen,
                                         device=device) / math.sqrt(d),
                             "lm_head")
    params["blocks"] = [done(B.block_init(cfg, i, gen, device))
                        for i in range(cfg.n_layers)]
    return params


def lm_head_weight(cfg: ModelConfig, params: dict) -> Tensor:
    return params["lm_head"]


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> list:
    return [B.block_init_cache(cfg, batch, max_len, dtype, device)
            for _ in range(cfg.n_layers)]


def _dropped(auxes: list, device) -> dict:
    """``dropped``: the mean over MoE layers of the dropped-choice
    fraction; ``dropped_per_layer``: that fraction per MoE layer."""
    d = [a["dropped"] for a in auxes if "dropped" in a]
    per_layer = (torch.stack(d) if d
                 else torch.zeros((0,), device=device))
    return {"dropped": (per_layer.mean() if d
                        else torch.zeros((), device=device)),
            "dropped_per_layer": per_layer}


def prefill(cfg: ModelConfig, params: dict, cache: list, tokens: Tensor, *,
            dist: Optional[DistCtx] = None,
            moe_mode: str = "ht") -> tuple[Tensor, list, dict]:
    """Batched prompt prefill: ONE forward pass over tokens (B, S) that
    fills ``cache[:, :S]`` of every layer.  Returns the last position's
    logits (B, V_pad) fp32, the cache, and ``{"dropped",
    "dropped_per_layer"}`` (see :func:`_dropped`)."""
    x = B.vocab_embed(params["embed"], tokens)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None].expand(x.shape[0], S)
    auxes = []
    for p, c in zip(params["blocks"], cache):
        x, _, aux = B.block_prefill(cfg, dist, p, x, c, positions,
                                    moe_mode=moe_mode)
        auxes.append(aux)
    x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    logits = (x[:, -1] @ lm_head_weight(cfg, params)).to(torch.float32)
    return logits, cache, _dropped(auxes, x.device)


def decode_step(cfg: ModelConfig, params: dict, cache: list, tokens: Tensor,
                pos: int, *, dist: Optional[DistCtx] = None,
                moe_mode: str = "ll") -> tuple[Tensor, list, dict]:
    """One decode step: tokens (B, 1) at position ``pos`` (same for the
    batch).  Returns (logits (B, V_pad) fp32, cache, ``{"dropped",
    "dropped_per_layer"}``)."""
    x = B.vocab_embed(params["embed"], tokens)
    auxes = []
    for p, c in zip(params["blocks"], cache):
        x, _, aux = B.block_decode(cfg, dist, p, x, c, pos,
                                   moe_mode=moe_mode)
        auxes.append(aux)
    x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    logits = (x[:, 0] @ lm_head_weight(cfg, params)).to(torch.float32)
    return logits, cache, _dropped(auxes, x.device)
