"""Transformer and Mamba blocks: the training ``block_apply`` and the
local-cache prefill and decode of ``repro.models.blocks``.

A layer's parameters are a dict in the JAX layout (``ln1``, ``ln2``,
``attn`` or ``mamba``, ``moe`` or ``mlp``); its decode cache is a dict
``{"k", "v"}`` of ``(B, S_max, Hkv, hd)`` tensors, which prefill and decode
update in place.  The reference's mesh constraints and its ``sp_islands``
shard_map islands place tensors on a TPU mesh; they have no counterpart on
one card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.moe import moe_apply, moe_init
from repro_torch.distributed.sharding import DistCtx
from repro_torch.models.layers import (_qkv, attention, attn_init,
                                       decode_attention_local, decode_qkv,
                                       flash_attention_blocked, mlp_init,
                                       rmsnorm, rmsnorm_init, swiglu)
from repro_torch.models.mamba import mamba_apply, mamba_init

Tensor = torch.Tensor


def block_init(cfg: ModelConfig, layer_idx: int, gen: torch.Generator,
               device) -> dict:
    p: dict = {"ln1": rmsnorm_init(cfg.d_model, device),
               "ln2": rmsnorm_init(cfg.d_model, device)}
    if cfg.is_attn_layer(layer_idx):
        p["attn"] = attn_init(cfg, gen, device)
    elif cfg.mamba.enabled:
        p["mamba"] = mamba_init(cfg, gen, device)
    if cfg.is_moe_layer(layer_idx):
        p["moe"] = moe_init(cfg, gen, device)
    elif cfg.d_ff:
        p["mlp"] = mlp_init(cfg.d_model, cfg.d_ff, gen, device)
    return p


def block_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                     dtype=torch.bfloat16, device="cuda") -> dict:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _ffn(cfg, dist, p, h, mode, chunks):
    if "moe" in p:
        return moe_apply(cfg, dist, p["moe"], h, mode=mode, chunks=chunks)
    if "mlp" in p:
        return swiglu(p["mlp"], h), {}
    return torch.zeros_like(h), {}


def block_apply(cfg: ModelConfig, dist: Optional[DistCtx], p: dict,
                x: Tensor, positions: Tensor, *, moe_mode: str = "ht",
                moe_chunks: int = 1,
                causal_skip: bool = False) -> tuple[Tensor, dict]:
    """Training/prefill block: x (B, S, D) residual -> (x', aux)."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if "attn" in p:
        h = attention(cfg, p["attn"], h, positions, causal_skip=causal_skip)
    elif "mamba" in p:
        h = mamba_apply(cfg, p["mamba"], h)
    x = x + h
    h, aux = _ffn(cfg, dist, p, rmsnorm(x, p["ln2"], cfg.norm_eps),
                  moe_mode, moe_chunks)
    return x + h, aux


def block_prefill(cfg: ModelConfig, dist: Optional[DistCtx], p: dict,
                  x: Tensor, cache: dict, positions: Tensor, *,
                  moe_mode: str = "ht",
                  moe_chunks: int = 1) -> tuple[Tensor, dict, dict]:
    """Batched prompt prefill: x (B, S, D) -> (x', cache, aux); the
    projected k/v land in ``cache[:, :S]``."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    q, k_new, v_new = _qkv(cfg, p["attn"], h, positions)
    S = x.shape[1]
    blk = min(512, S)
    o = flash_attention_blocked(q, k_new, v_new, causal=True, q_block=blk,
                                kv_block=blk)
    cache["k"][:, :S] = k_new.to(cache["k"].dtype)
    cache["v"][:, :S] = v_new.to(cache["v"].dtype)
    h = torch.einsum("bshk,hkd->bsd", o, p["attn"]["wo"].to(h.dtype))
    x = x + h
    h, aux = _ffn(cfg, dist, p, rmsnorm(x, p["ln2"], cfg.norm_eps),
                  moe_mode, moe_chunks)
    return x + h, cache, aux


def block_decode(cfg: ModelConfig, dist: Optional[DistCtx], p: dict,
                 x: Tensor, cache: dict, pos: int, *,
                 moe_mode: str = "ll") -> tuple[Tensor, dict, dict]:
    """One-token decode: x (B, 1, D) at position ``pos``."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    q, k_new, v_new = decode_qkv(cfg, p["attn"], h, pos)
    cache["k"][:, pos] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, pos] = v_new[:, 0].to(cache["v"].dtype)
    part = decode_attention_local(q, cache["k"], cache["v"], pos)
    l = torch.where(part.l == 0, 1.0, part.l)
    o = (part.o / l[..., None]).to(h.dtype)
    h = torch.einsum("bshk,hkd->bsd", o, p["attn"]["wo"].to(h.dtype))
    x = x + h
    h, aux = _ffn(cfg, dist, p, rmsnorm(x, p["ln2"], cfg.norm_eps),
                  moe_mode, 1)
    return x + h, cache, aux


def vocab_embed(embed: Tensor, tokens: Tensor) -> Tensor:
    """tokens (B, S) -> (B, S, D)."""
    return embed[tokens]
