"""Transformer and Mamba blocks: the training ``block_apply`` and the
local-cache prefill and decode of ``repro.models.blocks``.

A layer's parameters are a dict in the JAX layout (``ln1``, ``ln2``,
``attn`` or ``mamba``, ``moe`` or ``mlp``).  Its decode cache is a dict
too: an attention layer's ``{"k", "v"}``, two ``(B, S_max, Hkv, hd)``
tensors, a Mamba layer's ``{"conv", "ssm"}`` (``mamba_init_cache``);
prefill and decode update it in place.  (The reference's ``BlockCache``
carries both kinds in every layer, the unused ones as placeholders.)
Training (``block_apply``) computes its norms and attention in the
model's own tensor code, as the reference does; prefill
and decode run them through ``kernels.ops`` (RMSNorm, flash attention,
flash decoding), whose CUDA kernels have no backward.  The reference's
mesh constraints and its ``sp_islands`` shard_map islands place tensors on
a TPU mesh; they have no counterpart on one card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.moe import moe_apply, moe_init
from repro_torch.distributed.sharding import DistCtx
from repro_torch.kernels import ops
from repro_torch.models.layers import (_qkv, attention, attn_init, decode_qkv,
                                       mlp_init, rmsnorm, rmsnorm_init,
                                       swiglu)
from repro_torch.models.mamba import (MambaCache, mamba_apply,
                                      mamba_decode_step, mamba_init,
                                      mamba_init_cache)

Tensor = torch.Tensor


def block_init(cfg: ModelConfig, layer_idx: int, gen: torch.Generator,
               device, dtype: Optional[torch.dtype] = None) -> dict:
    """Layer ``layer_idx``'s parameters in fp32; with ``dtype``, the MoE
    experts' weights are made in it (``moe_init``)."""
    p: dict = {"ln1": rmsnorm_init(cfg.d_model, device),
               "ln2": rmsnorm_init(cfg.d_model, device)}
    if cfg.is_attn_layer(layer_idx):
        p["attn"] = attn_init(cfg, gen, device)
    elif cfg.mamba.enabled:
        p["mamba"] = mamba_init(cfg, gen, device)
    if cfg.is_moe_layer(layer_idx):
        p["moe"] = moe_init(cfg, gen, device, dtype)
    elif cfg.d_ff:
        p["mlp"] = mlp_init(cfg.d_model, cfg.d_ff, gen, device)
    return p


def block_init_cache(cfg: ModelConfig, layer_idx: int, batch: int,
                     max_len: int, dtype=torch.bfloat16,
                     device="cuda") -> dict:
    """Layer ``layer_idx``'s decode cache: ``{"k", "v"}`` for an attention
    layer, ``{"conv", "ssm"}`` for a Mamba layer (no KV cache)."""
    if cfg.is_attn_layer(layer_idx):
        shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    return mamba_init_cache(cfg, batch, dtype, device)._asdict()


def _ffn(cfg, dist, p, h, mode, chunks, backend=None):
    if "moe" in p:
        return moe_apply(cfg, dist, p["moe"], h, mode=mode, chunks=chunks,
                         backend=backend)
    if "mlp" in p:
        return swiglu(p["mlp"], h), {}
    return torch.zeros_like(h), {}


def block_apply(cfg: ModelConfig, dist: Optional[DistCtx], p: dict,
                x: Tensor, positions: Tensor, *, moe_mode: str = "ht",
                moe_chunks: int = 1, causal_skip: bool = False,
                moe_backend=None) -> tuple[Tensor, dict]:
    """Training/prefill block: x (B, S, D) residual -> (x', aux).

    ``moe_backend``: a backend name or :class:`EPBackend` instance handed to
    :func:`moe_apply` (default ``cfg.moe.ep_backend``); a model passes one
    instance to all its blocks for the persistent-session path
    (registration once per step, DESIGN §16)."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if "attn" in p:
        h = attention(cfg, p["attn"], h, positions, causal_skip=causal_skip)
    elif "mamba" in p:
        h = mamba_apply(cfg, p["mamba"], h)
    x = x + h
    h, aux = _ffn(cfg, dist, p, rmsnorm(x, p["ln2"], cfg.norm_eps),
                  moe_mode, moe_chunks, moe_backend)
    return x + h, aux


def block_prefill(cfg: ModelConfig, dist: Optional[DistCtx], p: dict,
                  x: Tensor, cache: dict, positions: Tensor, *,
                  moe_mode: str = "ht",
                  moe_chunks: int = 1) -> tuple[Tensor, dict, dict]:
    """Batched prompt prefill: x (B, S, D) -> (x', cache, aux); the
    projected k/v land in ``cache[:, :S]``."""
    if "mamba" in p:
        raise NotImplementedError(
            "batched prefill needs the post-prompt recurrent state; mamba "
            "layers prefill through the per-token decode loop")
    h = ops.rmsnorm(x, p["ln1"], cfg.norm_eps)
    q, k_new, v_new = _qkv(cfg, p["attn"], h, positions, norm=ops.rmsnorm)
    S = x.shape[1]
    o = ops.flash_attention(q, k_new, v_new, causal=True)
    cache["k"][:, :S] = k_new.to(cache["k"].dtype)
    cache["v"][:, :S] = v_new.to(cache["v"].dtype)
    h = torch.einsum("bshk,hkd->bsd", o, p["attn"]["wo"].to(h.dtype))
    x = x + h
    h, aux = _ffn(cfg, dist, p, ops.rmsnorm(x, p["ln2"], cfg.norm_eps),
                  moe_mode, moe_chunks)
    return x + h, cache, aux


def block_decode(cfg: ModelConfig, dist: Optional[DistCtx], p: dict,
                 x: Tensor, cache: dict, pos: Tensor, *,
                 moe_mode: str = "ll") -> tuple[Tensor, dict, dict]:
    """One-token decode: x (B, 1, D) at position ``pos``, a 0-d int32
    tensor on x's device that nothing here reads on the host (so a CUDA
    graph can capture the step and replay it at any position).  A Mamba
    layer reads no position: its state is the step count."""
    h = ops.rmsnorm(x, p["ln1"], cfg.norm_eps)
    if "attn" in p:
        q, k_new, v_new = decode_qkv(cfg, p["attn"], h, pos,
                                     norm=ops.rmsnorm)
        row = pos.reshape(1).to(torch.int64)
        cache["k"].index_copy_(1, row, k_new.to(cache["k"].dtype))
        cache["v"].index_copy_(1, row, v_new.to(cache["v"].dtype))
        # the whole cache: the kernel reads only positions 0..pos
        o = ops.decode_attention(q[:, 0], cache["k"], cache["v"],
                                 pos)[:, None]
        h = torch.einsum("bshk,hkd->bsd", o, p["attn"]["wo"].to(h.dtype))
    elif "mamba" in p:
        h, _ = mamba_decode_step(cfg, p["mamba"], h,
                                 MambaCache(cache["conv"], cache["ssm"]))
    x = x + h
    h, aux = _ffn(cfg, dist, p, ops.rmsnorm(x, p["ln2"], cfg.norm_eps),
                  moe_mode, 1)
    return x + h, cache, aux


def vocab_embed(embed: Tensor, tokens: Tensor) -> Tensor:
    """tokens (B, S) -> (B, S, D)."""
    return embed[tokens]
