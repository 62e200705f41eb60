"""Multi-head latent attention (DeepSeek-V2/V3, as Moonlight-16B-A3B
publishes it): the port's own, since the JAX package has no MLA.

A token's hidden state x (d) gives its queries directly, ``q = x @ wq``
(H heads of ``qk_nope_head_dim + qk_rope_head_dim``, q_lora_rank null),
and one compressed row ``x @ w_dkv`` of ``kv_lora_rank + qk_rope_head_dim``
values: the latent c, normalised by ``kv_norm`` (RMSNorm), and the RoPE
key k_pe, which all heads share.  The heads' keys and values are
expanded from the latent, ``c @ w_ukv`` (``kv_lora_rank``, H, nope + v):
head h's key is [k_nope_h, k_pe], its value v_h.  RoPE (theta
``rope_theta``, on the two halves, as the port's other models) rotates
q's and k's RoPE parts alone; the softmax scale is 1 / sqrt(nope + rope).

Parameters in the port's JAX-style layout, under a layer's ``attn``:
``wq`` (d, H, nope + rope), ``w_dkv`` (d, kv_lora_rank + rope),
``kv_norm`` (kv_lora_rank,) fp32, ``w_ukv`` (kv_lora_rank, H, nope + v),
``wo`` (H, v, d).

- Training and prefill (:func:`mla_attention`, from
  ``blocks.block_apply`` and ``block_prefill``) expand the keys and values
  and run the port's plain blocked attention
  (``layers.flash_attention_blocked``), the values padded with zeros to
  the key width (the padding adds nothing to the output, which is cut
  back to v).  Prefill writes the latent rows of positions 0..S-1 into
  the layer's cache.
- Decode (:func:`mla_decode`) never expands them: the cache holds one row
  a position, ``latent`` (B, S_max, kv_lora_rank + rope) = [c, k_pe]
  (1,152 bytes at Moonlight's widths in bf16, against 8,192 for its
  expanded K and V), W_uk is absorbed into the query (q_nope . W_uk_h,
  kv_lora_rank wide), the attention runs over the latent rows themselves
  (``ops.mla_decode``: scores over all kv_lora_rank + rope columns, the
  output over the first kv_lora_rank), and W_uv then ``wo`` follow.
  ``pos`` stays a 0-d int32 tensor on the device, so the step captures in
  one CUDA graph.

Spans (``repro_torch.tracing``): ``mla.project``, ``mla.attend`` and
``mla.out`` in eager steps (a replayed graph records none).
"""
from __future__ import annotations

import math

import torch

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_rope, flash_attention_blocked,
                                       rmsnorm, rmsnorm_init)

Tensor = torch.Tensor


def mla_init(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    c, r = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    nope, v = cfg.qk_nope_head_dim, cfg.v_head_dim

    def mk(shape, fan_in):
        return torch.randn(shape, generator=gen, device=device) / math.sqrt(
            fan_in)
    return {"wq": mk((d, h, nope + r), d), "w_dkv": mk((d, c + r), d),
            "kv_norm": rmsnorm_init(c, device),
            "w_ukv": mk((c, h, nope + v), c), "wo": mk((h, v, d), h * v)}


def cache_width(cfg: ModelConfig) -> int:
    """Values of a latent cache row: the latent and the RoPE key."""
    return cfg.kv_lora_rank + cfg.qk_rope_head_dim


def softmax_scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def _project(cfg: ModelConfig, p: dict, x: Tensor, positions: Tensor,
             norm) -> tuple[Tensor, Tensor]:
    """x (B, S, d) -> q (B, S, H, nope + rope) with RoPE on its last
    ``rope`` values, and the latent rows (B, S, kv_lora_rank + rope):
    ``norm``(c) and the RoPE'd k_pe."""
    dt = x.dtype
    c_w, r = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    nope = cfg.qk_nope_head_dim
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    q = torch.cat([q[..., :nope],
                   apply_rope(q[..., nope:], positions, cfg.rope_theta)], -1)
    kv = x @ p["w_dkv"].to(dt)
    c = norm(kv[..., :c_w].contiguous(), p["kv_norm"], cfg.norm_eps)
    k_pe = apply_rope(kv[..., None, c_w:], positions, cfg.rope_theta)
    return q, torch.cat([c, k_pe[..., 0, :].to(c.dtype)], -1)


def _expanded_attention(cfg: ModelConfig, p: dict, q: Tensor, rows: Tensor,
                        causal_skip: bool = False) -> Tensor:
    """The non-absorbed attention over latent rows (B, S, c + rope): keys
    [k_nope, k_pe] and values expanded per head -> (B, S, H, v)."""
    H, c_w = cfg.n_heads, cfg.kv_lora_rank
    nope, v = cfg.qk_nope_head_dim, cfg.v_head_dim
    ukv = torch.einsum("bsc,chk->bshk", rows[..., :c_w],
                       p["w_ukv"].to(rows.dtype))
    k_pe = rows[..., None, c_w:].expand(-1, -1, H, -1)
    k = torch.cat([ukv[..., :nope], k_pe], -1)
    vals = torch.nn.functional.pad(ukv[..., nope:], (0, k.shape[-1] - v))
    blk = min(512, q.shape[1])
    o = flash_attention_blocked(q, k, vals, causal=True, q_block=blk,
                                kv_block=blk, causal_skip=causal_skip)
    return o[..., :v]


def mla_attention(cfg: ModelConfig, p: dict, x: Tensor, positions: Tensor,
                  *, causal_skip: bool = False, norm=rmsnorm,
                  latent: Tensor | None = None) -> Tensor:
    """Self-attention over the whole sequence: (B, S, d_model) -> (B, S,
    d_model), the latent's norm through ``norm`` (training: the model's own
    tensor code; prefill: ``ops.rmsnorm``).  With ``latent`` (B, S_max,
    c + rope), the prefill's cache, the rows of positions 0..S-1 are
    written there."""
    with tracing.span("mla.project"):
        q, rows = _project(cfg, p, x, positions, norm)
        if latent is not None:
            latent[:, :x.shape[1]] = rows.to(latent.dtype)
    with tracing.span("mla.attend"):
        o = _expanded_attention(cfg, p, q, rows, causal_skip)
    with tracing.span("mla.out"):
        return torch.einsum("bshv,hvd->bsd", o, p["wo"].to(x.dtype))


def mla_decode(cfg: ModelConfig, p: dict, x: Tensor, latent: Tensor,
               pos: Tensor) -> Tensor:
    """One token a sequence, x (B, 1, d) at position ``pos`` (a 0-d int32
    tensor on x's device, never read on the host): its latent row written
    at ``pos`` (``index_copy_``), W_uk absorbed into the query, attention
    over the cache's rows 0..pos (``ops.mla_decode``), then W_uv and
    ``wo`` -> (B, 1, d)."""
    dt = x.dtype
    c_w, nope = cfg.kv_lora_rank, cfg.qk_nope_head_dim
    with tracing.span("mla.project"):
        positions = pos.reshape(1, 1).expand(x.shape[0], 1)
        q, row = _project(cfg, p, x, positions, ops.rmsnorm)
        latent.index_copy_(1, pos.reshape(1).to(torch.int64),
                           row.to(latent.dtype))
        w_ukv = p["w_ukv"].to(dt)
        q_lat = torch.einsum("bhn,chn->bhc", q[:, 0, :, :nope],
                             w_ukv[..., :nope])
        q_abs = torch.cat([q_lat, q[:, 0, :, nope:]], -1).contiguous()
    with tracing.span("mla.attend"):
        o = ops.mla_decode(q_abs, latent, pos, scale=softmax_scale(cfg),
                           v_dim=c_w)
    with tracing.span("mla.out"):
        o = torch.einsum("bhc,chv->bhv", o, w_ukv[..., nope:])
        return torch.einsum("bhv,hvd->bd", o, p["wo"].to(dt))[:, None]
