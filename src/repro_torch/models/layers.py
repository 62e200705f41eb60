"""Transformer layer primitives: RMSNorm, RoPE, GQA attention, SwiGLU (the
port of ``repro.models.layers``).

Parameters keep the JAX layouts: ``wq (d, H, hd)``, ``wk/wv (d, Hkv, hd)``,
``wo (H, hd, d)``, biases ``(H, hd)``, MLP ``w_gate/w_up (d, ff)``,
``w_down (ff, d)``, with ``qk_norm`` the per-head scales ``q_norm`` and
``k_norm (hd,)``; attention parameters are a dict with those keys.  The
training attention is plain PyTorch (einsum and the blocked online softmax
of the reference, with its hierarchical causal decomposition behind
``causal_skip``), as the JAX package computes it in jnp; the serving path
(``blocks.block_prefill`` / ``block_decode``) goes through the kernels of
``kernels.ops``.

The reference's parameter and cache named tuples (``AttnParams``,
``MLPParams``, ``KVCache``) are dicts with the same keys here (see
``blocks.py``).  Its ``decode_attention_local`` (the partial decode
attention of one cache slice, merged across a sequence-sharded cache by
the decode island of its ``blocks.py``) has no counterpart: one card holds
the whole cache, and decoding goes through ``kernels.ops.decode_attention``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.norm_attention import partial_softmax, rmsnorm_plain

Tensor = torch.Tensor


# ---------------------------------------------------------------- RMSNorm --
def rmsnorm_init(d: int, device) -> Tensor:
    return torch.ones((d,), dtype=torch.float32, device=device)


# the reference's jnp RMSNorm is the RMSNorm kernel's plain version: the
# training path computes it so; the serving path goes through ops.rmsnorm
rmsnorm = rmsnorm_plain


# ------------------------------------------------------------------- RoPE --
def rope_freqs(head_dim: int, theta: float, device=None) -> Tensor:
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / head_dim))


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (..., S, H, D); positions broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs       # (..., S, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- Attention --
def attn_init(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    s, so = 1.0 / math.sqrt(d), 1.0 / math.sqrt(h * hd)

    def mk(shape, sc):
        return torch.randn(shape, generator=gen, device=device) * sc

    p = {"wq": mk((d, h, hd), s), "wk": mk((d, hkv, hd), s),
         "wv": mk((d, hkv, hd), s), "wo": mk((h, hd, d), so)}
    if cfg.qkv_bias:
        for k, n in (("bq", h), ("bk", hkv), ("bv", hkv)):
            p[k] = torch.zeros((n, hd), device=device)
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, device)
        p["k_norm"] = rmsnorm_init(hd, device)
    return p


def _qkv(cfg: ModelConfig, p: dict, x: Tensor, positions: Tensor, *,
         norm=rmsnorm):
    """Projections, biases, the per-head ``qk_norm`` (through ``norm``:
    ``ops.rmsnorm`` when serving, :func:`rmsnorm` in training), RoPE."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if "q_norm" in p:
        q = norm(q, p["q_norm"], cfg.norm_eps)
        k = norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def decode_qkv(cfg: ModelConfig, p: dict, x: Tensor, pos: Tensor, *,
               norm=rmsnorm):
    """x: (B, 1, d) new token at position ``pos`` (a 0-d integer tensor on
    x's device, not read on the host)."""
    positions = pos.reshape(1, 1).expand(x.shape[0], 1)
    return _qkv(cfg, p, x, positions, norm=norm)


class _POut(NamedTuple):
    o: Tensor   # (B, S, H, Dh) fp32, un-normalised numerator
    m: Tensor   # (B, S, H) running max
    l: Tensor   # (B, S, H) running denominator


def _partial_attn(q, k, v, mask, scale) -> _POut:
    rep = q.shape[2] // k.shape[2]
    k = torch.repeat_interleave(k, rep, dim=2)
    v = torch.repeat_interleave(v, rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bqhk", q, k).to(torch.float32) * scale
    if mask is not None:
        s = torch.where(mask, s, float("-inf"))
    return _POut(*partial_softmax(s, v, "bqhk,bkhd->bqhd", v.dtype))


def flash_attention_blocked(q: Tensor, k: Tensor, v: Tensor, *,
                            causal: bool = True, q_block: int = 512,
                            kv_block: int = 512,
                            causal_skip: bool = False) -> Tensor:
    """Blocked attention with a running softmax, O(block^2) live memory.
    q: (B, Sq, H, Dh); k/v: (B, Skv, Hkv, Dh), H % Hkv == 0.
    ``causal_skip``: the hierarchical causal decomposition, which computes
    no fully-masked block (:func:`_causal_hierarchical`)."""
    if causal and causal_skip and q.shape[1] == k.shape[1]:
        return _causal_hierarchical(q, k, v, q_block)
    B, Sq, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if Sq % q_block or Skv % kv_block:
        raise ValueError(f"blocks ({q_block}, {kv_block}) must divide the "
                         f"sequence lengths ({Sq}, {Skv})")
    rep = H // Hkv
    scale = 1.0 / math.sqrt(Dh)
    nq, nk = Sq // q_block, Skv // kv_block
    dev = q.device
    outs = []
    for i in range(nq):
        qi = q[:, i * q_block:(i + 1) * q_block]
        o = torch.zeros((B, q_block, H, Dh), dtype=torch.float32, device=dev)
        m = torch.full((B, q_block, H), float("-inf"), device=dev)
        l = torch.zeros((B, q_block, H), device=dev)
        qpos = i * q_block + torch.arange(q_block, device=dev)
        for j in range(nk):
            if causal and j * kv_block > (i + 1) * q_block - 1:
                break   # fully masked block: adds exactly nothing
            kj = torch.repeat_interleave(
                k[:, j * kv_block:(j + 1) * kv_block], rep, dim=2)
            vj = torch.repeat_interleave(
                v[:, j * kv_block:(j + 1) * kv_block], rep, dim=2)
            s = torch.einsum("bqhd,bkhd->bqhk", qi, kj).to(torch.float32) * scale
            if causal:
                kpos = j * kv_block + torch.arange(kv_block, device=dev)
                mask = qpos[:, None] >= kpos[None, :]
                s = torch.where(mask[None, :, None, :], s, float("-inf"))
            mj = torch.maximum(m, s.amax(dim=-1))
            mj_safe = torch.where(torch.isneginf(mj), 0.0, mj)
            pj = torch.exp(s - mj_safe[..., None])
            corr = torch.exp(m - mj_safe)
            l = l * corr + pj.sum(dim=-1)
            o = o * corr[..., None] + torch.einsum(
                "bqhk,bkhd->bqhd", pj.to(vj.dtype), vj).to(torch.float32)
            m = mj
        l = torch.where(l == 0.0, 1.0, l)
        outs.append((o / l[..., None]).to(q.dtype))
    return torch.cat(outs, dim=1)


def merge_partials(parts: list[_POut]) -> Tensor:
    """LSE-merge partial attention results (flash-decoding combine)."""
    m = parts[0].m
    for p in parts[1:]:
        m = torch.maximum(m, p.m)
    o = torch.zeros_like(parts[0].o)
    l = torch.zeros_like(parts[0].l)
    for p in parts:
        c = torch.exp(torch.where(torch.isneginf(p.m), float("-inf"),
                                  p.m - m))
        o = o + p.o * c[..., None]
        l = l + p.l * c
    l = torch.where(l == 0.0, 1.0, l)
    return o / l[..., None]


def _causal_hierarchical(q: Tensor, k: Tensor, v: Tensor, block: int) -> Tensor:
    """Exact causal attention without fully-masked blocks: level 0 is the
    block diagonal (masked); at level k >= 1, stride 2^k * block, the upper
    half of each pair attends the lower half unmasked."""
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]
    scale = 1.0 / math.sqrt(Dh)
    nb = S // block
    if nb & (nb - 1):
        raise ValueError("hierarchical causal attention needs a power-of-two "
                         f"number of blocks, got {nb}")
    qb = q.reshape(B, nb, block, H, Dh)
    kb = k.reshape(B, nb, block, Hkv, Dh)
    vb = v.reshape(B, nb, block, Hkv, Dh)
    pos = torch.arange(block, device=q.device)
    dmask = (pos[:, None] >= pos[None, :])[None, :, None, :]
    parts = [[_partial_attn(qb[:, i], kb[:, i], vb[:, i], dmask, scale)]
             for i in range(nb)]
    level = 1
    while (1 << level) <= nb:
        span = 1 << level
        half = span // 2
        for start in range(0, nb, span):
            lo = slice(start, start + half)
            hi = slice(start + half, start + span)
            part = _partial_attn(qb[:, hi].reshape(B, -1, H, Dh),
                                 kb[:, lo].reshape(B, -1, Hkv, Dh),
                                 vb[:, lo].reshape(B, -1, Hkv, Dh), None, scale)
            for bi in range(half):
                sl = slice(bi * block, (bi + 1) * block)
                parts[start + half + bi].append(
                    _POut(part.o[:, sl], part.m[:, sl], part.l[:, sl]))
        level += 1
    outs = [merge_partials(ps).to(q.dtype) for ps in parts]
    return torch.cat(outs, dim=1).reshape(B, S, H, Dh)


def attention(cfg: ModelConfig, p: dict, x: Tensor, positions: Tensor, *,
              causal_skip: bool = False) -> Tensor:
    """Training/prefill self-attention: (B, S, d_model) -> (B, S, d_model)."""
    q, k, v = _qkv(cfg, p, x, positions)
    blk = min(512, x.shape[1])
    o = flash_attention_blocked(q, k, v, causal=True, q_block=blk,
                                kv_block=blk, causal_skip=causal_skip)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))


# ----------------------------------------------------------------- SwiGLU --
def mlp_init(d: int, ff: int, gen: torch.Generator, device) -> dict:
    s, so = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)
    return {"w_gate": torch.randn((d, ff), generator=gen, device=device) * s,
            "w_up": torch.randn((d, ff), generator=gen, device=device) * s,
            "w_down": torch.randn((ff, d), generator=gen, device=device) * so}


def swiglu(p: dict, x: Tensor) -> Tensor:
    dt = x.dtype
    g = x @ p["w_gate"].to(dt)
    u = x @ p["w_up"].to(dt)
    return (torch.nn.functional.silu(g) * u) @ p["w_down"].to(dt)
