"""Model init, the training forward and loss, cache, prefill and decode
(the port of ``repro.models.model_zoo``).

The JAX package stacks each layer slot's parameters over ``n_periods`` and
scans them; here ``params["blocks"]`` is a list of per-layer dicts and a
Python loop runs them.  With ``cfg.remat`` the training forward recomputes
each layer in the backward (``torch.utils.checkpoint``, the counterpart of
the reference's ``jax.checkpoint`` per period).  ``loss_fn`` takes fp32
parameters and casts them to the compute dtype inside the graph, each step,
as the reference does; for serving, ``cast_params`` casts once, at load,
and ``prefill`` and ``decode_step`` take parameters already cast.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import DistCtx, scan_period
from repro_torch.kernels import ops
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
    soon as it is made, and each MoE expert weight as soon as it is made,
    which keeps the fp32 peak to one layer's dense weights or one expert
    weight."""
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
    if not cfg.tie_embeddings:
        params["lm_head"] = done(torch.randn((d, vp), generator=gen,
                                             device=device) / math.sqrt(d),
                                 "lm_head")
    params["blocks"] = [done(B.block_init(cfg, i, gen, device, dtype))
                        for i in range(cfg.n_layers)]
    return params


def lm_head_weight(cfg: ModelConfig, params: dict) -> Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


# --------------------------------------------------------------- forward --
def forward(cfg: ModelConfig, params: dict, tokens: Tensor,
            prefix_embeds: Optional[Tensor] = None, *,
            dist: Optional[DistCtx] = None, moe_mode: str = "ht",
            moe_chunks: int = 1, causal_skip: bool = False,
            moe_backend=None) -> tuple[Tensor, dict]:
    """tokens (B, S_txt) [+ prefix_embeds (B, S_pre, D), cast to the
    activation dtype and put before the token embeddings, positions running
    over both] -> hidden (B, S, D), aux: ``aux_loss`` summed over layers,
    ``dropped`` as the reference reads it (each scan period's dropped
    fractions summed, then the mean over periods; 0 without MoE), and
    ``loads``, each MoE layer's expert loads by layer index.
    ``moe_backend``: a backend name or instance shared by every MoE layer
    (default ``cfg.moe.ep_backend``): one ``simulated_rdma`` instance with
    ``session_layers`` set registers its transport state once a step."""
    x = B.vocab_embed(params["embed"], tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None].expand(x.shape[0], S)
    layer = functools.partial(B.block_apply, cfg, dist, moe_mode=moe_mode,
                              moe_chunks=moe_chunks, causal_skip=causal_skip,
                              moe_backend=moe_backend)
    aux_loss = torch.zeros((), dtype=torch.float32, device=x.device)
    _, n_periods = scan_period(cfg)
    dropped = torch.zeros((), dtype=torch.float32, device=x.device)
    loads = {}
    for i, p in enumerate(params["blocks"]):
        if cfg.remat:
            x, aux = checkpoint(layer, p, x, positions, use_reentrant=False)
        else:
            x, aux = layer(p, x, positions)
        if "aux_loss" in aux:
            aux_loss = aux_loss + aux["aux_loss"]
        if "dropped" in aux:
            dropped = dropped + aux["dropped"]
        if "load" in aux:
            loads[i] = aux["load"]
    x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    return x, {"aux_loss": aux_loss, "dropped": dropped / n_periods,
               "loads": loads}


def loss_fn(cfg: ModelConfig, params: dict, tokens: Tensor, labels: Tensor,
            prefix_embeds: Optional[Tensor] = None, *,
            dist: Optional[DistCtx] = None, moe_mode: str = "ht",
            moe_chunks: int = 1, causal_skip: bool = False,
            loss_chunk: int = 2048, moe_backend=None) -> tuple[Tensor, dict]:
    """Next-token cross entropy over a seq-chunked head, plus the routers'
    aux loss.  ``params`` are fp32; they are cast to ``cfg.dtype`` here,
    inside the graph, so their gradients come back in fp32.  The prefix
    positions (``prefix_embeds``) carry no label: their hidden states are
    dropped before the head."""
    dtype = compute_dtype(cfg)
    x, aux = forward(cfg, cast_params(params, dtype), tokens, prefix_embeds,
                     dist=dist, moe_mode=moe_mode, moe_chunks=moe_chunks,
                     causal_skip=causal_skip, moe_backend=moe_backend)
    head = lm_head_weight(cfg, params).to(dtype)
    if prefix_embeds is not None:
        x = x[:, prefix_embeds.shape[1]:]
    total, count = _chunked_xent(cfg, x, head, labels, loss_chunk)
    xent = total / torch.clamp(count, min=1.0)
    loss = xent + aux["aux_loss"]
    metrics = {"xent": xent, "aux_loss": aux["aux_loss"],
               "dropped": aux["dropped"],
               "loads": {i: l.detach() for i, l in aux["loads"].items()}}
    return loss, metrics


def _chunked_xent(cfg: ModelConfig, x: Tensor, head: Tensor, labels: Tensor,
                  chunk: int) -> tuple[Tensor, Tensor]:
    """(sum of token losses, count of labelled tokens); a label < 0 is
    unlabelled.  Logits beyond the real vocab are masked out."""
    _, S, _ = x.shape
    V = head.shape[1]
    chunk = min(chunk, S)
    real = torch.arange(V, device=x.device) < cfg.vocab_size
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(-(-S // chunk)):
        sl = slice(c * chunk, min((c + 1) * chunk, S))
        xc, yc = x[:, sl], labels[:, sl]
        logits = (xc @ head).to(torch.float32)
        logits = torch.where(real, logits, float("-inf"))
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            yc.clamp(min=0).to(torch.int64)[..., None])[..., 0]
        ok = (yc >= 0).to(torch.float32)
        total = total + ((lse - gold) * ok).sum()
        count = count + ok.sum()
    return total, count


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> list:
    """Each layer's decode cache (:func:`blocks.block_init_cache`): K/V for
    an attention layer, the latent rows for an MLA one, the conv history
    and ssm state for a Mamba one.  Sets the gauge
    ``serve.cache_bytes_per_token``: the bytes the cache made holds a
    position of a sequence, over every layer (the entries of
    ``blocks.PER_TOKEN``)."""
    cache = [B.block_init_cache(cfg, i, batch, max_len, dtype, device)
             for i in range(cfg.n_layers)]
    per_token = sum(t.numel() * t.element_size() for layer in cache
                    for k, t in layer.items() if k in B.PER_TOKEN)
    tracing.gauge("serve.cache_bytes_per_token",
                  per_token // max(1, batch * max_len))
    return cache


def reset_cache(cache: list) -> list:
    """Zero every tensor of ``cache`` in place, KV and recurrent state
    alike: a cache as :func:`init_cache` made it, at the same addresses (a
    captured decode step's)."""
    for layer in cache:
        for t in layer.values():
            t.zero_()
    return cache


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
    "dropped_per_layer"}`` (see :func:`_dropped`).  Attention-only stacks:
    a model with Mamba layers runs its prompt through :func:`decode_step`,
    as the reference's does."""
    if cfg.mamba.enabled:
        raise NotImplementedError("mamba prefill goes through decode_step")
    x = B.vocab_embed(params["embed"], tokens)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None].expand(x.shape[0], S)
    auxes = []
    for p, c in zip(params["blocks"], cache):
        x, _, aux = B.block_prefill(cfg, dist, p, x, c, positions,
                                    moe_mode=moe_mode)
        auxes.append(aux)
    x = ops.rmsnorm(x, params["final_ln"], cfg.norm_eps)
    logits = (x[:, -1] @ lm_head_weight(cfg, params)).to(torch.float32)
    return logits, cache, _dropped(auxes, x.device)


def decode_step(cfg: ModelConfig, params: dict, cache: list, tokens: Tensor,
                pos, *, dist: Optional[DistCtx] = None,
                moe_mode: str = "ll") -> tuple[Tensor, list, dict]:
    """One decode step: tokens (B, 1) at position ``pos`` (same for the
    batch), an int or a 0-d int32 tensor on the tokens' device, as the
    reference's takes ``jnp.int32(t)``.  Nothing of the step reads ``pos``
    on the host, so a CUDA graph captures it with ``pos`` in a static
    buffer (``launch.serve.capture_decode_step``).  Runs any stack of
    attention and Mamba layers, each with its own cache (:func:`init_cache`),
    updated in place.  Returns (logits (B, V_pad) fp32, cache, ``{"dropped",
    "dropped_per_layer"}``)."""
    x = B.vocab_embed(params["embed"], tokens)
    if not isinstance(pos, Tensor):
        # a fill on the device: no copy from the host, no synchronise
        pos = torch.full((), pos, dtype=torch.int32, device=x.device)
    auxes = []
    for p, c in zip(params["blocks"], cache):
        x, _, aux = B.block_decode(cfg, dist, p, x, c, pos,
                                   moe_mode=moe_mode)
        auxes.append(aux)
    x = ops.rmsnorm(x, params["final_ln"], cfg.norm_eps)
    logits = (x[:, 0] @ lm_head_weight(cfg, params)).to(torch.float32)
    return logits, cache, _dropped(auxes, x.device)
