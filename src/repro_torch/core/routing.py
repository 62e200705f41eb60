"""MoE gating: top-k softmax router with an aux-loss-free bias and a
Switch load-balance loss (the port of ``repro.core.routing``).

``route`` takes tokens ``(..., T, d_model)``: a leading rank axis of the
rank-stacked EP world routes every rank's tokens in one call, and
``aux_loss`` then has that leading shape (one loss per rank, as each JAX
shard computes its own).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import MoEConfig

Tensor = torch.Tensor


class RouterParams(NamedTuple):
    w: Tensor                  # (d_model, E_padded) fp32
    bias: Optional[Tensor]     # (E_padded,) aux-loss-free balancing bias


class RouterOut(NamedTuple):
    top_idx: Tensor    # (..., T, K) int32 expert ids (padded expert space)
    top_w: Tensor      # (..., T, K) combine weights, in x.dtype
    probs: Tensor      # (..., T, E) router probabilities
    aux_loss: Tensor   # (...) Switch-style load-balance loss


def router_init(d_model: int, n_experts_padded: int, gen: torch.Generator,
                aux_free_bias: bool, device) -> RouterParams:
    w = torch.randn((d_model, n_experts_padded), generator=gen,
                    device=device) / math.sqrt(d_model)
    b = (torch.zeros((n_experts_padded,), device=device)
         if aux_free_bias else None)
    return RouterParams(w=w, bias=b)


def route(moe: MoEConfig, p: RouterParams, x: Tensor,
          n_experts_real: int) -> RouterOut:
    """x: (..., T, d_model).  Experts >= n_experts_real are padding."""
    e_pad = p.w.shape[1]
    logits = (x.to(torch.float32) @ p.w).to(torch.float32)
    if e_pad > n_experts_real:
        pad = torch.arange(e_pad, device=x.device) >= n_experts_real
        logits = logits.masked_fill(pad, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    # the bias shifts selection only; combine weights use the unbiased probs
    sel = logits if p.bias is None else logits + p.bias
    top_idx = torch.topk(sel, moe.top_k, dim=-1).indices
    top_p = torch.gather(probs, -1, top_idx)
    top_w = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    onehot = torch.nn.functional.one_hot(top_idx, e_pad).to(
        torch.float32).sum(-2)                                  # (..., T, E)
    f = onehot.mean(-2)
    pbar = probs.mean(-2)
    aux = n_experts_real * (f * pbar).sum(-1) * moe.aux_loss_weight
    return RouterOut(top_idx=top_idx.to(torch.int32),
                     top_w=top_w.to(x.dtype), probs=probs, aux_loss=aux)
