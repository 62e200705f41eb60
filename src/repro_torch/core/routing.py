"""MoE gating: top-k softmax router with an aux-loss-free bias and a
Switch load-balance loss (the port of ``repro.core.routing``), and the
port's own sigmoid router (``MoEConfig.scoring``, DeepSeek-V3's
``noaux_tc`` with one group, which the JAX package lacks).

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
from repro_torch.core import plan as planlib

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
    """x: (..., T, d_model).  Experts >= n_experts_real are padding.

    ``moe.scoring`` "softmax": probabilities by softmax over the logits,
    the bias added to the logits for the selection, the top-k
    probabilities renormalised.  "sigmoid": scores by sigmoid of the fp32
    logits, the bias added to the scores for the selection, the chosen
    scores renormalised and multiplied by ``moe.routed_scale``; ``probs``
    (for the balance loss) are the scores over their sum."""
    e_pad = p.w.shape[1]
    logits = (x.to(torch.float32) @ p.w).to(torch.float32)
    pad = (torch.arange(e_pad, device=x.device) >= n_experts_real
           if e_pad > n_experts_real else None)
    if moe.scoring == "sigmoid":
        top_idx, top_w, probs = _sigmoid_top(moe, p, logits, pad)
    else:
        if pad is not None:
            logits = logits.masked_fill(pad, float("-inf"))
        probs = torch.softmax(logits, dim=-1)
        # the bias shifts selection only; combine weights use the unbiased
        # probs
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


def _sigmoid_top(moe: MoEConfig, p: RouterParams, logits: Tensor, pad):
    """(top_idx, top_w, probs) of the sigmoid rule (:func:`route`)."""
    scores = torch.sigmoid(logits)
    if pad is not None:
        scores = scores.masked_fill(pad, 0.0)
    sel = scores if p.bias is None else scores + p.bias
    if pad is not None:
        sel = sel.masked_fill(pad, float("-inf"))
    top_idx = torch.topk(sel, moe.top_k, dim=-1).indices
    top_s = torch.gather(scores, -1, top_idx)
    top_w = (top_s / torch.clamp(top_s.sum(-1, keepdim=True), min=1e-9)
             * moe.routed_scale)
    probs = scores / torch.clamp(scores.sum(-1, keepdim=True), min=1e-9)
    return top_idx, top_w, probs


def update_aux_free_bias(p: RouterParams, out, n_experts_real: int,
                         lr: float = 1e-3) -> RouterParams:
    """Post-step bias update that pushes the load toward uniform (the sign
    rule, DeepSeek-V3 style).  ``out`` is the router's output, or the
    (E_padded,) expert loads already counted from it (what the train loop
    keeps a layer)."""
    if p.bias is None:
        return p
    e_pad = p.bias.shape[0]
    load = (out if isinstance(out, Tensor)
            else planlib.expert_load(out.top_idx, e_pad))
    target = load.sum() / n_experts_real
    real = torch.arange(e_pad, device=load.device) < n_experts_real
    err = torch.where(real, target - load, 0.0)
    return p._replace(bias=p.bias + lr * torch.sign(err))
