"""The plain reference of an EP training step: the loss, its gradients by
autograd through :mod:`epbench.reference.model` (HT capacity rule,
fp32), global-norm clipping, AdamW with bias-corrected moments and
decoupled weight decay, the warm-up/cosine learning rate, and the
aux-loss-free router-bias rule (a step of ``router_bias_lr`` against each
real expert's excess load).  Frozen copies of the rules; nothing of the
port imported.
"""
from __future__ import annotations

import math

import torch

from epbench.reference import model as M

F32 = torch.float32


def lr_at(step: int, peak: float, warmup: int, total: int,
          floor_frac: float = 0.1) -> float:
    """Linear warm-up from peak / warmup, then cosine to floor_frac * peak
    (computed in float32)."""
    s = torch.tensor(float(step), dtype=F32)
    if step < warmup:
        return float(peak * (s + 1.0) / max(warmup, 1))
    t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    return float(peak * (floor_frac + (1 - floor_frac) * 0.5
                         * (1 + torch.cos(math.pi * t))))


def loss(W: dict, tokens, labels, sz: dict, precision: str,
         stats: dict) -> torch.Tensor:
    """Mean next-token cross entropy over the real vocabulary, plus every
    layer's router aux loss (each the mean over the EP ranks)."""
    h = M.hidden(W, tokens, sz, "ht", precision, stats)
    B, S, D = h.shape
    total = torch.zeros((), dtype=F32, device=h.device)
    for b in range(B):
        logits = M.head(W, h[b], sz, precision)
        total = total + torch.nn.functional.cross_entropy(
            logits, labels[b].long(), reduction="sum")
    return total / (B * S) + torch.stack(stats["aux"]).sum()


def run(initial, batches: list, sz: dict, hp: dict, steps: int = 3,
        precision: str = "fp32", others: list | None = None,
        keep: bool = False) -> dict:
    """``steps`` optimizer steps from the parameters ``initial()`` makes
    (a fresh tree of fp32 leaves in the port's layout; called again for
    the change) on ``batches`` [(tokens, labels)].  Returns each step's
    loss, each leaf's norm of the first (clipped) gradient, and each
    leaf's norm of its change after the steps, by path.  ``others``:
    other runs' tensors ({"first": {path: gradient}, "final": {path:
    parameters}}, on any device); for each, every leaf's norm of the
    difference from them (``grad_diff``, ``final_diff``).  ``keep``: this
    run's own such tensors, on the host (``tensors``).  ``dropped``: the
    first step's share of choices its HT capacity drops, over the
    layers."""
    from epbench.weights import leaves
    others = others or []
    gdiff = [{} for _ in others]
    fdiff = [{} for _ in others]
    mine = {"first": {}, "final": {}}
    W = initial()
    named = leaves(W)
    for _, p in named:
        p.requires_grad_(True)
    mu = [torch.zeros_like(p) for _, p in named]
    nu = [torch.zeros_like(p) for _, p in named]
    b1, b2, eps, wd = hp["b1"], hp["b2"], 1e-8, hp["weight_decay"]
    losses, first = [], {}
    for i in range(steps):
        stats: dict = {}
        tokens, labels = batches[i]
        L = loss(W, tokens, labels, sz, precision, stats)
        grads = torch.autograd.grad(L, [p for _, p in named],
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for (_, p), g in zip(named, grads)]
        losses.append(float(L.detach()))
        with torch.no_grad():
            gnorm = torch.sqrt(sum((g * g).sum() for g in grads))
            scale = torch.clamp(hp["max_grad_norm"] / (gnorm + 1e-9),
                                max=1.0)
            if i == 0:
                gnorm0 = float(gnorm)
                dropped0 = float(torch.stack(stats["dropped"]).mean())
            lr = lr_at(i, hp["peak_lr"], hp["warmup"], hp["total_steps"])
            c1, c2 = 1.0 - b1 ** (i + 1), 1.0 - b2 ** (i + 1)
            for j, ((path, p), g) in enumerate(zip(named, grads)):
                g = g * scale
                if i == 0:
                    first[path] = float(g.norm())
                    for k, o in enumerate(others):
                        gdiff[k][path] = float(
                            (g - o["first"][path].to(g.device)).norm())
                    if keep:
                        mine["first"][path] = g.cpu()
                mu[j].mul_(b1).add_(g, alpha=1 - b1)
                nu[j].mul_(b2).addcmul_(g, g, value=1 - b2)
                u = (mu[j] / c1) / (torch.sqrt(nu[j] / c2) + eps)
                p.sub_(lr * (u + wd * p))
            for layer, load in enumerate(stats["loads"]):
                b = W["blocks"][layer]["moe"].get("router_b")
                if b is None:
                    continue
                n = sz["n_experts"]
                real = torch.arange(load.shape[0], device=load.device) < n
                load = load.to(F32)
                err = torch.where(real, load.sum() / n - load, 0.0)
                b.add_(hp["router_bias_lr"] * torch.sign(err))
        del grads, L, stats
    del mu, nu
    with torch.no_grad():
        theta = {path: p.detach() for path, p in named}
        del W, named
        change = {}
        for path, p0 in initial_leaves_of(initial):
            change[path] = float((theta[path] - p0).norm())
            for k, o in enumerate(others):
                fdiff[k][path] = float(
                    (theta[path] - o["final"][path].to(p0.device)).norm())
            if keep:
                mine["final"][path] = theta[path].cpu()
            del p0
    out = {"losses": losses, "grad_norms": first, "change_norms": change,
           "grad_diff": gdiff, "final_diff": fdiff, "gnorm": gnorm0,
           "dropped": dropped0}
    if keep:
        out["tensors"] = mine
    return out


def initial_leaves_of(initial):
    """(path, tensor) of the initial parameters, one leaf at a time where
    ``initial`` offers that (``initial.leaves``), else from a whole tree."""
    from epbench.weights import leaves
    if hasattr(initial, "leaves"):
        yield from initial.leaves()
        return
    yield from leaves(initial())
