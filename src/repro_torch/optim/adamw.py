"""AdamW and its factored-second-moment variant (adafactor-style): the port
of ``repro.optim.adamw``.

State layouts follow the parameter tree (nested dicts and lists of
tensors).  The optimizer state stays fp32.  :func:`apply_updates` updates
the parameters and the moments IN PLACE (under ``torch.no_grad``), where the
reference returns new arrays: at full width that saves a copy of every
parameter and moment.  It returns the same containers.  On the card the
non-factored update is the hand-written kernel ``kernels.optim.adamw_cuda``
(a pass for the norm, one a leaf for the update); :func:`adamw_leaf` is its
plain version, the eager chain the CPU runs.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

Tensor = torch.Tensor


class AdamWState(NamedTuple):
    step: Tensor    # int32 scalar (on the CPU)
    mu: dict
    nu: dict        # full second moment (adamw) or factored dicts (adafactor)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the tensors of ``tree``; ``rest`` are trees of the same
    structure down to ``tree``'s leaves (a leaf of ``rest`` may be a dict,
    as a factored second moment is)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_items(tree):
    """(key, child) pairs of a NamedTuple, dict, list or tuple node; None
    for a leaf."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def tree_leaves(tree) -> list[Tensor]:
    out: list = []
    tree_map(out.append, tree)
    return out


def _is_factorable(x: Tensor) -> bool:
    return x.dim() >= 2 and x.shape[-1] >= 128 and x.shape[-2] >= 128


def init_state(params: dict, *, factored: bool = False) -> AdamWState:
    f32 = torch.float32
    mu = tree_map(lambda p: torch.zeros_like(p, dtype=f32), params)
    if not factored:
        nu = tree_map(lambda p: torch.zeros_like(p, dtype=f32), params)
    else:
        def f(p):
            if _is_factorable(p):
                return {"row": torch.zeros(p.shape[:-1], dtype=f32,
                                           device=p.device),
                        "col": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                           dtype=f32, device=p.device)}
            return {"full": torch.zeros_like(p, dtype=f32)}
        nu = tree_map(f, params)
    return AdamWState(step=torch.zeros((), dtype=torch.int32), mu=mu, nu=nu)


def global_norm(tree) -> Tensor:
    return torch.sqrt(sum(torch.sum(l.to(torch.float32) ** 2)
                          for l in tree_leaves(tree)))


def _moments(g: Tensor, mu: Tensor, scale: Optional[Tensor],
             b1: float) -> Tensor:
    """The gradient in fp32 times the clip ``scale`` (none where it is
    None), and the first moment updated with it in place."""
    g = g.to(torch.float32)
    if scale is not None:
        g = g * scale
    mu.mul_(b1).add_(g, alpha=1 - b1)
    return g


@torch.no_grad()
def adamw_leaf(p: Tensor, g: Tensor, mu: Tensor, nu: Tensor,
               scale: Optional[Tensor], *, lr, c1, c2, b1: float, b2: float,
               eps: float, weight_decay: float) -> None:
    """The non-factored update of one leaf in place, its gradient first
    multiplied by the clip ``scale``: the eager chain, and the plain version
    of ``kernels.optim.adamw_cuda``.  ``c1`` and ``c2`` are the bias
    corrections ``1 - b ** step``."""
    g = _moments(g, mu, scale, b1)
    nu.mul_(b2).addcmul_(g, g, value=1 - b2)
    u = (mu / c1) / (torch.sqrt(nu / c2) + eps)
    p.sub_(lr * (u + weight_decay * p))


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: AdamWState, *,
                  lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                  weight_decay: float = 0.1, factored: bool = False,
                  max_grad_norm: Optional[float] = 1.0,
                  ) -> tuple[dict, AdamWState, dict]:
    """One step: global-norm clip, bias-corrected moments (factored second
    moment for leaves of at least 128 x 128 when ``factored``), decoupled
    weight decay.  ``params``, ``state.mu`` and ``state.nu`` change in
    place; returns ``(params, new state, {"grad_norm"})``.  Non-factored
    leaves on the card take the kernel, whose ``lr`` is a number or a CPU
    tensor."""
    step = state.step + 1
    stepf = step.to(torch.float32)
    c1 = 1.0 - b1 ** stepf
    c2 = 1.0 - b2 ** stepf
    hyper = dict(lr=lr, c1=c1, c2=c2, b1=b1, b2=b2, eps=eps,
                 weight_decay=weight_decay)
    leaves = tree_leaves(params)
    if not factored and leaves and leaves[0].is_cuda:
        # imported here: the kernels package loads the EP layers, which
        # import this module's tree helpers
        from repro_torch.kernels.optim import adamw_cuda
        quads: list = []
        tree_map(lambda *t: quads.append(t), params, grads, state.mu,
                 state.nu)
        gnorm = adamw_cuda(*map(list, zip(*quads)),
                           max_grad_norm=max_grad_norm, **hyper)
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu), \
            {"grad_norm": gnorm}
    gnorm = global_norm(grads)
    scale = None
    if max_grad_norm is not None:
        scale = torch.clamp(max_grad_norm / (gnorm + 1e-9), max=1.0)

    def upd_full(p, g, mu, nu):
        adamw_leaf(p, g, mu, nu, scale, **hyper)

    def upd_fact(p, g, mu, nu):
        g = _moments(g, mu, scale, b1)
        if "full" in nu:
            nu["full"].mul_(b2).addcmul_(g, g, value=1 - b2)
            v = nu["full"] / c2
        else:
            g2 = g * g
            row, col = nu["row"], nu["col"]
            row.mul_(b2).add_(g2.mean(-1), alpha=1 - b2)
            col.mul_(b2).add_(g2.mean(-2), alpha=1 - b2)
            rmean = row.mean(-1, keepdim=True)[..., None]
            v = (row[..., None] * col[..., None, :]) / torch.clamp(rmean,
                                                                 min=1e-30)
            v = v / c2
        u = (mu / c1) / (torch.sqrt(v) + eps)
        p.sub_(lr * (u + weight_decay * p))

    tree_map(upd_fact if factored else upd_full, params, grads, state.mu,
             state.nu)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), \
        {"grad_norm": gnorm}
