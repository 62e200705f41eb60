"""Distribution context of the port: the rank-stacked EP world on one
device (the counterpart of ``repro.distributed.sharding.DistCtx``).

The JAX package maps a model onto a device mesh; on one card the only
distributed structure left is the EP world, whose P ranks sit on a leading
tensor axis (see :mod:`repro_torch.core.ep`).  ``DistCtx`` carries that
world's axes and sizes: ``("model",)`` for a one-level world, ``("pod",
"model")`` for the two-level hierarchy.

The reference's partition rules (``param_pspecs``, ``param_shardings``,
``cache_pspecs``, the batch and activation specs ``batch_spec`` and
``act_spec``, and the axis pickers ``effective_batch_axes`` and
``cache_seq_axes``) lay a model out over a device mesh; one card has no
mesh to lay them on, so they have no counterpart here.  The
one layout the port needs is that of the routed experts over the EP world
(:func:`ep_split_leaves`), which a re-mesh checks
(:mod:`repro_torch.distributed.elastic`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.optim.adamw import tree_items


@dataclass(frozen=True)
class DistCtx:
    """The world's axes and sizes (``axes``/``sizes``: ("model",) or
    ("pod", "model")) and the EP world over them (``ep_axes``/``ep_sizes``:
    the same, or empty for a model without MoE).  As on the reference's
    mesh, "pod" is a batch axis and "model" the sequence axis (the
    reference's "data" axis has size 1 here): a MoE layer lays its tokens
    out over the world by them (:func:`repro_torch.core.moe.token_layout`),
    and serving prefills through decode steps when there is a model axis
    (:func:`repro_torch.launch.serve.generate`)."""

    ep_axes: tuple[str, ...]
    ep_sizes: tuple[int, ...]
    axes: tuple[str, ...] = ()
    sizes: tuple[int, ...] = ()

    @property
    def ep_degree(self) -> int:
        """Ranks of the EP world: the product of ``ep_sizes``, or 1 for a
        model without MoE."""
        return math.prod(self.ep_sizes) if self.ep_axes else 1

    def axis_size(self, name: str) -> int:
        return dict(zip(self.axes, self.sizes)).get(name, 1)

    @property
    def model_axis(self) -> Optional[str]:
        return "model" if "model" in self.axes else None


def make_dist_ctx(cfg: ModelConfig, *, model: int, pod: int = 1) -> DistCtx:
    """A world of ``pod * model`` ranks over ("pod", "model") when there is
    a pod level, else over ("model",); its EP world spans it, or is empty
    for a model without MoE."""
    axes, sizes = ((("pod", "model"), (pod, model)) if pod > 1
                   else (("model",), (model,)))
    if not cfg.moe.enabled:
        return DistCtx((), (), axes, sizes)
    return DistCtx(axes, sizes, axes, sizes)


# the routed experts' weights, split over the EP world on their leading
# (expert) axis, as the reference's rule splits them (sharding.py:97-100)
EP_SPLIT_NAMES = ("w_gate", "w_up", "w_down")


def ep_split_leaves(dist: Optional[DistCtx],
                    tree) -> dict[str, tuple[int, ...]]:
    """{path: per-rank shape} of each leaf of ``tree`` (parameters, a train
    state, or optimizer moments mirroring the parameters) that the EP world
    of ``dist`` splits: a routed expert's ``w_gate``, ``w_up`` or
    ``w_down`` (under ``moe``, not under ``shared``), on its leading axis.
    Paths join keys with "/" (``params/blocks/0/moe/w_gate``).  A factored
    second moment's ``row``, ``col`` and ``full`` leaves are not split, as
    the reference's rule leaves them whole.  Raises ValueError where the EP
    degree does not divide a leaf's leading axis."""
    deg = dist.ep_degree if dist is not None else 1
    out: dict[str, tuple[int, ...]] = {}

    def walk(node, keys):
        kids = tree_items(node)
        if kids is None:
            if (keys and keys[-1] in EP_SPLIT_NAMES and "moe" in keys
                    and "shared" not in keys):
                path = "/".join(keys)
                if node.shape[0] % deg:
                    raise ValueError(
                        f"{path}: {node.shape[0]} experts not divisible by "
                        f"the EP degree {deg}")
                out[path] = (node.shape[0] // deg, *node.shape[1:])
            return
        for k, v in kids:
            walk(v, keys + [str(k)])

    walk(tree, [])
    return out


def scan_period(cfg: ModelConfig) -> tuple[int, int]:
    """(period, n_periods): layers repeat with this period (the JAX package
    stacks each slot's parameters over n_periods and scans them)."""
    period = 1
    if cfg.attn_every > 1:
        period = math.lcm(period, cfg.attn_every)
    if cfg.moe.enabled and cfg.moe.moe_every > 1:
        period = math.lcm(period, cfg.moe.moe_every)
    assert cfg.n_layers % period == 0, (cfg.arch_id, cfg.n_layers, period)
    return period, cfg.n_layers // period
