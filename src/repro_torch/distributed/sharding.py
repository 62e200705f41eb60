"""Distribution context of the port: the rank-stacked EP world on one
device (the counterpart of ``repro.distributed.sharding.DistCtx``).

The JAX package maps a model onto a device mesh; on one card the only
distributed structure left is the EP world, whose P ranks sit on a leading
tensor axis (see :mod:`repro_torch.core.ep`).  ``DistCtx`` carries that
world's axes and sizes: ``("model",)`` for a one-level world, ``("pod",
"model")`` for the two-level hierarchy.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import ModelConfig


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
