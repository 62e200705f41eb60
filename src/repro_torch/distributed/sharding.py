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

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class DistCtx:
    ep_axes: tuple[str, ...]
    ep_sizes: tuple[int, ...]


def make_dist_ctx(cfg: ModelConfig, *, model: int, pod: int = 1) -> DistCtx:
    """EP world of ``pod * model`` ranks: over ("pod", "model") when there
    is a pod level, else over ("model",); none for a model without MoE."""
    if not cfg.moe.enabled:
        return DistCtx((), ())
    if pod > 1:
        return DistCtx(("pod", "model"), (pod, model))
    return DistCtx(("model",), (model,))


def scan_period(cfg: ModelConfig) -> tuple[int, int]:
    """(period, n_periods): layers repeat with this period (the JAX package
    stacks each slot's parameters over n_periods and scans them)."""
    period = 1
    if cfg.moe.enabled and cfg.moe.moe_every > 1:
        period = math.lcm(period, cfg.moe.moe_every)
    assert cfg.n_layers % period == 0, (cfg.arch_id, cfg.n_layers, period)
    return period, cfg.n_layers // period
