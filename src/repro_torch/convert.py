"""Parameters of the JAX package, as numpy arrays, into the port's layout.

The JAX tree stacks each layer slot's parameters over ``n_periods``
(``blocks/slot{s}/...``, layer ``i * period + s``); the port keeps a list
of per-layer dicts.  Every other leaf keeps its shape and layout.  Takes
numpy arrays only (float32 or another dtype numpy knows), so it needs no
JAX: ``jax.tree.map(np.asarray, params)`` gives such a tree.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import scan_period


def params_from_jax(cfg: ModelConfig, tree: dict, device="cuda") -> dict:
    def to(a):
        return torch.from_numpy(np.array(a)).to(device)   # a writable copy

    def take(node, i):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        return to(node[i])

    period, n_periods = scan_period(cfg)
    out = {k: to(v) for k, v in tree.items() if k != "blocks"}
    layers = [None] * cfg.n_layers
    for s in range(period):
        slot = tree["blocks"][f"slot{s}"]
        for i in range(n_periods):
            layers[i * period + s] = take(slot, i)
    out["blocks"] = layers
    return out
