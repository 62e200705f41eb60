"""LR schedules (pure functions of step): the port of ``repro.optim.schedule``."""
from __future__ import annotations

import math

import torch


def cosine_with_warmup(step, *, peak_lr: float, warmup: int, total: int,
                       floor_frac: float = 0.1) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``floor_frac * peak_lr``; a
    float32 scalar tensor, computed in float32 as the reference does."""
    s = torch.as_tensor(step, dtype=torch.float32)
    # ramp from peak/warmup (not 0) so the first optimizer step is not a no-op
    warm = peak_lr * (s + 1.0) / max(warmup, 1)
    t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor_frac + (1 - floor_frac) * 0.5
                     * (1 + torch.cos(math.pi * t)))
    return torch.where(s < warmup, warm, cos)
