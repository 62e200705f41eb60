"""Wire payload codec in torch: fp8-e4m3 / int8 block quantization (the
port of ``repro.core.transport.codec``'s ``quantize_blocked`` /
``dequantize_blocked``, bit for bit).

One symmetric absmax scale per :data:`WIRE_BLOCK` features.  The rounding
contract: ``scale = absmax * _QINV`` (a multiply by the same pre-rounded
f32 reciprocal, never a divide), an IEEE divide of each element by the
scale (1.0 in place of a zero scale), a clip to the representable range,
then fp8 rounds f32 -> f16 -> e4m3 (both RTNE; a direct f32 -> e4m3 cast
disagrees on about 0.3% of values) and int8 rounds half to even and clips
to +-127.  Decode always returns fp32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.plan import WIRE_BLOCK

FP8_MAX = 448.0      # float8_e4m3fn finite max (no inf encoding)
INT8_MAX = 127.0

_QINV = {"fp8": np.float32(1.0) / np.float32(FP8_MAX),
         "int8": np.float32(1.0) / np.float32(INT8_MAX)}

WIRE_QDTYPE = {"fp8": torch.float8_e4m3fn, "int8": torch.int8}


def _blocked(x: torch.Tensor, block: int) -> torch.Tensor:
    d = x.shape[-1]
    nb = -(-d // block)
    pad = nb * block - d
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x.reshape(x.shape[:-1] + (nb, block))


def quantize_blocked(x: torch.Tensor, wire_dtype: str = "int8",
                     block: int = WIRE_BLOCK):
    """(..., D) -> ``(q, scales)``: q (..., D) int8 or float8_e4m3fn,
    scales (..., nb) fp32 (an exact 0 for an all-zero block)."""
    if wire_dtype not in _QINV:
        raise ValueError(f"unknown wire_dtype: {wire_dtype!r}")
    x = x.to(torch.float32)
    d = x.shape[-1]
    qmax = FP8_MAX if wire_dtype == "fp8" else INT8_MAX
    xb = _blocked(x, block)
    scale = xb.abs().amax(dim=-1) * float(_QINV[wire_dtype])
    s = torch.where(scale == 0, torch.ones_like(scale), scale)
    y = torch.clamp(xb / s[..., None], -qmax, qmax)
    if wire_dtype == "fp8":
        q = y.to(torch.float16).to(torch.float8_e4m3fn)
    else:
        q = torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    q = q.reshape(x.shape[:-1] + (xb.shape[-2] * block,))[..., :d]
    return q, scale


def dequantize_blocked(q: torch.Tensor, scales: torch.Tensor,
                       block: int = WIRE_BLOCK) -> torch.Tensor:
    """Inverse of :func:`quantize_blocked`: (..., D) + (..., nb) -> fp32."""
    d = q.shape[-1]
    qf = _blocked(q.to(torch.float32), block)
    out = qf * scales[..., None].to(torch.float32)
    return out.reshape(q.shape[:-1] + (qf.shape[-2] * block,))[..., :d]
