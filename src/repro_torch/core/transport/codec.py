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

The substrate's row codecs (:class:`WireCodec`, :func:`get_codec`) pack
numpy fp32 rows into the inline-scale wire layout on the host, through
these torch functions on CPU tensors (numpy has no fp8 dtype): the bytes
equal the reference's ``repro.core.transport.codec`` row codecs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.plan import WIRE_BLOCK, WireLayout, wire_layout

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


# ------------------------------------------------------- substrate codecs --
def _host(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over a contiguous numpy array (copied only when the
    array is read-only, which ``torch.from_numpy`` refuses to share)."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


class WireCodec:
    """Row codec for the host transport substrate: fp32 rows <-> wire
    bytes.  ``encode`` packs (N, D) fp32 into (N, wire_bytes(D)) uint8 in
    the inline-scale layout ``[D quantized bytes | nb fp32 scales]`` (fp32
    passes its 4 * D bytes through); ``decode`` is its fp32 inverse."""

    name = "fp32"

    def layout(self, d: int) -> WireLayout:
        return wire_layout(d, self.name)

    def wire_bytes(self, d: int) -> int:
        return self.layout(d).token_bytes

    def encode(self, x: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(x, np.float32)
        return x.view(np.uint8).reshape(x.shape[0], -1)

    def decode(self, buf: np.ndarray, d: int) -> np.ndarray:
        buf = np.ascontiguousarray(buf, np.uint8)
        return buf.view(np.float32).reshape(buf.shape[0], d).copy()


class _QuantCodec(WireCodec):
    def encode(self, x: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(x, np.float32)
        n, d = x.shape
        lo = self.layout(d)
        q, scales = quantize_blocked(_host(x), self.name)
        out = np.empty((n, lo.token_bytes), np.uint8)
        out[:, :lo.q_bytes] = q.view(torch.uint8).numpy()
        out[:, lo.q_bytes:] = np.ascontiguousarray(
            scales.numpy(), np.float32).view(np.uint8).reshape(
                n, lo.scale_bytes)
        return out

    def decode(self, buf: np.ndarray, d: int) -> np.ndarray:
        lo = self.layout(d)
        buf = np.asarray(buf, np.uint8)
        q = _host(buf[:, :lo.q_bytes])
        scales = np.ascontiguousarray(buf[:, lo.q_bytes:]).view(
            np.float32).reshape(buf.shape[0], lo.n_blocks)
        return dequantize_blocked(q.view(WIRE_QDTYPE[self.name]),
                                  _host(scales)).numpy()


class Fp8Codec(_QuantCodec):
    name = "fp8"


class Int8Codec(_QuantCodec):
    name = "int8"


_CODECS = {"fp32": WireCodec(), "fp8": Fp8Codec(), "int8": Int8Codec()}
WIRE_DTYPES = tuple(_CODECS)


def get_codec(name: str) -> WireCodec:
    try:
        return _CODECS[name]
    except KeyError:
        raise ValueError(
            f"unknown wire_dtype: {name!r} (have {WIRE_DTYPES})") from None
