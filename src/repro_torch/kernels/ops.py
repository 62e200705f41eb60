"""Public kernel entry points, dispatched by device (the port of
``repro.kernels.ops``, where a mode string chose ref/interpret/pallas).

A tensor on the CPU takes the kernel's plain PyTorch version; a CUDA
tensor launches the hand-written CUDA kernel, which raises on inputs it
does not take.  There is no other path: no fallback from the GPU to the
plain version, and the TPU's VMEM size gates (``GSS_VMEM_BYTES`` and the
``gather_quantize`` table gate) have no counterpart here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import grouped_matmul as _gm
from repro_torch.kernels import quantize_pack as _qp

# the four kernels of the serving path, by name: (CUDA wrapper, plain)
KERNELS = {
    "grouped_swiglu": (_gm.grouped_swiglu_cuda, _gm.grouped_swiglu_plain),
    "gather_swiglu_scatter": (_gm.gather_swiglu_scatter_cuda,
                              _gm.gather_swiglu_scatter_plain),
    "gather_quantize": (_qp.gather_quantize_cuda, _qp.gather_quantize_plain),
    "dequantize": (_qp.dequantize_cuda, _qp.dequantize_plain),
}


def _pick(name: str, t: torch.Tensor):
    cuda, plain = KERNELS[name]
    if t.is_cuda:
        return cuda
    if t.device.type == "cpu":
        return plain
    raise ValueError(f"{name}: no kernel for device {t.device}")


def grouped_swiglu(x, w_gate, w_up, w_down, counts=None):
    """Grouped expert SwiGLU over x (E, C, D) with per-expert (E,) or
    per-sub-bucket (E, B) occupied counts; rows beyond occupancy are zero."""
    return _pick("grouped_swiglu", x)(x, w_gate, w_up, w_down, counts)


def gather_swiglu_scatter(x_ext, src_of_slot, w_slot, w_gate, w_up, w_down,
                          counts=None):
    """Fused gather -> expert SwiGLU -> weighted fp32 scatter-add; returns
    (T, D) float32 where T = x_ext rows - 1."""
    return _pick("gather_swiglu_scatter", x_ext)(
        x_ext, src_of_slot, w_slot, w_gate, w_up, w_down, counts)


def gather_quantize(x_ext, src_of_slot, counts=None, *, wire_dtype: str):
    """Fused slot gather -> per-128-feature block quantize: ``(q, scales)``."""
    return _pick("gather_quantize", x_ext)(x_ext, src_of_slot, counts,
                                           wire_dtype=wire_dtype)


def dequantize_tokens(q, scales):
    """Inverse of :func:`gather_quantize` per row; fp32 out."""
    return _pick("dequantize", q)(q, scales)
