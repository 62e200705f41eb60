"""Public kernel entry points, dispatched by device (the port of
``repro.kernels.ops``, where a mode string chose ref/interpret/pallas).

A tensor on the CPU takes the kernel's plain PyTorch version; a CUDA
tensor launches the hand-written CUDA kernel, which raises on inputs it
does not take.  There is no other path: no fallback from the GPU to the
plain version, and the TPU's VMEM size gates (``GSS_VMEM_BYTES`` and the
``gather_quantize`` table gate) have no counterpart here.

Gradients: a CPU tensor takes the plain version, which autograd
differentiates.  On CUDA only the kernels in ``WITH_BACKWARD`` have a
backward kernel (behind a ``torch.autograd.Function``); the others launch
through ``ctypes`` and their outputs carry no ``grad_fn``, so they refuse
a CUDA input that requires a gradient while grad mode is on, rather than
let the gradients to it vanish.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import grouped_matmul as _gm
from repro_torch.kernels import mamba_scan as _ms
from repro_torch.kernels import quantize_pack as _qp

# the kernels by name: (CUDA wrapper, plain); the scan's CUDA wrapper is
# differentiable, and its backward kernel is registered beside it
KERNELS = {
    "grouped_swiglu": (_gm.grouped_swiglu_cuda, _gm.grouped_swiglu_plain),
    "gather_swiglu_scatter": (_gm.gather_swiglu_scatter_cuda,
                              _gm.gather_swiglu_scatter_plain),
    "gather_quantize": (_qp.gather_quantize_cuda, _qp.gather_quantize_plain),
    "dequantize": (_qp.dequantize_cuda, _qp.dequantize_plain),
    "mamba_scan": (_ms.mamba_scan_cuda, _ms.mamba_scan_plain),
    "mamba_scan_bwd": (_ms.mamba_scan_bwd_cuda, _ms.mamba_scan_bwd_plain),
}
# kernels whose CUDA wrapper is differentiable on the card
WITH_BACKWARD = frozenset({"mamba_scan"})


def _pick(name: str, *tensors):
    """The CUDA wrapper or the plain version of ``name``, by the device of
    the first tensor; refuses a gradient the CUDA kernel cannot give."""
    cuda, plain = KERNELS[name]
    t = tensors[0]
    if t.is_cuda:
        if (name not in WITH_BACKWARD and torch.is_grad_enabled()
                and any(isinstance(a, torch.Tensor) and a.requires_grad
                        for a in tensors)):
            raise NotImplementedError(
                f"{name}: the CUDA kernel has no backward kernel yet, and an "
                "input requires a gradient; run it under torch.no_grad(), or "
                "on the CPU, where autograd differentiates the plain version")
        return cuda
    if t.device.type == "cpu":
        return plain
    raise ValueError(f"{name}: no kernel for device {t.device}")


def grouped_swiglu(x, w_gate, w_up, w_down, counts=None):
    """Grouped expert SwiGLU over x (E, C, D) with per-expert (E,) or
    per-sub-bucket (E, B) occupied counts; rows beyond occupancy are zero."""
    return _pick("grouped_swiglu", x, w_gate, w_up, w_down)(
        x, w_gate, w_up, w_down, counts)


def gather_swiglu_scatter(x_ext, src_of_slot, w_slot, w_gate, w_up, w_down,
                          counts=None):
    """Fused gather -> expert SwiGLU -> weighted fp32 scatter-add; returns
    (T, D) float32 where T = x_ext rows - 1."""
    return _pick("gather_swiglu_scatter", x_ext, w_slot, w_gate, w_up,
                 w_down)(x_ext, src_of_slot, w_slot, w_gate, w_up, w_down,
                         counts)


def gather_quantize(x_ext, src_of_slot, counts=None, *, wire_dtype: str):
    """Fused slot gather -> per-128-feature block quantize: ``(q, scales)``."""
    return _pick("gather_quantize", x_ext)(x_ext, src_of_slot, counts,
                                           wire_dtype=wire_dtype)


def dequantize_tokens(q, scales):
    """Inverse of :func:`gather_quantize` per row; fp32 out."""
    return _pick("dequantize", q, scales)(q, scales)


def mamba_scan(x, dt, A, B, C, D):
    """Mamba-1 selective scan (fp32): x, dt (Bt, S, Di); A (Di, N); B, C
    (Bt, S, N); D (Di,) -> (Bt, S, Di).  Differentiable on both devices.
    Every input must be float32 on both devices, as the CUDA kernels
    require, so that the CPU path refuses what the card would."""
    for name, t in zip(("x", "dt", "A", "B", "C", "D"), (x, dt, A, B, C, D)):
        if t.dtype != torch.float32:
            raise ValueError(f"mamba_scan: {name} must be float32, got "
                             f"{t.dtype}")
    return _pick("mamba_scan", x)(x, dt, A, B, C, D)
