"""Public kernel entry points, dispatched by device (the port of
``repro.kernels.ops``, where a mode string chose ref/interpret/pallas).

A tensor on the CPU takes the kernel's plain PyTorch version; a CUDA
tensor launches the hand-written CUDA kernel, which raises on inputs it
does not take.  There is no other path: no fallback from the GPU to the
plain version, and the TPU's VMEM size gates (``GSS_VMEM_BYTES`` and the
``gather_quantize`` table gate) have no counterpart here.

Gradients: a CPU tensor takes the plain version, which autograd
differentiates.  On CUDA only the scan and the kernels of ``TRAIN`` have
a backward kernel.  The scan's wrapper is its ``torch.autograd.Function``;
each kernel of ``TRAIN`` takes its Function (over its forward wrapper and
the backward kernel's, as registered here) only when grad mode is on and
an input requires a gradient, so serving (under ``inference_mode``, or
inside a captured graph) calls the ``ctypes`` wrapper as it would without
a backward.  The other kernels' outputs carry no ``grad_fn``, so they
refuse a CUDA input that requires a gradient while grad mode is on,
rather than let the gradients to it vanish.
"""
from __future__ import annotations

import functools
import os

import torch

from repro_torch.kernels import combine_reduce as _cr
from repro_torch.kernels import grouped_matmul as _gm
from repro_torch.kernels import mamba_scan as _ms
from repro_torch.kernels import norm_attention as _na
from repro_torch.kernels import quantize_pack as _qp

# the kernels by name: (CUDA wrapper, plain); the scan's CUDA wrapper is
# differentiable, and the backward kernels are registered beside their
# forwards
KERNELS = {
    "grouped_matmul": (_gm.grouped_matmul_cuda, _gm.grouped_matmul_plain),
    "grouped_swiglu": (_gm.grouped_swiglu_cuda, _gm.grouped_swiglu_plain),
    "grouped_swiglu_bwd": (_gm.grouped_swiglu_bwd_cuda,
                           _gm.grouped_swiglu_bwd_plain),
    "grouped_swiglu_db": (_gm.grouped_swiglu_db_cuda,
                          _gm.grouped_swiglu_db_plain),
    "gather_swiglu_scatter": (_gm.gather_swiglu_scatter_cuda,
                              _gm.gather_swiglu_scatter_plain),
    "gather_swiglu_scatter_bwd": (_gm.gather_swiglu_scatter_bwd_cuda,
                                  _gm.gather_swiglu_scatter_bwd_plain),
    "gather_quantize": (_qp.gather_quantize_cuda, _qp.gather_quantize_plain),
    "gather_quantize_bwd": (_qp.gather_quantize_bwd_cuda,
                            _qp.gather_quantize_bwd_plain),
    "dequantize": (_qp.dequantize_cuda, _qp.dequantize_plain),
    "dequantize_bwd": (_qp.dequantize_bwd_cuda, _qp.dequantize_bwd_plain),
    "mamba_scan": (_ms.mamba_scan_cuda, _ms.mamba_scan_plain),
    "mamba_scan_bwd": (_ms.mamba_scan_bwd_cuda, _ms.mamba_scan_bwd_plain),
    "rmsnorm": (_na.rmsnorm_cuda, _na.rmsnorm_plain),
    "flash_attention": (_na.flash_attention_cuda, _na.flash_attention_plain),
    "decode_attention": (_na.decode_attention_cuda,
                         _na.decode_attention_plain),
    "decode_attention_paged": (_na.decode_attention_paged_cuda,
                               _na.decode_attention_paged_plain),
    "combine_reduce": (_cr.combine_reduce_cuda, _cr.combine_reduce_plain),
}
# kernels differentiable on the card through an autograd Function over
# their forward and backward wrappers: (the Function's ``apply``, taking
# the two wrappers first, the backward kernel's name)
TRAIN = {
    "grouped_swiglu": (_gm.GroupedSwiGLU.apply, "grouped_swiglu_bwd"),
    "gather_swiglu_scatter": (_gm.GatherSwiGLUScatter.apply,
                              "gather_swiglu_scatter_bwd"),
    "gather_quantize": (_qp.gather_quantize_train, "gather_quantize_bwd"),
    "dequantize": (_qp.Dequantize.apply, "dequantize_bwd"),
}
# the CUDA wrappers as registered, whose ``.launches`` count their kernels'
# launches whatever stands in ``KERNELS`` for them
_WRAPPERS = {n: cuda for n, (cuda, _) in KERNELS.items()}


def launch_counts() -> dict:
    """{kernel name: launches so far} of every CUDA wrapper."""
    return {n: w.launches for n, w in _WRAPPERS.items()}


def train_function(name: str, cuda):
    """Kernel ``name`` of ``TRAIN`` as its autograd Function over the
    forward wrapper ``cuda`` and its backward kernel's wrapper as
    registered in ``KERNELS``."""
    apply, bwd = TRAIN[name]
    return functools.partial(apply, cuda, KERNELS[bwd][0])


def _pick(name: str, *tensors):
    """The CUDA wrapper or the plain version of ``name``, by the device of
    the first tensor; on CUDA under grad with an input that requires one,
    the kernel's autograd Function, or a refusal where it has none."""
    cuda, plain = KERNELS[name]
    t = tensors[0]
    if t.is_cuda:
        if not (torch.is_grad_enabled()
                and any(isinstance(a, torch.Tensor) and a.requires_grad
                        for a in tensors)):
            return cuda
        if name in TRAIN:
            return train_function(name, cuda)
        if name != "mamba_scan":          # the scan's wrapper differentiates
            raise NotImplementedError(
                f"{name}: the CUDA kernel has no backward kernel yet, and an "
                "input requires a gradient; run it under torch.no_grad(), or "
                "on the CPU, where autograd differentiates the plain version")
        return cuda
    if t.device.type == "cpu":
        return plain
    raise ValueError(f"{name}: no kernel for device {t.device}")


def grouped_matmul(x, w, counts=None):
    """Per-group GEMM x (G, M, K) @ w (G, K, N) -> (G, M, N) in x.dtype,
    fp32 sums; rows at or past flat (G,) ``counts`` are zero."""
    return _pick("grouped_matmul", x, w)(x, w, counts)


def grouped_swiglu(x, w_gate, w_up, w_down, counts=None):
    """Grouped expert SwiGLU over x (E, C, D) with per-expert (E,) or
    per-sub-bucket (E, B) occupied counts; rows beyond occupancy are zero.

    ``REPRO_SWIGLU_DB=1``, read at each call as the reference reads it,
    selects the double-buffered kernel for flat (or no) counts; bucketed
    counts keep the grouped kernel."""
    flat = counts is None or counts.dim() == 1
    name = ("grouped_swiglu_db"
            if os.environ.get("REPRO_SWIGLU_DB") == "1" and flat
            else "grouped_swiglu")
    return _pick(name, x, w_gate, w_up, w_down)(x, w_gate, w_up, w_down,
                                                counts)


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


def rmsnorm(x, scale, eps: float = 1e-5):
    """``x * rsqrt(mean(x^2) + eps) * scale`` over the last dim, reduced in
    fp32 (bf16 x and an fp32 scale on the card)."""
    return _pick("rmsnorm", x, scale)(x, scale, eps)


def flash_attention(q, k, v, *, causal: bool = True):
    """Attention of q (B, Sq, H, D) over k/v (B, Skv, Hkv, D), GQA, causal
    (top-left aligned) or full -> (B, Sq, H, D)."""
    return _pick("flash_attention", q, k, v)(q, k, v, causal=causal)


def decode_attention(q, k, v, pos, *, start: int = 0):
    """One query a sequence, q (B, H, D), over the cache slice k/v (B, S,
    Hkv, D) of positions [start, start + S), live up to ``pos`` ->
    normalised (B, H, D).  On the card ``pos`` is a 0-d int32 tensor on
    q's device, read there (a host int raises); on the CPU an int or a 0-d
    tensor."""
    return _pick("decode_attention", q, k, v)(q, k, v, pos, start=start)


def decode_attention_paged(q, k_pool, v_pool, block_tables, pos):
    """One query a sequence, q (B, H, D), through block pools k/v_pool
    (NB, bs, Hkv, D) and tables (B, nb) (-1 unallocated), positions
    0..pos[b] with ``pos`` (B,) on the device -> normalised (B, H, D)."""
    return _pick("decode_attention_paged", q, k_pool, v_pool)(
        q, k_pool, v_pool, block_tables, pos)


def combine_reduce(parts, weights):
    """``out[t] = sum_k weights[t, k] * parts[t, k, :]``: parts (T, K, D),
    weights (T, K) -> (T, D) in parts.dtype, fp32 sums."""
    return _pick("combine_reduce", parts, weights)(parts, weights)
