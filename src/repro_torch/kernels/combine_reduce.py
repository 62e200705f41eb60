"""Weighted combine-reduce: the port of ``repro.kernels.combine_reduce``
(``combine_reduce_pallas``), ``out[t] = sum_k w[t, k] * parts[t, k, :]``.

:func:`combine_reduce_plain` is what the CPU path runs and what the CUDA
kernel (``csrc/combine_reduce.cu``) is held against on the card.  Both sum
in fp32 in k order, each product and each sum rounded separately (the
kernel forbids FMA contraction), and round once to ``parts.dtype``, so the
two agree bit for bit; the reference's einsum sums in its own order.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.grouped_matmul import _check_cuda

Tensor = torch.Tensor

DTYPES = (torch.bfloat16, torch.float32)   # what the kernel takes


def combine_reduce_plain(parts: Tensor, weights: Tensor) -> Tensor:
    """parts (T, K, D); weights (T, K) -> (T, D) in parts.dtype."""
    T, K, D = parts.shape
    p, w = parts.to(torch.float32), weights.to(torch.float32)
    acc = torch.zeros((T, D), dtype=torch.float32, device=parts.device)
    for k in range(K):
        acc = acc + w[:, k, None] * p[:, k]
    return acc.to(parts.dtype)


def combine_reduce_cuda(parts: Tensor, weights: Tensor) -> Tensor:
    """CUDA kernel for :func:`combine_reduce_plain`: bf16 or fp32 parts and
    weights, contiguous."""
    name = "combine_reduce"
    if parts.dim() != 3 or tuple(weights.shape) != tuple(parts.shape[:2]):
        raise ValueError(f"{name}: parts {tuple(parts.shape)} and weights "
                         f"{tuple(weights.shape)} do not fit")
    for k, t in (("parts", parts), ("weights", weights)):
        if t.dtype not in DTYPES:
            raise ValueError(f"{name}: {k} must be bfloat16 or float32, got "
                             f"{t.dtype}")
    _check_cuda(name, parts=parts, weights=weights)
    T, K, D = parts.shape
    out = torch.empty((T, D), dtype=parts.dtype, device=parts.device)
    if out.numel() == 0:
        return out
    lib = build.library()
    with torch.cuda.device(parts.device):
        stream = torch.cuda.current_stream(parts.device).cuda_stream
        err = lib.combine_reduce_launch(
            parts.data_ptr(), weights.data_ptr(), out.data_ptr(), T, K, D,
            int(parts.dtype == torch.bfloat16),
            int(weights.dtype == torch.bfloat16), stream)
    build.check(err, name)
    combine_reduce_cuda.launches += 1
    return out


combine_reduce_cuda.launches = 0
