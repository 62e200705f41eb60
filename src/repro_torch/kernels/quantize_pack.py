"""Fused routing-gather -> block-quantize, and its inverse: the port of
``repro.kernels.quantize_pack`` (``gather_quantize_pallas`` and
``dequantize_pallas``), the two kernels of the fp8/int8 dispatch wire.

Each kernel has a plain PyTorch version (``*_plain``, built on
:mod:`repro_torch.core.transport.codec`, bit-identical to the reference's
codec) and a wrapper (``*_cuda``) that launches the CUDA kernel in
``csrc/gather_quantize.cu`` / ``csrc/dequantize.cu``; the kernels hold the
same bit contract.  Each wrapper counts its launches in ``.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.core.plan import occupancy_mask, wire_layout
from repro_torch.core.transport.codec import (_QINV, FP8_MAX, INT8_MAX,
                                              WIRE_QDTYPE, dequantize_blocked,
                                              quantize_blocked)
from repro_torch.kernels import build
from repro_torch.kernels.grouped_matmul import _check_cuda

Tensor = torch.Tensor


def gather_quantize_plain(x_ext: Tensor, src_of_slot: Tensor,
                          counts: Tensor | None = None, *,
                          wire_dtype: str = "fp8"):
    """x_ext (T+1, D), zero scratch row T; src_of_slot (n_slots,); counts
    (E,) with E*C == n_slots (None = dense).  Returns ``(q, scales)``:
    (n_slots, D) in the wire dtype and (n_slots, nb) fp32; slots at or past
    their bucket's count are zero bytes with zero scales."""
    buf = x_ext[src_of_slot.to(torch.int64)].to(torch.float32)
    if counts is not None:
        E = counts.shape[0]
        C = src_of_slot.shape[0] // E
        m = occupancy_mask(counts.reshape(E), E, C).reshape(-1)
        buf = torch.where(m[:, None], buf, 0.0)
    return quantize_blocked(buf, wire_dtype)


def gather_quantize_cuda(x_ext: Tensor, src_of_slot: Tensor,
                         counts: Tensor | None = None, *,
                         wire_dtype: str = "fp8"):
    """CUDA kernel for :func:`gather_quantize_plain` (fp32 table)."""
    name = "gather_quantize"
    if wire_dtype not in WIRE_QDTYPE:
        raise ValueError(f"{name}: unknown wire_dtype {wire_dtype!r}")
    if x_ext.dtype != torch.float32 or x_ext.dim() != 2:
        raise ValueError(f"{name}: x_ext must be a (T+1, D) float32 table")
    Tp1, D = x_ext.shape
    n_slots = src_of_slot.shape[0]
    src = src_of_slot.to(torch.int32).contiguous()
    tensors = {"x_ext": x_ext, "src": src}
    if counts is None:
        C, cnt = max(n_slots, 1), None
    else:
        cnt = counts.to(torch.int32).reshape(-1).contiguous()
        if cnt.numel() == 0 or n_slots % cnt.numel():
            raise ValueError(f"{name}: {n_slots} slots for {cnt.numel()} buckets")
        C = n_slots // cnt.numel()
        tensors["counts"] = cnt
    _check_cuda(name, **tensors)
    nb = wire_layout(D, wire_dtype).n_blocks
    q = torch.empty((n_slots, D), dtype=WIRE_QDTYPE[wire_dtype],
                    device=x_ext.device)
    scales = torch.empty((n_slots, nb), dtype=torch.float32,
                         device=x_ext.device)
    if n_slots == 0 or D == 0:
        return q, scales
    qmax = FP8_MAX if wire_dtype == "fp8" else INT8_MAX
    lib = build.library()
    with torch.cuda.device(x_ext.device):
        stream = torch.cuda.current_stream(x_ext.device).cuda_stream
        err = lib.gather_quantize_launch(
            x_ext.data_ptr(), src.data_ptr(),
            None if cnt is None else cnt.data_ptr(), q.data_ptr(),
            scales.data_ptr(), Tp1, n_slots, C, D, nb,
            float(_QINV[wire_dtype]), qmax, int(wire_dtype == "fp8"), stream)
    build.check(err, name)
    gather_quantize_cuda.launches += 1
    return q, scales


gather_quantize_cuda.launches = 0


def dequantize_plain(q: Tensor, scales: Tensor) -> Tensor:
    """(N, D) wire dtype + (N, nb) fp32 scales -> (N, D) fp32."""
    return dequantize_blocked(q, scales)


def dequantize_cuda(q: Tensor, scales: Tensor) -> Tensor:
    """CUDA kernel for :func:`dequantize_plain` (bit-identical)."""
    name = "dequantize"
    if q.dtype not in (torch.float8_e4m3fn, torch.int8) or q.dim() != 2:
        raise ValueError(f"{name}: q must be (N, D) float8_e4m3fn or int8")
    N, D = q.shape
    nb = -(-D // 128)
    if scales.shape != (N, nb) or scales.dtype != torch.float32:
        raise ValueError(f"{name}: scales must be ({N}, {nb}) float32")
    _check_cuda(name, q=q, scales=scales)
    out = torch.empty((N, D), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out
    lib = build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dequantize_launch(q.data_ptr(), scales.data_ptr(),
                                    out.data_ptr(), N, D, nb,
                                    int(q.dtype == torch.float8_e4m3fn),
                                    stream)
    build.check(err, name)
    dequantize_cuda.launches += 1
    return out


dequantize_cuda.launches = 0
