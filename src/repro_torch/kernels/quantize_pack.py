"""Fused routing-gather -> block-quantize, and its inverse: the port of
``repro.kernels.quantize_pack`` (``gather_quantize_pallas`` and
``dequantize_pallas``), the two kernels of the fp8/int8 dispatch wire.

Each kernel has a plain PyTorch version (``*_plain``, built on
:mod:`repro_torch.core.transport.codec`, bit-identical to the reference's
codec) and a wrapper (``*_cuda``) that launches the CUDA kernel in
``csrc/gather_quantize.cu`` / ``csrc/dequantize.cu``; the kernels hold the
same bit contract.  Each wrapper counts its launches in ``.launches``.

Their gradient, as the reference's training takes it through
``core/ep.py::_quantized_a2a``: the quantized bytes cross the wire bitcast
to ``uint8``, which carries no gradient, so the tokens' gradient flows
only through the fp32 block scales (``scale = absmax * _QINV``): to each
block's absmax element(s) of the gathered row, shared equally between
ties.  ``dequantize_bwd_*`` gives the scales' gradient, and
``gather_quantize_bwd_*`` the token table's (the kernels in
``csrc/wire_bwd.cu``); :class:`GatherQuantize` and :class:`Dequantize` put
each pair behind a ``torch.autograd.Function``.
"""
from __future__ import annotations

import torch

from repro_torch.core.plan import WIRE_BLOCK, occupancy_mask, wire_layout
from repro_torch.core.transport.codec import (_QINV, FP8_MAX, INT8_MAX,
                                              WIRE_QDTYPE, _blocked,
                                              dequantize_blocked,
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
        buf = torch.where(_occupied_slots(src_of_slot, counts)[:, None], buf,
                          0.0)
    return quantize_blocked(buf, wire_dtype)


def _occupied_slots(src_of_slot: Tensor, counts: Tensor | None) -> Tensor:
    """(n_slots,) bool: the slots below their bucket's count (all without
    counts)."""
    n = src_of_slot.shape[0]
    if counts is None:
        return torch.ones(n, dtype=torch.bool, device=src_of_slot.device)
    E = counts.numel()
    return occupancy_mask(counts.reshape(E), E, n // E).reshape(-1)


def _check_gather(name, x_ext, src_of_slot, counts, wire_dtype):
    """The wire gather's checks: (C, src int32, counts int32 or None,
    {name: tensor} to check on the card)."""
    if wire_dtype not in WIRE_QDTYPE:
        raise ValueError(f"{name}: unknown wire_dtype {wire_dtype!r}")
    if x_ext.dtype != torch.float32 or x_ext.dim() != 2:
        raise ValueError(f"{name}: x_ext must be a (T+1, D) float32 table")
    n_slots = src_of_slot.shape[0]
    src = src_of_slot.to(torch.int32).contiguous()
    tensors = {"x_ext": x_ext, "src": src}
    if counts is None:
        return max(n_slots, 1), src, None, tensors
    cnt = counts.to(torch.int32).reshape(-1).contiguous()
    if cnt.numel() == 0 or n_slots % cnt.numel():
        raise ValueError(f"{name}: {n_slots} slots for {cnt.numel()} buckets")
    tensors["counts"] = cnt
    return n_slots // cnt.numel(), src, cnt, tensors


def gather_quantize_cuda(x_ext: Tensor, src_of_slot: Tensor,
                         counts: Tensor | None = None, *,
                         wire_dtype: str = "fp8"):
    """CUDA kernel for :func:`gather_quantize_plain` (fp32 table)."""
    name = "gather_quantize"
    C, src, cnt, tensors = _check_gather(name, x_ext, src_of_slot, counts,
                                         wire_dtype)
    Tp1, D = x_ext.shape
    n_slots = src.shape[0]
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


# ============================================================ backward =====
def dequantize_bwd_plain(q: Tensor, scales: Tensor, dy: Tensor) -> Tensor:
    """The scales' gradient of :func:`dequantize_plain` for the upstream
    ``dy`` (N, D): ``d_scales[r, b] = sum_{j in b} dy[r, j] * float(q[r,
    j])``, fp32 (N, nb).  ``q`` gets none: on the wire it is a bit
    pattern."""
    prod = dy.to(torch.float32) * q.to(torch.float32)
    return _blocked(prod, WIRE_BLOCK).sum(-1).reshape(scales.shape)


def gather_quantize_bwd_plain(x_ext: Tensor, src_of_slot: Tensor,
                              counts: Tensor | None, d_scales: Tensor, *,
                              wire_dtype: str = "fp8") -> Tensor:
    """The token table's gradient of :func:`gather_quantize_plain` through
    its scales alone (the bytes carry none), for the scales' upstream
    ``d_scales`` (n_slots, nb): each occupied slot s adds, for each block b,
    ``(d_scales[s, b] * _QINV) / ties * sign(x)`` at the block's absmax
    element(s) of row ``src[s]``; rows past their count and all-zero blocks
    (sign(0) = 0) add nothing.  Returns (T+1, D) in x_ext's dtype."""
    Tp1, D = x_ext.shape
    src = src_of_slot.to(torch.int64)
    keep = _occupied_slots(src_of_slot, counts)
    xb = _blocked(x_ext[src].to(torch.float32), WIRE_BLOCK)   # (n, nb, 128)
    a = xb.abs()
    amax = a.amax(-1, keepdim=True)
    tie = (a == amax) & (amax > 0) & keep[:, None, None]
    g = ((d_scales.to(torch.float32) * float(_QINV[wire_dtype]))[..., None]
         / tie.sum(-1, keepdim=True).clamp(min=1))
    rows = torch.where(tie, torch.sign(xb) * g, 0.0).reshape(src.shape[0], -1)
    dx = torch.zeros((Tp1, D), dtype=torch.float32, device=x_ext.device)
    dx.index_add_(0, src, rows[:, :D])
    return dx.to(x_ext.dtype)


def dequantize_bwd_cuda(q: Tensor, scales: Tensor, dy: Tensor) -> Tensor:
    """CUDA kernel for :func:`dequantize_bwd_plain` (``csrc/wire_bwd.cu``):
    the same products, summed in another order."""
    name = "dequantize_bwd"
    if q.dtype not in (torch.float8_e4m3fn, torch.int8) or q.dim() != 2:
        raise ValueError(f"{name}: q must be (N, D) float8_e4m3fn or int8")
    N, D = q.shape
    nb = -(-D // WIRE_BLOCK)
    if scales.shape != (N, nb):
        raise ValueError(f"{name}: scales must be ({N}, {nb})")
    if tuple(dy.shape) != (N, D):
        raise ValueError(f"{name}: dy must be ({N}, {D})")
    dy = dy.to(torch.float32).contiguous()
    _check_cuda(name, q=q, dy=dy)
    ds = torch.empty((N, nb), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return ds.zero_()
    lib = build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dequantize_bwd_launch(q.data_ptr(), dy.data_ptr(),
                                        ds.data_ptr(), N, D, nb,
                                        int(q.dtype == torch.float8_e4m3fn),
                                        stream)
    build.check(err, name)
    dequantize_bwd_cuda.launches += 1
    return ds


dequantize_bwd_cuda.launches = 0


def gather_quantize_bwd_cuda(x_ext: Tensor, src_of_slot: Tensor,
                             counts: Tensor | None, d_scales: Tensor, *,
                             wire_dtype: str = "fp8") -> Tensor:
    """CUDA kernel for :func:`gather_quantize_bwd_plain`
    (``csrc/wire_bwd.cu``): the occupied slots' ``d_scales * qinv`` folded
    onto their rows in a small (T+1, nb) fp32 scratch (zeroed by the C
    entry; fp32 atomics, in run-to-run order), then every table row written
    once, read only where a slot adds to it."""
    name = "gather_quantize_bwd"
    C, src, cnt, tensors = _check_gather(name, x_ext, src_of_slot, counts,
                                         wire_dtype)
    Tp1, D = x_ext.shape
    n_slots = src.shape[0]
    nb = wire_layout(D, wire_dtype).n_blocks
    if tuple(d_scales.shape) != (n_slots, nb):
        raise ValueError(f"{name}: d_scales must be ({n_slots}, {nb})")
    ds = d_scales.to(torch.float32).contiguous()
    _check_cuda(name, d_scales=ds, **tensors)
    if n_slots == 0 or D == 0:
        return torch.zeros_like(x_ext)
    dx = torch.empty_like(x_ext)
    fold = torch.empty((Tp1, nb), dtype=torch.float32, device=x_ext.device)
    lib = build.library()
    with torch.cuda.device(x_ext.device):
        stream = torch.cuda.current_stream(x_ext.device).cuda_stream
        err = lib.gather_quantize_bwd_launch(
            x_ext.data_ptr(), src.data_ptr(),
            None if cnt is None else cnt.data_ptr(), ds.data_ptr(),
            fold.data_ptr(), dx.data_ptr(), Tp1, n_slots, C, D, nb,
            float(_QINV[wire_dtype]), stream)
    build.check(err, name)
    gather_quantize_bwd_cuda.launches += 1
    return dx


gather_quantize_bwd_cuda.launches = 0


class GatherQuantize(torch.autograd.Function):
    """``gather_quantize`` on the card, differentiable through its scales:
    ``q`` is marked non-differentiable (a bit pattern on the wire), and the
    backward kernel gives the table's gradient from the scales'."""

    @staticmethod
    def forward(ctx, fwd, bwd, x_ext, src_of_slot, counts, wire_dtype):
        ctx.bwd, ctx.wire_dtype = bwd, wire_dtype
        ctx.save_for_backward(x_ext, src_of_slot, counts)
        q, scales = fwd(x_ext, src_of_slot, counts, wire_dtype=wire_dtype)
        ctx.mark_non_differentiable(q)
        return q, scales

    @staticmethod
    def backward(ctx, dq, d_scales):
        x_ext, src, counts = ctx.saved_tensors
        dx = ctx.bwd(x_ext, src, counts, d_scales, wire_dtype=ctx.wire_dtype)
        return None, None, dx, None, None, None


class Dequantize(torch.autograd.Function):
    """``dequantize`` on the card, differentiable in its scales only."""

    @staticmethod
    def forward(ctx, fwd, bwd, q, scales):
        ctx.bwd = bwd
        ctx.save_for_backward(q, scales)
        return fwd(q, scales)

    @staticmethod
    def backward(ctx, dy):
        q, scales = ctx.saved_tensors
        return None, None, None, ctx.bwd(q, scales, dy)


def gather_quantize_train(fwd, bwd, x_ext, src_of_slot, counts=None, *,
                          wire_dtype: str = "fp8"):
    """:class:`GatherQuantize` over the forward wrapper ``fwd`` and the
    backward wrapper ``bwd``, taking ``wire_dtype`` by keyword as the
    wrappers do."""
    return GatherQuantize.apply(fwd, bwd, x_ext, src_of_slot, counts,
                                wire_dtype)
