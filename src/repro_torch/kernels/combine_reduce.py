"""Weighted combine-reduce: the port of ``repro.kernels.combine_reduce``
(``combine_reduce_pallas``), ``out[t] = sum_k w[t, k] * parts[t, k, :]``.

:func:`combine_reduce_plain` is what the CPU path runs and what the CUDA
kernel (``csrc/combine_reduce.cu``) is held against on the card.  Both sum
in fp32 in k order, each product and each sum rounded separately (the
kernel forbids FMA contraction), and round once to the output dtype, so
the two agree bit for bit; the reference's einsum sums in its own order.

The gathered form (``sel`` given) reads each token's K rows where they
lie, ``out[t] = sum_k w[t, k] * rows[sel[t, k]]``, a slot outside the rows
(-1: a dropped or invalid choice) adding exactly 0: the LL combine's
gather folded into this kernel (``core/ep.py``: the expert outputs are
read where the expert kernel left them).  The JAX package has no gathered
form.  On the (T, K, D) parts of the gathered rows, a dropped choice's
row zero, the two forms give the same bits.

Gradient (:class:`CombineReduce`, the card's path under autograd): each
row a slot names gets its choice's weight times its token's upstream row
(``gather_rows``'s weighted form over the inverse of ``sel``), each
weight the dot of its row with the upstream row (``combine_dot``);
``combine_reduce_bwd_*`` gives both.  Every row is named by at most one
(t, k), as the LL slots are.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import gather_rows as gr
from repro_torch.kernels.grouped_matmul import _check_cuda

Tensor = torch.Tensor

DTYPES = (torch.bfloat16, torch.float32)   # what the kernel takes


def _live(sel: Tensor, n_rows: int) -> Tensor:
    return (sel >= 0) & (sel < n_rows)


def combine_reduce_plain(parts: Tensor, weights: Tensor,
                         sel: Tensor | None = None,
                         out_dtype: torch.dtype | None = None) -> Tensor:
    """parts (T, K, D), or the rows (N, D) with ``sel`` (T, K); weights
    (T, K) -> (T, D) in ``out_dtype`` (default parts.dtype)."""
    w = weights.to(torch.float32)
    if sel is None:
        T, K, D = parts.shape
        p = parts.to(torch.float32)
        acc = torch.zeros((T, D), dtype=torch.float32, device=parts.device)
        for k in range(K):
            acc = acc + w[:, k, None] * p[:, k]
    else:
        (T, K), (N, D) = sel.shape, parts.shape
        acc = torch.zeros((T, D), dtype=torch.float32, device=parts.device)
        if N:
            rows = parts.to(torch.float32)
            live = _live(sel, N)
            idx = sel.to(torch.int64).clamp(0, N - 1)
            for k in range(K):
                acc = acc + torch.where(live[:, k, None],
                                        w[:, k, None] * rows[idx[:, k]], 0.0)
    return acc.to(out_dtype or parts.dtype)


def _check_dtypes(name, **tensors):
    for k, t in tensors.items():
        if t.dtype not in DTYPES:
            raise ValueError(f"{name}: {k} must be bfloat16 or float32, got "
                             f"{t.dtype}")


def combine_reduce_cuda(parts: Tensor, weights: Tensor,
                        sel: Tensor | None = None,
                        out_dtype: torch.dtype | None = None) -> Tensor:
    """CUDA kernel for :func:`combine_reduce_plain`: bf16 or fp32 parts (or
    rows) and weights, contiguous; the (T, K, D) form's output is in the
    parts' dtype, the gathered form's bf16 or fp32."""
    name = "combine_reduce"
    _check_dtypes(name, parts=parts, weights=weights)
    if sel is None:
        if parts.dim() != 3 or tuple(weights.shape) != tuple(parts.shape[:2]):
            raise ValueError(f"{name}: parts {tuple(parts.shape)} and weights "
                             f"{tuple(weights.shape)} do not fit")
        if out_dtype not in (None, parts.dtype):
            raise ValueError(f"{name}: the (T, K, D) form writes the parts' "
                             f"dtype, not {out_dtype}")
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
    else:
        if (parts.dim() != 2 or sel.dim() != 2
                or tuple(weights.shape) != tuple(sel.shape)):
            raise ValueError(f"{name}: rows {tuple(parts.shape)}, sel "
                             f"{tuple(sel.shape)} and weights "
                             f"{tuple(weights.shape)} do not fit")
        out_dtype = out_dtype or parts.dtype
        if out_dtype not in DTYPES:
            raise ValueError(f"{name}: out_dtype must be bfloat16 or "
                             f"float32, got {out_dtype}")
        s32 = sel.to(torch.int32).contiguous()
        _check_cuda(name, rows=parts, sel=s32, weights=weights)
        (T, K), (N, D) = s32.shape, parts.shape
        out = torch.empty((T, D), dtype=out_dtype, device=parts.device)
        if out.numel() == 0:
            return out
        lib = build.library()
        with torch.cuda.device(parts.device):
            stream = torch.cuda.current_stream(parts.device).cuda_stream
            err = lib.combine_reduce_gathered_launch(
                parts.data_ptr(), s32.data_ptr(), weights.data_ptr(),
                out.data_ptr(), T, K, D, N,
                int(parts.dtype == torch.bfloat16),
                int(weights.dtype == torch.bfloat16),
                int(out_dtype == torch.bfloat16), stream)
    build.check(err, name)
    combine_reduce_cuda.launches += 1
    return out


combine_reduce_cuda.launches = 0


# ============================================================ backward =====
def _as_gathered(parts: Tensor, sel: Tensor | None):
    """The (T, K, D) form as rows (T * K, D) named by sel = arange."""
    if sel is not None:
        return parts, sel
    T, K, D = parts.shape
    return parts.reshape(T * K, D), torch.arange(
        T * K, dtype=torch.int32, device=parts.device).reshape(T, K)


def _inverse(sel: Tensor, weights: Tensor, n_rows: int):
    """The slot table's inverse: (src (n_rows,) the token a row's gradient
    reads, -1 for a row no (t, k) names; w (n_rows,) fp32 its weight)."""
    T, K = sel.shape
    flat = sel.reshape(-1).to(torch.int64)
    live = _live(flat, n_rows)
    inv = torch.full((n_rows + 1,), -1, dtype=torch.int64, device=sel.device)
    inv.scatter_(0, torch.where(live, flat, n_rows),
                 torch.arange(T * K, device=sel.device))
    inv = inv[:n_rows]
    named = inv >= 0
    src = torch.where(named, inv // K, -1)
    w = torch.where(named, weights.reshape(-1).to(torch.float32)[
        inv.clamp(min=0)], 0.0)
    return src, w


def combine_reduce_bwd_plain(parts: Tensor, weights: Tensor,
                             sel: Tensor | None, dout: Tensor):
    """(d parts, d weights) of :func:`combine_reduce_plain` for the
    upstream ``dout`` (T, D): a named row ``w * dout[t]`` (fp32, rounded to
    the parts' dtype), an unnamed one zero; ``d w[t, k] = <dout[t],
    rows[sel[t, k]]>`` (fp32 sums, in the weights' dtype; 0 where the slot
    is outside the rows)."""
    rows, s = _as_gathered(parts, sel)
    N = rows.shape[0]
    src, w = _inverse(s, weights, N)
    g = dout.to(torch.float32)
    drows = gr.gather_rows_plain(g, src, None, w).to(parts.dtype)
    live = _live(s, N)
    picked = rows.to(torch.float32)[s.to(torch.int64).clamp(0, max(N - 1, 0))]
    dw = torch.where(live, (g[:, None, :] * picked).sum(-1), 0.0)
    return drows.reshape(parts.shape), dw.to(weights.dtype)


def combine_reduce_bwd_cuda(parts: Tensor, weights: Tensor,
                            sel: Tensor | None, dout: Tensor):
    """CUDA kernels for :func:`combine_reduce_bwd_plain`: the rows'
    gradient through ``gather_rows``'s weighted kernel (the upstream in
    fp32 where its dtype is not the rows'), the weights' by
    ``combine_dot``, counted here; the weights' sums in another order."""
    name = "combine_reduce_bwd"
    rows, s = _as_gathered(parts, sel)
    (T, K), (N, D) = s.shape, rows.shape
    if tuple(dout.shape) != (T, D):
        raise ValueError(f"{name}: dout must be ({T}, {D})")
    _check_dtypes(name, dout=dout, rows=rows)
    src, w = _inverse(s, weights, N)
    g = dout.contiguous()
    table = g if g.dtype == rows.dtype else g.to(torch.float32)
    drows = gr.gather_rows_cuda(table, src, None, w).to(rows.dtype)
    s32 = s.to(torch.int32).contiguous()
    rows = rows.contiguous()
    _check_cuda(name, dout=g, rows=rows, sel=s32)
    dw = torch.empty((T, K), dtype=torch.float32, device=rows.device)
    if dw.numel():
        lib = build.library()
        with torch.cuda.device(rows.device):
            stream = torch.cuda.current_stream(rows.device).cuda_stream
            err = lib.combine_dot_launch(
                g.data_ptr(), rows.data_ptr(), s32.data_ptr(), dw.data_ptr(),
                T, K, D, N, int(g.dtype == torch.bfloat16),
                int(rows.dtype == torch.bfloat16), stream)
        build.check(err, name)
        combine_reduce_bwd_cuda.launches += 1
    return drows.reshape(parts.shape), dw.to(weights.dtype)


combine_reduce_bwd_cuda.launches = 0


class CombineReduce(torch.autograd.Function):
    """``combine_reduce`` on the card (either form), differentiable in its
    parts and its weights through ``combine_reduce_bwd``."""

    @staticmethod
    def forward(ctx, fwd, bwd, parts, weights, sel, out_dtype):
        ctx.bwd = bwd
        ctx.save_for_backward(parts, weights, sel)
        return fwd(parts, weights, sel=sel, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, dout):
        parts, weights, sel = ctx.saved_tensors
        dparts, dw = ctx.bwd(parts, weights, sel, dout)
        return (None, None, dparts if ctx.needs_input_grad[2] else None,
                dw if ctx.needs_input_grad[3] else None, None, None)


def combine_reduce_train(fwd, bwd, parts, weights, sel=None, out_dtype=None):
    """:class:`CombineReduce` over the forward wrapper ``fwd`` and the
    backward wrapper ``bwd``, taking ``sel`` and ``out_dtype`` as the
    wrappers do."""
    return CombineReduce.apply(fwd, bwd, parts, weights, sel, out_dtype)
