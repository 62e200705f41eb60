"""Row gather into counted buckets: the LL dispatch's single write of each
(token, choice) row into its expert's receive rows.

``out[i] = table[src[i]]`` for each row i below its bucket's count (rows
in buckets of C = n / len(counts)) whose ``src`` lies in the table; every
other row of ``out`` is zero, so that a receive buffer is a function of
its inputs (the contract ``gather_quantize`` keeps, and what an expert
function over full buckets reads).  With ``weights``, ``out[i] =
weights[i] * table[src[i]]``, the product in fp32 and rounded once to the
table's dtype: the LL combine's backward.

The JAX package has no such kernel: its LL dispatch gathers a send buffer
and transposes it through an all-to-all (``repro/core/ep.py``).  The
port's rank-stacked world writes each row once at its receiver's slot
(``core/ep.py::dispatch_combine_ll``), as DeepEP's and UCCL-EP's LL
dispatch do.  :func:`gather_rows_plain` is what the CPU runs and what the
CUDA kernel (``csrc/gather_rows.cu``) is held to, bit for bit;
:func:`gather_rows_cuda` counts its launches in ``.launches``.

Gradient (:class:`GatherRows`, the card's path under autograd): a table
row's gradient is the sum of its occupied slots' upstream rows.  The
slots of a table row are its token's kept choices, which ``sel`` (T, K)
names (-1 for a choice without a slot), so the backward is
``combine_reduce``'s gathered form with unit weights, summed in fp32 in k
order.
"""
from __future__ import annotations

import torch

from repro_torch.core.plan import occupancy_mask
from repro_torch.kernels import build

Tensor = torch.Tensor

DTYPES = (torch.bfloat16, torch.float32)   # what the kernel takes


def live_rows(src: Tensor, counts: Tensor | None, n_table: int) -> Tensor:
    """(n,) bool: the rows below their bucket's count whose ``src`` names
    a row of an ``n_table``-row table."""
    live = (src >= 0) & (src < n_table)
    if counts is not None:
        B = counts.numel()
        live &= occupancy_mask(counts.reshape(B), B,
                               src.shape[0] // B).reshape(-1)
    return live


def gather_rows_plain(table: Tensor, src: Tensor, counts: Tensor | None = None,
                      weights: Tensor | None = None, *,
                      sel: Tensor | None = None) -> Tensor:
    """table (N, D); src (n,) int; counts (B,) with n % B == 0 (None: no
    bucket limit); weights (n,) or None -> (n, D) in table.dtype.  ``sel``
    is the backward's (read only by the card's autograd Function; autograd
    differentiates this version)."""
    N, D = table.shape
    live = live_rows(src, counts, N)
    if N == 0:
        return table.new_zeros((src.shape[0], D))
    rows = table[src.to(torch.int64).clamp(0, N - 1)]
    if weights is not None:
        rows = (rows.to(torch.float32)
                * weights.to(torch.float32)[:, None]).to(table.dtype)
    return torch.where(live[:, None], rows, rows.new_zeros(()))


def _vec_bytes(row_bytes: int, *ptrs: int) -> int:
    """The widest of 16, 4, 2, 1 bytes dividing the row and every
    address."""
    return next(v for v in (16, 4, 2, 1)
                if row_bytes % v == 0 and all(p % v == 0 for p in ptrs))


def gather_rows_cuda(table: Tensor, src: Tensor, counts: Tensor | None = None,
                     weights: Tensor | None = None, *,
                     sel: Tensor | None = None) -> Tensor:
    """CUDA kernel for :func:`gather_rows_plain`: a bf16 or fp32 table,
    contiguous; ``sel`` is not read here."""
    name = "gather_rows"
    if table.dim() != 2 or table.dtype not in DTYPES:
        raise ValueError(f"{name}: table must be a (N, D) bfloat16 or "
                         f"float32 tensor, got {tuple(table.shape)} "
                         f"{table.dtype}")
    N, D = table.shape
    n = src.shape[0]
    s32 = src.to(torch.int32).contiguous()
    cnt = None
    if counts is not None:
        cnt = counts.to(torch.int32).reshape(-1).contiguous()
        if cnt.numel() == 0 or n % cnt.numel():
            raise ValueError(f"{name}: {n} rows for {cnt.numel()} buckets")
    w = None
    if weights is not None:
        if tuple(weights.shape) != (n,):
            raise ValueError(f"{name}: weights must be ({n},)")
        w = weights.to(torch.float32).contiguous()
    for k, t in (("table", table), ("src", s32), ("counts", cnt),
                 ("weights", w)):
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: {k} is not a CUDA tensor ({t.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
    out = torch.empty((n, D), dtype=table.dtype, device=table.device)
    if n == 0 or D == 0:
        return out
    vec = _vec_bytes(D * table.element_size(), table.data_ptr(),
                     out.data_ptr())
    lib = build.library()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = lib.gather_rows_launch(
            table.data_ptr(), s32.data_ptr(),
            None if cnt is None else cnt.data_ptr(),
            None if w is None else w.data_ptr(), out.data_ptr(), N, n,
            n // cnt.numel() if cnt is not None else n, D,
            int(table.dtype == torch.bfloat16), vec, stream)
    build.check(err, name)
    gather_rows_cuda.launches += 1
    return out


gather_rows_cuda.launches = 0


class GatherRows(torch.autograd.Function):
    """``gather_rows`` on the card, differentiable in its table: the
    backward is the combine's gathered form (``bwd``) over ``sel`` with
    unit weights."""

    @staticmethod
    def forward(ctx, fwd, bwd, table, src, counts, sel):
        if sel is None:
            raise ValueError("gather_rows: a gradient needs sel, the (T, K) "
                             "slots of each table row")
        if sel.shape[0] != table.shape[0]:
            raise ValueError(f"gather_rows: sel names {sel.shape[0]} table "
                             f"rows, the table has {table.shape[0]}")
        ctx.bwd, ctx.dtype = bwd, table.dtype
        ctx.save_for_backward(sel)
        return fwd(table, src, counts)

    @staticmethod
    def backward(ctx, dout):
        sel, = ctx.saved_tensors
        ones = torch.ones(tuple(sel.shape), dtype=torch.float32,
                          device=dout.device)
        dtable = ctx.bwd(dout.contiguous(), ones, sel=sel, out_dtype=ctx.dtype)
        return None, None, dtable, None, None, None


def gather_rows_train(fwd, bwd, table, src, counts=None, *, sel=None):
    """:class:`GatherRows` over the forward wrapper ``fwd`` and the
    combine's wrapper ``bwd`` (the weighted form, the combine's backward,
    is called by it alone and has no gradient)."""
    return GatherRows.apply(fwd, bwd, table, src, counts, sel)
