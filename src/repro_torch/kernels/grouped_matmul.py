"""Grouped expert kernels: the port of ``repro.kernels.grouped_matmul``
(``grouped_matmul_pallas``, ``grouped_swiglu_pallas``,
``grouped_swiglu_db_pallas`` and ``gather_swiglu_scatter_pallas``).

Each kernel has a plain PyTorch version here (``*_plain``: what the CPU
path runs and what the CUDA kernel is held against on the card) and a
wrapper (``*_cuda``) that checks its inputs, allocates outputs and
scratch, and launches the hand-written CUDA kernel in
``csrc/grouped_matmul.cu``, ``csrc/grouped_swiglu.cu``,
``csrc/grouped_swiglu_db.cu`` or ``csrc/gather_swiglu_scatter.cu`` on the
current stream.  The wrappers take bf16 activations and weights and raise
on anything else; each counts its launches in ``.launches``.

The plain versions follow the kernels' rounding points: gate/up/down
products accumulate in fp32 from the working-dtype inputs, and the SwiGLU
activation ``h`` rounds to ``x.dtype`` before the down projection (the TPU
kernel's cast at grouped_matmul.py:144).  In fp32 they equal the reference
oracles of ``repro.kernels.ref``.
"""
from __future__ import annotations

import torch

from repro_torch.core.plan import occupancy_mask
from repro_torch.kernels import build

Tensor = torch.Tensor


def _flat_counts(counts, G: int, C: int, device):
    """(counts (G*B,) int32 clipped to the sub-bucket size, B) from (G,)
    or (G, B) counts."""
    if counts is None:
        return torch.full((G,), C, dtype=torch.int32, device=device), 1
    if counts.dim() not in (1, 2) or counts.shape[0] != G:
        raise ValueError(f"counts of shape {tuple(counts.shape)} for {G} groups")
    B = 1 if counts.dim() == 1 else counts.shape[1]
    if B == 0 or C % B:
        raise ValueError(f"{B} sub-buckets do not divide capacity {C}")
    return torch.clamp(counts.to(torch.int32).reshape(-1), max=C // B), B


def _refuse_bucketed(name: str, counts) -> None:
    """The grouped matmul and the double-buffered SwiGLU take flat (G,)
    counts only, as their TPU kernels assert (grouped_matmul.py:116, :303)."""
    if counts is not None and counts.dim() == 2 and counts.shape[1] != 1:
        raise ValueError(f"{name}: takes flat per-group counts, not "
                         f"bucketed counts of shape {tuple(counts.shape)}")


def _swiglu_rows(x: Tensor, wg: Tensor, wu: Tensor, wd: Tensor) -> Tensor:
    """x (..., C, D) @ per-expert weights -> fp32 (..., C, D)."""
    f32 = torch.float32
    g = torch.matmul(x.to(f32), wg.to(f32))
    u = torch.matmul(x.to(f32), wu.to(f32))
    h = (g * torch.sigmoid(g) * u).to(x.dtype)
    return torch.matmul(h.to(f32), wd.to(f32))


# ========================================================= grouped swiglu ==
def grouped_swiglu_plain(x: Tensor, w_gate: Tensor, w_up: Tensor,
                         w_down: Tensor, counts: Tensor | None = None) -> Tensor:
    """x (E, C, D); w_* (E, D, F) / (E, F, D); counts (E,) or (E, B).
    Rows beyond occupancy are exact zeros.  Returns x.dtype."""
    E, C, _ = x.shape
    if counts is not None:
        x = torch.where(occupancy_mask(counts, E, C)[..., None], x,
                        torch.zeros((), dtype=x.dtype, device=x.device))
    return _swiglu_rows(x, w_gate, w_up, w_down).to(x.dtype)


def _check_cuda(name: str, **tensors) -> None:
    for k, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {k} is not a CUDA tensor ({t.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {k} must be 16-byte aligned")


def _check_swiglu(name, x, w_gate, w_up, w_down, counts):
    """The grouped SwiGLU wrappers' checks: (F, counts (E*B,) int32, B)."""
    E, C, D = x.shape
    F = _check_weights(name, x, w_gate, w_up, w_down, w_gate.shape[0], D)
    if E != w_gate.shape[0]:
        raise ValueError(f"{name}: {E} groups for {w_gate.shape[0]} experts")
    cnt, B = _flat_counts(counts, E, C, x.device)
    cnt = cnt.contiguous()
    _check_cuda(name, x=x, w_gate=w_gate, w_up=w_up, w_down=w_down, cnt=cnt)
    return F, cnt, B


def _check_weights(name, x, w_gate, w_up, w_down, E, D):
    F = w_gate.shape[2]
    for k, w, shape in (("w_gate", w_gate, (E, D, F)), ("w_up", w_up, (E, D, F)),
                        ("w_down", w_down, (E, F, D))):
        if tuple(w.shape) != shape:
            raise ValueError(f"{name}: {k} shape {tuple(w.shape)} != {shape}")
        if w.dtype != torch.bfloat16:
            raise ValueError(f"{name}: {k} must be bfloat16, got {w.dtype}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{name}: activations must be bfloat16, got {x.dtype}")
    if D % 8 or F % 8:
        raise ValueError(f"{name}: D={D} and F={F} must be multiples of 8")
    return F


def grouped_swiglu_cuda(x: Tensor, w_gate: Tensor, w_up: Tensor,
                        w_down: Tensor, counts: Tensor | None = None) -> Tensor:
    """CUDA kernel for :func:`grouped_swiglu_plain` (bf16 in and out)."""
    name = "grouped_swiglu"
    E, C, D = x.shape
    F, cnt, B = _check_swiglu(name, x, w_gate, w_up, w_down, counts)
    G, Cg = E * B, C // B
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    h = torch.empty((G * Cg, F), dtype=x.dtype, device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.grouped_swiglu_launch(
            x.data_ptr(), cnt.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            w_down.data_ptr(), h.data_ptr(), y.data_ptr(), G, Cg, B, D, F,
            stream)
    build.check(err, name)
    grouped_swiglu_cuda.launches += 1
    return y


grouped_swiglu_cuda.launches = 0


# ======================================================== grouped matmul ==
def grouped_matmul_plain(x: Tensor, w: Tensor,
                         counts: Tensor | None = None) -> Tensor:
    """x (G, M, K) @ w (G, K, N) -> (G, M, N) in x.dtype, summed in fp32
    from w cast to x.dtype; rows at or past ``counts[g]`` (flat (G,)
    counts) read as zeros and are exact zeros."""
    _refuse_bucketed("grouped_matmul", counts)
    G, M, _ = x.shape
    if counts is not None:
        x = torch.where(occupancy_mask(counts, G, M)[..., None], x,
                        torch.zeros((), dtype=x.dtype, device=x.device))
    f32 = torch.float32
    return torch.matmul(x.to(f32), w.to(x.dtype).to(f32)).to(x.dtype)


def grouped_matmul_cuda(x: Tensor, w: Tensor,
                        counts: Tensor | None = None) -> Tensor:
    """CUDA kernel for :func:`grouped_matmul_plain` (bf16 in and out; K
    and N multiples of 8 for the tensor maps' 16-byte strides)."""
    name = "grouped_matmul"
    if (x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0]
            or w.shape[1] != x.shape[2]):
        raise ValueError(f"{name}: x {tuple(x.shape)} does not fit w "
                         f"{tuple(w.shape)}")
    G, M, K = x.shape
    N = w.shape[2]
    for k, t in (("x", x), ("w", w)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: {k} must be bfloat16, got {t.dtype}")
    if K % 8 or N % 8:
        raise ValueError(f"{name}: K={K} and N={N} must be multiples of 8")
    _refuse_bucketed(name, counts)
    cnt, _ = _flat_counts(counts, G, M, x.device)
    cnt = cnt.contiguous()
    _check_cuda(name, x=x, w=w, cnt=cnt)
    y = torch.empty((G, M, N), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.grouped_matmul_launch(x.data_ptr(), cnt.data_ptr(),
                                        w.data_ptr(), y.data_ptr(), G, M, K,
                                        N, stream)
    build.check(err, name)
    grouped_matmul_cuda.launches += 1
    return y


grouped_matmul_cuda.launches = 0


# ====================================== double-buffered grouped swiglu ====
def grouped_swiglu_db_plain(x: Tensor, w_gate: Tensor, w_up: Tensor,
                            w_down: Tensor,
                            counts: Tensor | None = None) -> Tensor:
    """The function of :func:`grouped_swiglu_plain`, flat (E,) counts only
    (the double-buffered kernel's contract)."""
    _refuse_bucketed("grouped_swiglu_db", counts)
    return grouped_swiglu_plain(x, w_gate, w_up, w_down, counts)


def grouped_swiglu_db_cuda(x: Tensor, w_gate: Tensor, w_up: Tensor,
                           w_down: Tensor,
                           counts: Tensor | None = None) -> Tensor:
    """CUDA kernel for :func:`grouped_swiglu_db_plain` (bf16 in and out):
    ``csrc/grouped_swiglu_db.cu``, the two passes of the grouped-expert
    tile loop (``csrc/swiglu_tiles.cuh``) with one count an expert, whose
    TMA ring streams only the occupied row tiles."""
    name = "grouped_swiglu_db"
    E, C, D = x.shape
    _refuse_bucketed(name, counts)
    F, cnt, _ = _check_swiglu(name, x, w_gate, w_up, w_down, counts)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    h = torch.empty((E * C, F), dtype=x.dtype, device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.grouped_swiglu_db_launch(
            x.data_ptr(), cnt.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            w_down.data_ptr(), h.data_ptr(), y.data_ptr(), E, C, D, F, stream)
    build.check(err, name)
    grouped_swiglu_db_cuda.launches += 1
    return y


grouped_swiglu_db_cuda.launches = 0


# ================================== fused gather -> swiglu -> scatter =====
def gather_swiglu_scatter_plain(x_ext: Tensor, src_of_slot: Tensor,
                                w_slot: Tensor, w_gate: Tensor, w_up: Tensor,
                                w_down: Tensor,
                                counts: Tensor | None = None) -> Tensor:
    """x_ext (T+1, D) with zero scratch row T; src_of_slot / w_slot (E*C,);
    counts (E,).  Each occupied slot adds ``w_slot * swiglu(x_ext[src])``
    in fp32 into row ``src``; returns (T, D) fp32.  The expert output is
    not rounded before the weighted add (the fused kernel keeps it fp32)."""
    E = w_gate.shape[0]
    Tp1, D = x_ext.shape
    C = src_of_slot.shape[0] // E
    src = src_of_slot.to(torch.int64)
    buf = x_ext[src].reshape(E, C, D)
    keep = (occupancy_mask(counts, E, C).reshape(-1) if counts is not None
            else torch.ones(E * C, dtype=torch.bool, device=x_ext.device))
    buf = torch.where(keep.reshape(E, C, 1), buf,
                      torch.zeros((), dtype=buf.dtype, device=buf.device))
    y = _swiglu_rows(buf, w_gate, w_up, w_down).reshape(E * C, D)
    w = torch.where(keep, w_slot.to(torch.float32), 0.0)
    out = torch.zeros((Tp1, D), dtype=torch.float32, device=x_ext.device)
    out.index_add_(0, torch.where(keep, src, Tp1 - 1), y * w[:, None])
    return out[:-1]


def _check_gss(name, x_ext, src_of_slot, w_slot, w_gate, w_up, w_down,
               counts):
    """The fused kernels' checks: (E, C, F, src int32, w_slot fp32, counts
    (E,) int32), each contiguous."""
    D = x_ext.shape[1]
    E = w_gate.shape[0]
    F = _check_weights(name, x_ext, w_gate, w_up, w_down, E, D)
    n_slots = src_of_slot.shape[0]
    if n_slots % E or w_slot.shape != (n_slots,):
        raise ValueError(f"{name}: {n_slots} slots / w_slot {tuple(w_slot.shape)} "
                         f"do not fit {E} experts")
    C = n_slots // E
    src = src_of_slot.to(torch.int32).contiguous()
    ws = w_slot.to(torch.float32).contiguous()
    cnt, B = _flat_counts(counts, E, C, x_ext.device)
    if B != 1:
        raise ValueError(f"{name}: takes flat per-expert counts")
    cnt = cnt.contiguous()
    _check_cuda(name, x_ext=x_ext, src=src, w_slot=ws, cnt=cnt, w_gate=w_gate,
                w_up=w_up, w_down=w_down)
    return E, C, F, src, ws, cnt


def gather_swiglu_scatter_cuda(x_ext: Tensor, src_of_slot: Tensor,
                               w_slot: Tensor, w_gate: Tensor, w_up: Tensor,
                               w_down: Tensor,
                               counts: Tensor | None = None) -> Tensor:
    """CUDA kernel for :func:`gather_swiglu_scatter_plain`: bf16 table and
    weights, fp32 ``w_slot``, (T, D) fp32 out (atomics: run-to-run order)."""
    name = "gather_swiglu_scatter"
    Tp1, D = x_ext.shape
    E, C, F, src, ws, cnt = _check_gss(name, x_ext, src_of_slot, w_slot,
                                       w_gate, w_up, w_down, counts)
    n_slots = E * C
    out = torch.zeros((Tp1, D), dtype=torch.float32, device=x_ext.device)
    if n_slots == 0 or Tp1 == 0:
        return out[:-1]
    h = torch.empty((n_slots, F), dtype=x_ext.dtype, device=x_ext.device)
    lib = build.library()
    with torch.cuda.device(x_ext.device):
        stream = torch.cuda.current_stream(x_ext.device).cuda_stream
        err = lib.gather_swiglu_scatter_launch(
            x_ext.data_ptr(), src.data_ptr(), ws.data_ptr(), cnt.data_ptr(),
            w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
            h.data_ptr(), out.data_ptr(), Tp1, E, C, D, F, stream)
    build.check(err, name)
    gather_swiglu_scatter_cuda.launches += 1
    return out[:-1]


gather_swiglu_scatter_cuda.launches = 0


# ============================================================ backward =====
# The TPU package has no backward kernels: the reference trains through the
# oracles of the two SwiGLU kernels (``repro.kernels.ref``), which jax.grad
# differentiates.  The plain versions below are explicit formulas with the
# CUDA kernels' rounding points (csrc/swiglu_bwd.cu): fp32 sums; g, u and
# h recomputed as the forward computes them (h rounded to the working
# dtype); the upstream gradient, and dg and du, rounded to the working
# dtype where they enter a product.  In fp32 every rounding is exact and
# they equal autograd through the forward.
def _swiglu_bwd_rows(x: Tensor, wg: Tensor, wu: Tensor, wd: Tensor,
                     dy: Tensor, w: Tensor | None):
    """The gradients of ``w * swiglu(x)`` for rows x (G, C, D), upstream dy
    (G, C, D) (any float dtype) and per-row weights w (G, C) (None: 1):
    (dx fp32 (G, C, D), dwg, dwu, dwd fp32, dw fp32 (G, C))."""
    f32, dt = torch.float32, x.dtype
    xf = x.to(f32)
    g = torch.matmul(xf, wg.to(f32))
    u = torch.matmul(xf, wu.to(f32))
    sg = torch.sigmoid(g)
    a = g * sg
    h = (a * u).to(dt).to(f32)
    dhu = torch.matmul(dy.to(dt).to(f32), wd.to(f32).transpose(-1, -2))
    dw = (dhu * h).sum(-1)
    dh = dhu if w is None else dhu * w[..., None]
    du = (dh * a).to(dt).to(f32)
    dg = (dh * u * sg * (1.0 + g * (1.0 - sg))).to(dt).to(f32)
    dx = (torch.matmul(dg, wg.to(f32).transpose(-1, -2))
          + torch.matmul(du, wu.to(f32).transpose(-1, -2)))
    dyw = dy if w is None else dy.to(f32) * w[..., None]
    xt = xf.transpose(-1, -2)
    return (dx, torch.matmul(xt, dg), torch.matmul(xt, du),
            torch.matmul(h.transpose(-1, -2), dyw.to(dt).to(f32)), dw)


def grouped_swiglu_bwd_plain(x: Tensor, w_gate: Tensor, w_up: Tensor,
                             w_down: Tensor, counts: Tensor | None,
                             dy: Tensor) -> tuple[Tensor, ...]:
    """The gradient of :func:`grouped_swiglu_plain` for the upstream ``dy``
    (E, C, D): ``(dx, dw_gate, dw_up, dw_down)``, each in its input's dtype.
    Rows at or past occupancy (flat (E,) or bucketed (E, B) counts) get
    exact zeros and add nothing to the weights' gradients."""
    E, C, _ = x.shape
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if counts is not None:
        keep = occupancy_mask(counts, E, C)[..., None]
        x = torch.where(keep, x, zero)
        dy = torch.where(keep, dy, torch.zeros((), dtype=dy.dtype,
                                               device=dy.device))
    dx, dwg, dwu, dwd, _ = _swiglu_bwd_rows(x, w_gate, w_up, w_down, dy, None)
    return (dx.to(x.dtype), dwg.to(w_gate.dtype), dwu.to(w_up.dtype),
            dwd.to(w_down.dtype))


def gather_swiglu_scatter_bwd_plain(x_ext: Tensor, src_of_slot: Tensor,
                                    w_slot: Tensor, w_gate: Tensor,
                                    w_up: Tensor, w_down: Tensor,
                                    counts: Tensor | None,
                                    dout: Tensor) -> tuple[Tensor, ...]:
    """The gradient of :func:`gather_swiglu_scatter_plain` for the upstream
    ``dout`` (T, D): ``(dx_ext, dw_slot, dw_gate, dw_up, dw_down)``.  An
    occupied slot s adds its row's gradient into ``dx_ext[src[s]]`` (a
    token in several slots sums them) and gets ``dw_slot[s] = <dout[src[s]],
    y_s>``, y_s its fp32 expert output; empty slots (past their count)
    add nothing and get 0.  The scratch row's upstream (row T) is 0."""
    E = w_gate.shape[0]
    Tp1, D = x_ext.shape
    C = src_of_slot.shape[0] // E
    src = src_of_slot.to(torch.int64)
    keep = (occupancy_mask(counts, E, C).reshape(-1) if counts is not None
            else torch.ones(E * C, dtype=torch.bool, device=x_ext.device))
    x = torch.where(keep[:, None], x_ext[src],
                    torch.zeros((), dtype=x_ext.dtype, device=x_ext.device))
    dout_ext = torch.cat([dout.to(torch.float32),
                          dout.new_zeros((1, D), dtype=torch.float32)])
    dy = torch.where(keep[:, None], dout_ext[src], 0.0)
    w = torch.where(keep, w_slot.to(torch.float32), 0.0)
    dx, dwg, dwu, dwd, dw = _swiglu_bwd_rows(
        x.reshape(E, C, D), w_gate, w_up, w_down, dy.reshape(E, C, D),
        w.reshape(E, C))
    dx_ext = torch.zeros((Tp1, D), dtype=torch.float32, device=x_ext.device)
    dx_ext.index_add_(0, torch.where(keep, src, Tp1 - 1),
                      dx.reshape(E * C, D))
    dw = torch.where(keep, dw.reshape(-1), 0.0)
    return (dx_ext.to(x_ext.dtype), dw.to(w_slot.dtype),
            dwg.to(w_gate.dtype), dwu.to(w_up.dtype), dwd.to(w_down.dtype))


def _check_dy(name: str, dy: Tensor, shape: tuple, dtype) -> Tensor:
    if tuple(dy.shape) != tuple(shape):
        raise ValueError(f"{name}: the upstream gradient has shape "
                         f"{tuple(dy.shape)}, not {tuple(shape)}")
    return dy.to(dtype).contiguous()


def grouped_swiglu_bwd_cuda(x: Tensor, w_gate: Tensor, w_up: Tensor,
                            w_down: Tensor, counts: Tensor | None,
                            dy: Tensor) -> tuple[Tensor, ...]:
    """CUDA kernel for :func:`grouped_swiglu_bwd_plain`
    (``csrc/swiglu_bwd.cu``): bf16 in and out, fp32 sums."""
    name = "grouped_swiglu_bwd"
    E, C, D = x.shape
    F, cnt, B = _check_swiglu(name, x, w_gate, w_up, w_down, counts)
    dy = _check_dy(name, dy, x.shape, x.dtype)
    _check_cuda(name, dy=dy)
    if x.numel() == 0 or F == 0:
        return (torch.zeros_like(x), torch.zeros_like(w_gate),
                torch.zeros_like(w_up), torch.zeros_like(w_down))
    dx = torch.empty_like(x)
    dwg, dwu, dwd = (torch.empty_like(w) for w in (w_gate, w_up, w_down))
    h, dg, du = (torch.empty((E * C, F), dtype=x.dtype, device=x.device)
                 for _ in range(3))
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.grouped_swiglu_bwd_launch(
            x.data_ptr(), cnt.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            w_down.data_ptr(), dy.data_ptr(), h.data_ptr(), dg.data_ptr(),
            du.data_ptr(), dx.data_ptr(), dwg.data_ptr(), dwu.data_ptr(),
            dwd.data_ptr(), E, C, B, D, F, stream)
    build.check(err, name)
    grouped_swiglu_bwd_cuda.launches += 1
    return dx, dwg, dwu, dwd


grouped_swiglu_bwd_cuda.launches = 0


def gather_swiglu_scatter_bwd_cuda(x_ext: Tensor, src_of_slot: Tensor,
                                   w_slot: Tensor, w_gate: Tensor,
                                   w_up: Tensor, w_down: Tensor,
                                   counts: Tensor | None,
                                   dout: Tensor) -> tuple[Tensor, ...]:
    """CUDA kernel for :func:`gather_swiglu_scatter_bwd_plain`
    (``csrc/swiglu_bwd.cu``): dx_ext adds with fp32 atomics (run-to-run
    order), then rounds to the table's bf16; dw_slot fp32."""
    name = "gather_swiglu_scatter_bwd"
    Tp1, D = x_ext.shape
    E, C, F, src, ws, cnt = _check_gss(name, x_ext, src_of_slot, w_slot,
                                       w_gate, w_up, w_down, counts)
    n_slots = E * C
    dout = _check_dy(name, dout, (Tp1 - 1, D), torch.float32)
    _check_cuda(name, dout=dout)
    dx = torch.zeros((Tp1, D), dtype=torch.float32, device=x_ext.device)
    dws = torch.zeros(n_slots, dtype=torch.float32, device=x_ext.device)
    if n_slots == 0 or Tp1 == 0 or F == 0 or D == 0:
        return (dx.to(x_ext.dtype), dws.to(w_slot.dtype),
                torch.zeros_like(w_gate), torch.zeros_like(w_up),
                torch.zeros_like(w_down))
    dwg, dwu, dwd = (torch.empty_like(w) for w in (w_gate, w_up, w_down))
    h, dg, du = (torch.empty((n_slots, F), dtype=x_ext.dtype,
                             device=x_ext.device) for _ in range(3))
    lib = build.library()
    with torch.cuda.device(x_ext.device):
        stream = torch.cuda.current_stream(x_ext.device).cuda_stream
        err = lib.gather_swiglu_scatter_bwd_launch(
            x_ext.data_ptr(), src.data_ptr(), ws.data_ptr(), cnt.data_ptr(),
            w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
            dout.data_ptr(), h.data_ptr(), dg.data_ptr(), du.data_ptr(),
            dx.data_ptr(), dws.data_ptr(), dwg.data_ptr(), dwu.data_ptr(),
            dwd.data_ptr(), Tp1, E, C, D, F, stream)
    build.check(err, name)
    gather_swiglu_scatter_bwd_cuda.launches += 1
    return dx.to(x_ext.dtype), dws.to(w_slot.dtype), dwg, dwu, dwd


gather_swiglu_scatter_bwd_cuda.launches = 0


class GroupedSwiGLU(torch.autograd.Function):
    """``grouped_swiglu`` on the card, differentiable: the forward kernel,
    and the backward kernel on the saved inputs (no intermediate is kept:
    the backward recomputes g, u and h).  ``fwd`` and ``bwd`` are the two
    kernels' wrappers (``ops`` passes the ones it has registered)."""

    @staticmethod
    def forward(ctx, fwd, bwd, x, w_gate, w_up, w_down, counts):
        ctx.bwd = bwd
        ctx.save_for_backward(x, w_gate, w_up, w_down, counts)
        return fwd(x, w_gate, w_up, w_down, counts)

    @staticmethod
    def backward(ctx, dy):
        x, wg, wu, wd, counts = ctx.saved_tensors
        return (None, None, *ctx.bwd(x, wg, wu, wd, counts, dy), None)


class GatherSwiGLUScatter(torch.autograd.Function):
    """``gather_swiglu_scatter`` on the card, differentiable (as
    :class:`GroupedSwiGLU`): gradients to the token table, the slot
    weights and the three expert weights."""

    @staticmethod
    def forward(ctx, fwd, bwd, x_ext, src_of_slot, w_slot, w_gate, w_up,
                w_down, counts):
        ctx.bwd = bwd
        ctx.save_for_backward(x_ext, src_of_slot, w_slot, w_gate, w_up,
                              w_down, counts)
        return fwd(x_ext, src_of_slot, w_slot, w_gate, w_up, w_down, counts)

    @staticmethod
    def backward(ctx, dout):
        x_ext, src, w_slot, wg, wu, wd, counts = ctx.saved_tensors
        dx, dws, dwg, dwu, dwd = ctx.bwd(x_ext, src, w_slot, wg, wu, wd,
                                         counts, dout)
        return None, None, dx, None, dws, dwg, dwu, dwd, None
