"""AdamW over flat lists of fp32 leaves on the card, clipped by the global
gradient norm: the non-factored update of ``optim.adamw.apply_updates``
there.  It replaces no TPU kernel: the JAX package leaves its optimizer to
XLA, which fuses a leaf's update into one loop.

:func:`adamw_cuda` (``csrc/adamw.cu``) moves the least bytes a clipped
step can: a pass that reads each gradient for the norm, then a pass a leaf
that reads g, p, mu and nu and writes p, mu and nu, with the clip scale
kept on the device.  Its plain version is ``optim.adamw.adamw_leaf`` after
``global_norm``, the eager chain the CPU runs; the two differ only in
rounding: the kernel sums the norm in fp64 and contracts products into
FMAs where the chain rounds each operation.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch import tracing
from repro_torch.kernels import build

Tensor = torch.Tensor

NORM_THREADS = 256          # csrc/adamw.cu kThreads
NORM_MAX_BLOCKS = 1024      # partials a leaf at most


def norm_blocks(n: int) -> int:
    """The norm pass's blocks (partials) for a leaf of ``n`` elements: a
    function of ``n`` alone, so the norm's bits depend on no card."""
    return min(-(-n // (4 * NORM_THREADS)), NORM_MAX_BLOCKS)


def _host_float(name: str, x) -> float:
    """A host scalar: a Python number or a CPU tensor of one element; a
    CUDA tensor raises rather than make the host wait for the device."""
    if isinstance(x, Tensor) and x.device.type != "cpu":
        raise ValueError(f"adamw: {name} must be a Python number or a CPU "
                         f"tensor, got one on {x.device}")
    return float(x)


def adamw_cuda(params: Sequence[Tensor], grads: Sequence[Tensor],
               mu: Sequence[Tensor], nu: Sequence[Tensor], *, lr, c1, c2,
               b1: float, b2: float, eps: float, weight_decay: float,
               max_grad_norm: Optional[float]) -> Tensor:
    """One AdamW step of every leaf, in place, after the clip to
    ``max_grad_norm`` by the global norm (none where it is None): contiguous
    fp32 leaves on one card, ``lr`` and the bias corrections ``c1`` and
    ``c2`` (``1 - b ** step``) on the host.  Returns the global norm as
    a 0-d tensor on the card; nothing waits for the device.  Adds the
    leaves updated to the counter ``optim.fused_leaves``."""
    name = "adamw"
    n = len(params)
    if not n or not len(grads) == len(mu) == len(nu) == n:
        raise ValueError(f"{name}: {n} params, {len(grads)} grads, "
                         f"{len(mu)} mu and {len(nu)} nu leaves")
    dev = params[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: leaves on {dev}, not a CUDA device")
    for quad in zip(params, grads, mu, nu):
        for k, t in zip(("params", "grads", "mu", "nu"), quad):
            if t.dtype != torch.float32:
                raise ValueError(f"{name}: {k} must be float32, got {t.dtype}")
            if t.device != dev:
                raise ValueError(f"{name}: {k} on {t.device}, params on {dev}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: {k} must be contiguous")
            if t.shape != quad[0].shape:
                raise ValueError(f"{name}: {k} shape {tuple(t.shape)} != "
                                 f"{tuple(quad[0].shape)}")
    lr, c1, c2 = (_host_float(k, x) for k, x in (("lr", lr), ("c1", c1),
                                                 ("c2", c2)))
    clip = max_grad_norm is not None
    blocks = [norm_blocks(g.numel()) for g in grads]
    partials = torch.empty(sum(blocks), dtype=torch.float64, device=dev)
    out = torch.empty(2, dtype=torch.float32, device=dev)  # gnorm, scale
    lib = build.library()
    launches = 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        at = partials.data_ptr()
        for g, nb in zip(grads, blocks):
            if nb:
                build.check(lib.adamw_norm_partials_launch(
                    g.data_ptr(), g.numel(), at, nb, stream), name)
                at += 8 * nb
                launches += 1
        build.check(lib.adamw_norm_finish_launch(
            partials.data_ptr(), partials.numel(),
            float(max_grad_norm) if clip else 1.0, int(clip),
            out.data_ptr(), stream), name)
        launches += 1
        scale = out.data_ptr() + 4
        for p, g, m, v in zip(params, grads, mu, nu):
            if p.numel():
                build.check(lib.adamw_update_launch(
                    p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                    p.numel(), scale, lr, b1, b2, 1 - b1, 1 - b2, c1, c2, eps,
                    weight_decay, stream), name)
                launches += 1
    adamw_cuda.launches += launches
    tracing.count("optim.fused_leaves", n)
    return out[0]


adamw_cuda.launches = 0

