"""Gradient compression: int8 block-quantised ring reduce-scatter with
error feedback, over a rank-stacked world (the port of
``repro.distributed.compression``).

On a ring of P ranks each hop sends an int8-quantised partial sum instead
of fp32: 4x fewer bytes over the wire.  Error feedback keeps each rank's
quantisation residual and adds it to the next step's gradient, which keeps
the compressed SGD unbiased over time.

The reference runs the ring inside ``shard_map``, one program a rank.  Here
the P ranks sit on the leading axis of one ``(P, n)`` tensor: a hop's
``ppermute`` (rank i sends to i + 1) is a roll of that axis by one, and the
tiled all-gather that reassembles the reduced chunks is a broadcast of the
concatenated chunks to every rank.  The hop order is the reference's (rank
i starts on chunk (i - 1) % P), with fp32 accumulation, so every rank's
partial sums are the reference's.

The quantizer is the port's one block quantizer,
``repro_torch.core.transport.codec`` (shared with the wire-dispatch codec);
this module supplies the ring and the error feedback at the
gradient-friendly block width ``BLOCK``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.transport.codec import (dequantize_blocked,
                                              quantize_blocked)

Tensor = torch.Tensor

BLOCK = 256


class QChunk(NamedTuple):
    q: Tensor        # int8 payload, (..., nb, BLOCK)
    scale: Tensor    # fp32 per-block scales, (..., nb)


def quantize(x: Tensor) -> QChunk:
    """Symmetric per-block int8 quantisation of fp32 vectors (..., n); each
    leading index (a rank) quantises its own vector."""
    n = x.shape[-1]
    nb = -(-n // BLOCK)
    xp = torch.nn.functional.pad(x, (0, nb * BLOCK - n))
    q, scale = quantize_blocked(xp.reshape(*x.shape[:-1], nb, BLOCK),
                                "int8", block=BLOCK)
    return QChunk(q=q, scale=scale[..., 0])


def dequantize(c: QChunk, n: int) -> Tensor:
    """(..., nb, BLOCK) int8 and (..., nb) scales -> fp32 (..., n)."""
    out = dequantize_blocked(c.q, c.scale[..., None], block=BLOCK)
    return out.reshape(*out.shape[:-2], -1)[..., :n]


def _take_chunks(xc: Tensor, idx: Tensor) -> Tensor:
    """Rank r's chunk ``idx[r]`` of xc (P, P, chunk): (P, chunk)."""
    return xc[torch.arange(xc.shape[0], device=xc.device), idx]


def compressed_psum_scatter(x: Tensor) -> Tensor:
    """Ring reduce-scatter with int8 hops of the rank-stacked fp32 vectors
    x (P, n): row r of the result, (P, n / P), is chunk r of the sum over
    ranks.  Each of the P - 1 hops moves every rank's quantised partial sum
    one rank on (i -> i + 1), then dequantises it, adds the local chunk and
    requantises (fp32 accumulation, int8 wire)."""
    P, n = x.shape
    assert n % P == 0, (n, P)
    chunk = n // P
    xc = x.reshape(P, P, chunk)
    # rank i starts accumulating chunk (i - 1); chunks move one rank a hop,
    # so after P - 1 hops rank i holds chunk i fully reduced
    acc_i = (torch.arange(P, device=x.device) - 1) % P
    q = quantize(_take_chunks(xc, acc_i))
    for _ in range(P - 1):
        q = QChunk(q=torch.roll(q.q, 1, dims=0),
                   scale=torch.roll(q.scale, 1, dims=0))
        acc_i = (acc_i - 1) % P          # chunk id now held locally
        acc = dequantize(q, chunk) + _take_chunks(xc, acc_i)
        q = quantize(acc)
    return dequantize(q, chunk)


def ef_compressed_mean(per_shard: Tensor, residual: Optional[Tensor] = None
                       ) -> tuple[Tensor, Tensor]:
    """Error-feedback compressed all-reduce mean (EF14 + int8 ring hops).

    ``per_shard``: (P, n), row i rank i's local gradient vector;
    ``residual``: (P, n), each rank's EF memory from the previous step, or
    None.  Each rank adds its residual, quantises its contribution to int8
    (the wire format), keeps the quantisation error as its new residual,
    and the ring reduce-scatter (int8 hops, fp32 accumulation) and
    all-gather give the mean on every rank.  Returns (mean (n,),
    new_residual (P, n))."""
    n_ranks, n = per_shard.shape
    assert n % (n_ranks * BLOCK) == 0, \
        f"pad input to a multiple of {n_ranks * BLOCK}"
    if residual is None:
        residual = torch.zeros_like(per_shard)
    contrib = per_shard + residual
    deq = dequantize(quantize(contrib), n)
    new_res = contrib - deq                      # EF memory
    mine = compressed_psum_scatter(deq)          # (P, n / P) summed
    # the tiled all-gather: every rank holds the same concatenation, so
    # the mean of rank 0 is every rank's.  The divisor is the run's rank
    # count, not a constant (LNT-SCALE-DIV does not apply); dividing, as
    # the reference's ``full / P`` does, keeps its result bit for bit
    return mine.reshape(n) / n_ranks, new_res


def pad_to_ring(x: Tensor, P: int) -> Tensor:
    """x flattened and zero-padded to a multiple of ``P * BLOCK``."""
    flat = x.reshape(-1)
    return torch.nn.functional.pad(flat, (0, (-flat.numel()) % (P * BLOCK)))
