"""Explicit sequence-parallel collectives over a rank-stacked world: the
port of ``repro.distributed.collectives``.

    sp_gather :  fwd all-gather(seq)      bwd reduce-scatter(seq)
    sp_scatter:  fwd reduce-scatter(seq)  bwd all-gather(seq)

(Megatron-LM sequence parallelism.)  The reference pins this schedule with
custom-vjp ``shard_map`` islands because XLA's partitioner picks a slower
transpose; its model never calls them, and the port's model does not
either.  They are ported so that the package does all the reference does.

The rank-stacked layout.  A world of ``pod`` x ``model`` ranks holds a
(B, S, D) activation as ``(pod, model, B / pod, S_r, D)``: rank (p, m)
holds batch group p and, sharded over the sequence, slice m
(``S_r = S / model``), or, replicated, the whole sequence.
:func:`all_gather_seq` and :func:`reduce_scatter_seq` are the two
collectives on that layout: a concatenation over the model axis, and a sum
over it in rank order (a fixed order, so every rank's sum is the same).

:func:`sp_gather` and :func:`sp_scatter` take and return the logical
(B, S, D) tensor, as the reference's functions take and return a global
array, and lay it out over the ranks inside.  A replicated layout holds one
copy a rank: the logical value is any one copy (rank 0's), and a
replicated cotangent reaches every copy.  So, as under ``jax.vjp`` of the
reference, ``sp_gather``'s forward is the identity and its backward sums
the model ranks' copies (``model`` x the cotangent), and ``sp_scatter``'s
forward sums the copies and its backward is the identity.  Both pass ``x``
through when there is no world or no model axis, or when the model axis
does not divide the sequence or the pods the batch, as the reference does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed.sharding import DistCtx

Tensor = torch.Tensor


def all_gather_seq(xs: Tensor) -> Tensor:
    """(G, M, b, s, D) sequence shards -> (G, M, b, M * s, D): every rank
    of a batch group holds the concatenation of its group's shards."""
    G, M, b, s, D = xs.shape
    full = xs.permute(0, 2, 1, 3, 4).reshape(G, b, M * s, D)
    return full[:, None].expand(G, M, b, M * s, D).contiguous()


def reduce_scatter_seq(xs: Tensor) -> Tensor:
    """(G, M, b, S, D) per-rank partial sums -> (G, M, b, S / M, D): rank
    (g, m) holds slice m of the sum over its group's ranks, added in rank
    order."""
    G, M, b, S, D = xs.shape
    parts = xs.reshape(G, M, b, M, S // M, D)
    acc = parts[:, 0]
    for j in range(1, M):
        acc = acc + parts[:, j]
    return acc.permute(0, 2, 1, 3, 4).contiguous()


def _shards(x: Tensor, G: int, M: int) -> Tensor:
    """(B, S, D) -> (G, M, B / G, S / M, D) sequence shards."""
    B, S, D = x.shape
    return x.reshape(G, B // G, M, S // M, D).permute(0, 2, 1, 3, 4)


def _unshard(xs: Tensor) -> Tensor:
    """The inverse of :func:`_shards`."""
    G, M, b, s, D = xs.shape
    return xs.permute(0, 2, 1, 3, 4).reshape(G * b, M * s, D)


def _replicas(x: Tensor, G: int, M: int) -> Tensor:
    """(B, S, D) -> (G, M, B / G, S, D): one copy a model rank."""
    B, S, D = x.shape
    return x.reshape(G, 1, B // G, S, D).expand(G, M, B // G, S, D)


def _first_replica(xs: Tensor) -> Tensor:
    """(G, M, b, S, D) replicas -> the (G * b, S, D) logical value."""
    G, _, b, S, D = xs.shape
    return xs[:, 0].reshape(G * b, S, D)


class _SPGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, G: int, M: int):
        ctx.groups = (G, M)
        return _first_replica(all_gather_seq(_shards(x, G, M)))

    @staticmethod
    def backward(ctx, ct):
        G, M = ctx.groups
        return _unshard(reduce_scatter_seq(_replicas(ct, G, M))), None, None


class _SPScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, G: int, M: int):
        ctx.groups = (G, M)
        return _unshard(reduce_scatter_seq(_replicas(x, G, M)))

    @staticmethod
    def backward(ctx, ct):
        G, M = ctx.groups
        return (_first_replica(all_gather_seq(_shards(ct, G, M))), None,
                None)


def _groups(dist: Optional[DistCtx], x: Tensor) -> Optional[tuple[int, int]]:
    """(pods, models) of the world over x (B, S, D), or None where x
    passes through."""
    if dist is None or dist.model_axis is None:
        return None
    G, M = dist.axis_size("pod"), dist.axis_size("model")
    if x.shape[1] % M or x.shape[0] % G:
        return None
    return G, M


def sp_gather(dist: Optional[DistCtx], x: Tensor) -> Tensor:
    """(B, S, D) sharded over the sequence -> (B, S, D) replicated over
    the model axis."""
    g = _groups(dist, x)
    return x if g is None else _SPGather.apply(x, *g)


def sp_scatter(dist: Optional[DistCtx], x: Tensor) -> Tensor:
    """(B, S, D) partial sums over the model axis -> (B, S, D) reduced,
    sharded over the sequence."""
    g = _groups(dist, x)
    return x if g is None else _SPScatter.apply(x, *g)
