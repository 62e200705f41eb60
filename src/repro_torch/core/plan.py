"""EP dispatch planning in torch: the port of ``repro.core.plan``.

Given a routing table this computes slot assignment (arrival-order rank of
each choice within its destination group), per-group counts, capacity
keep/drop masks and the per-(token, group) dedup tables of HT mode.  Plans
are bit-identical to the reference's numpy dialect (the tests hold them to
it).  Nothing here synchronises with the device: no boolean-mask indexing,
no ``nonzero``, no ``.item()``.

Rank-stacked world: :func:`make_world_plan` and :func:`dedup_entry_table`
also take a leading rank axis ``(R, T, K)`` and plan every rank
independently in one pass, by offsetting group ids per rank.
"""
from __future__ import annotations

import inspect
import weakref
from typing import NamedTuple

import torch

Tensor = torch.Tensor


_ACCEPTS_COUNTS_CACHE = weakref.WeakKeyDictionary()


def _accepts_counts(fn) -> bool:
    """Counts-aware iff the callable takes *args, or its second positional
    parameter is named ``counts`` (or the ``c`` shorthand).  Neither arity
    nor a None default is enough: a one-argument fn with an unrelated
    second parameter (``def fn(tokens, scale=1.0)``) must never receive the
    counts as that argument."""
    try:
        params = list(inspect.signature(fn).parameters.values())
    except (TypeError, ValueError):      # no introspectable signature
        return True                      # assume the current contract
    if any(p.kind == inspect.Parameter.VAR_POSITIONAL for p in params):
        return True
    pos = [p for p in params
           if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                         inspect.Parameter.POSITIONAL_OR_KEYWORD)]
    return len(pos) >= 2 and pos[1].name in ("counts", "c")


def call_expert_fn(fn, tokens: Tensor, counts: Tensor):
    """Invoke an expert_fn: ``fn(tokens, counts)`` for a counts-aware fn,
    ``fn(tokens)`` over the full buckets for a one-argument one.  The two
    are told apart by signature (never by catching TypeError, which would
    hide a TypeError raised inside a counts-aware fn), memoized per
    callable."""
    try:
        accepts = _ACCEPTS_COUNTS_CACHE.get(fn)
        if accepts is None:
            accepts = _ACCEPTS_COUNTS_CACHE[fn] = _accepts_counts(fn)
    except TypeError:                    # not weakref-able / not hashable
        accepts = _accepts_counts(fn)
    return fn(tokens, counts) if accepts else fn(tokens)


def occupancy_mask(counts: Tensor, n_groups: int, width: int) -> Tensor:
    """(G, width) bool mask from (G,) occupied-prefix counts, or (G, B)
    sub-bucket counts where each width//B sub-bucket is occupied-prefix."""
    counts = counts.to(torch.int32)
    B = 1 if counts.dim() == 1 else counts.shape[1]
    cb = width // B
    ar = torch.arange(cb, device=counts.device)
    m = ar[None, None, :] < torch.clamp(counts.reshape(n_groups, B, 1),
                                        max=cb)
    return m.reshape(n_groups, width)


def effective_chunks(T: int, chunks: int) -> int:
    """Largest divisor of T that is <= the requested HT chunk count."""
    chunks = max(1, min(chunks, T)) if T else 1
    while T % chunks:
        chunks -= 1
    return chunks


# ------------------------------------------------------------ wire layout --
# one fp32 absmax scale per WIRE_BLOCK features on low-precision wires
WIRE_BLOCK = 128


class WireLayout(NamedTuple):
    """Byte layout of one token row on the wire for a given ``wire_dtype``."""

    token_bytes: int   # full wire bytes per row (q_bytes + scale_bytes)
    q_bytes: int       # quantized payload bytes (D elements)
    n_blocks: int      # scale blocks per row (0 for fp32 passthrough)
    scale_bytes: int   # inline fp32 scale bytes (4 * n_blocks)


def wire_layout(d: int, wire_dtype: str = "fp32") -> WireLayout:
    if wire_dtype == "fp32":
        return WireLayout(4 * d, 4 * d, 0, 0)
    if wire_dtype in ("fp8", "int8"):
        nb = -(-d // WIRE_BLOCK)
        return WireLayout(d + 4 * nb, d, nb, 4 * nb)
    raise ValueError(f"unknown wire_dtype: {wire_dtype!r}")


# ------------------------------------------------------- slot assignment --
def rank_in_group(group_id: Tensor, n_groups: int, valid: Tensor) -> Tensor:
    """Arrival-order rank of each row within its group (valid rows only).

    group_id: (N,) ints in [0, n_groups); valid: (N,) bool.  Returns (N,)
    int32; the rank of an invalid row is meaningless but in range.  A stable
    sort groups the rows; each row's rank is its sorted position minus the
    start of its run (found with ``cummax``, so no host sync).
    """
    n = group_id.numel()
    dev = group_id.device
    gid = torch.where(valid, group_id, n_groups).to(torch.int64)
    order = torch.sort(gid, stable=True).indices
    sg = gid[order]
    pos = torch.arange(n, device=dev)
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    if n > 1:
        is_start[1:] = sg[1:] != sg[:-1]
    start = torch.where(is_start, pos, 0).cummax(0).values
    rank = torch.empty(n, dtype=torch.int32, device=dev)
    rank[order] = (pos - start).to(torch.int32)
    return rank


def group_counts(group_id: Tensor, n_groups: int, valid: Tensor) -> Tensor:
    """Number of valid rows per group: (n_groups,) int32."""
    gid = torch.where(valid, group_id, n_groups).reshape(-1).to(torch.int64)
    c = torch.zeros(n_groups + 1, dtype=torch.int64, device=gid.device)
    c.scatter_add_(0, gid, torch.ones_like(gid))
    return c[:n_groups].to(torch.int32)


def flat_slots(group_id: Tensor, rank: Tensor, keep: Tensor, capacity: int,
               n_groups: int) -> Tensor:
    """Flat receive-slot index ``g * capacity + rank`` for kept entries;
    dropped/invalid entries point at the scratch slot ``n_groups*capacity``."""
    return torch.where(keep, group_id * capacity + rank, n_groups * capacity)


class DispatchPlan(NamedTuple):
    """Routing decisions for one shard's (T, K) table over ``n_groups``."""

    rank: Tensor       # (T, K) arrival-order rank per (row, group)
    counts: Tensor     # (n_groups,) valid choices per group
    valid: Tensor      # (T, K) bool: group id >= 0
    keep: Tensor       # (T, K) valid & rank < capacity
    n_dropped: Tensor  # scalar: valid choices lost to capacity


def make_plan(group_idx: Tensor, n_groups: int, capacity: int) -> DispatchPlan:
    """Plan a (T, K) routing table: group ids in [0, n_groups), -1 = pad."""
    valid = group_idx >= 0
    flat = group_idx.reshape(-1)
    fv = valid.reshape(-1)
    rank = rank_in_group(flat, n_groups, fv).reshape(group_idx.shape)
    counts = group_counts(flat, n_groups, fv)
    keep = valid & (rank < capacity)
    return DispatchPlan(rank, counts, valid, keep, (valid & ~keep).sum())


def make_world_plan(group_idx: Tensor, n_groups: int,
                    capacity: int) -> DispatchPlan:
    """Plan an (R, T, K) table; groups are independent per source rank, so
    the result equals stacking :func:`make_plan` per rank (``counts`` is
    (R, n_groups), ``n_dropped`` is (R,))."""
    R = group_idx.shape[0]
    valid = group_idx >= 0
    r_of = torch.arange(R, device=group_idx.device).reshape(
        (R,) + (1,) * (group_idx.dim() - 1))
    gid = torch.where(valid, group_idx + r_of * n_groups, -1)
    flat, fv = gid.reshape(-1), valid.reshape(-1)
    rank = rank_in_group(flat, R * n_groups, fv).reshape(group_idx.shape)
    counts = group_counts(flat, R * n_groups, fv).reshape(R, n_groups)
    keep = valid & (rank < capacity)
    n_dropped = (valid & ~keep).reshape(R, -1).sum(1)
    return DispatchPlan(rank, counts, valid, keep, n_dropped)


# ------------------------------------------------------- load accounting --
def expert_load(top_idx: Tensor, n_experts: int) -> Tensor:
    """Per-expert valid routed-choice counts as float32."""
    flat = top_idx.reshape(-1)
    return group_counts(flat, n_experts, flat >= 0).to(torch.float32)


def load_imbalance(counts: Tensor) -> Tensor:
    """max/mean load (1.0 = balanced; 1.0 also for an empty table)."""
    c = counts.to(torch.float32)
    m = c.mean()
    return torch.where(m > 0, c.max() / torch.clamp(m, min=1e-9),
                       torch.ones_like(m))


# ------------------------------------------------------------ dedup table --
def dedup_first(group_of: Tensor, valid: Tensor) -> Tensor:
    """(..., T, K) first-occurrence mask per (token, group) over the K
    choices: True iff choice k is the first valid choice of its row routed
    to that group."""
    K = group_of.shape[-1]
    same = group_of[..., :, None] == group_of[..., None, :]     # (..., T, K, K)
    ar = torch.arange(K, device=group_of.device)
    earlier = ar[:, None] > ar[None, :]
    return valid & ~torch.any(same & earlier & valid[..., None, :], dim=-1)


def dedup_entry_table(group_of: Tensor, valid: Tensor, n_groups: int,
                      capacity: int):
    """Dedup'd (token, group) entry table with capacity bucketing.

    group_of/valid: (T, K), or rank-stacked (R, T, K).  Returns
    ``(first, entry_valid, rank_tg, keep_tg, n_dropped)`` with the shapes
    (.., T, K), (.., T, G), (.., T, G), (.., T, G) and (..) — see the
    reference's ``plan.dedup_entry_table``.
    """
    stacked = group_of.dim() == 3
    g3 = group_of if stacked else group_of[None]
    v3 = valid if stacked else valid[None]
    R, T, K = g3.shape
    dev = g3.device
    first = dedup_first(g3, v3)
    r_of = torch.arange(R, device=dev)[:, None, None].expand(R, T, K)
    t_of = torch.arange(T, device=dev)[None, :, None].expand(R, T, K)
    g_safe = torch.where(first, g3, 0).to(torch.int64)
    idx = (r_of, t_of, g_safe)
    # accumulate=True keeps the writes deterministic: only first-occurrence
    # choices add anything, and each (t, g) has at most one of them
    entry_valid = torch.zeros((R, T, n_groups), dtype=torch.int32, device=dev)
    entry_valid.index_put_(idx, first.to(torch.int32), accumulate=True)
    entry_valid = entry_valid > 0
    flat_g = torch.where(first, g3 + r_of * n_groups, -1).reshape(-1)
    rank_flat = rank_in_group(flat_g, R * n_groups, flat_g >= 0).reshape(
        R, T, K)
    rank_tg = torch.zeros((R, T, n_groups), dtype=torch.int32, device=dev)
    rank_tg.index_put_(idx, torch.where(first, rank_flat, 0),
                       accumulate=True)
    keep_tg = entry_valid & (rank_tg < capacity)
    n_dropped = (entry_valid & ~keep_tg).reshape(R, -1).sum(1)
    if not stacked:
        return (first[0], entry_valid[0], rank_tg[0], keep_tg[0],
                n_dropped[0])
    return first, entry_valid, rank_tg, keep_tg, n_dropped
