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

Replicated expert placement (:class:`Placement`): a logical expert may own
several physical slots; its tables are numpy arrays, built on the host as
the reference builds them, and :func:`split_to_physical` /
:func:`split_to_physical_world` map a routing tensor's logical choices to
physical slots.
"""
from __future__ import annotations

import inspect
import weakref
from typing import NamedTuple, Optional

import numpy as np
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


def receive_bucket_table(n_buckets: int, base: int, stride: int,
                         extent: Optional[int] = None, gid0: int = 0,
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Receive-bucket registration table ``(bases, extents, guard_ids)``
    (numpy int64, built on the host for the transport substrate).

    Bucket ``g`` occupies bytes ``[base + g*stride, base + g*stride +
    extent)`` and owns guard id ``gid0 + g``: the table the EP executor
    registers with each rank's proxy, so that the receiver resolves a
    write's landing offset to its completion-fence guard (DESIGN.md §12).
    ``extent`` defaults to ``stride``.  ``gid0`` offsets the ids into a
    per-layer namespace when several layers' tables coexist in one EP
    session (DESIGN.md §16)."""
    ext = stride if extent is None else extent
    assert 0 < ext <= stride, (extent, stride)
    gids = gid0 + np.arange(n_buckets, dtype=np.int64)
    bases = base + np.arange(n_buckets, dtype=np.int64) * stride
    extents = np.full(n_buckets, ext, np.int64)
    return bases, extents, gids


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


# ------------------------------------------------- replicated placement ---
def _rank_in_group_np(group_id: np.ndarray, n_groups: int,
                      valid: np.ndarray) -> np.ndarray:
    """:func:`rank_in_group` on numpy arrays (the placement tables are
    built on the host): a stable sort, each row's sorted position minus
    the start of its run."""
    n = group_id.size
    gid = np.where(valid, group_id, n_groups).astype(np.int64)
    order = np.argsort(gid, kind="stable")
    sg = gid[order]
    is_start = np.empty(n, bool)
    if n:
        is_start[0] = True
        np.not_equal(sg[1:], sg[:-1], out=is_start[1:])
    run = np.cumsum(is_start) - 1
    start = np.flatnonzero(is_start)
    rank_sorted = np.arange(n, dtype=np.int64) - start[run] if n else start
    rank = np.empty(n, np.int32)
    rank[order] = rank_sorted.astype(np.int32)
    return rank


class Placement(NamedTuple):
    """Logical -> physical expert placement (replicated expert groups).

    Logical expert e owns ``n_replicas[e]`` physical slots; slot p computes
    logical expert ``phys_to_logical[p]`` and lives on rank ``p //
    (n_physical // n_ranks)``, the slot -> rank rule experts already
    follow, so every bucket sizes from the physical slot space.  Replica j
    of expert e is ``logical_to_phys[e, j]`` (ascending physical id; -1
    pads)."""

    phys_to_logical: np.ndarray   # (E_phys,) int32
    logical_to_phys: np.ndarray   # (E_log, max_replicas) int32, -1 pad
    n_replicas: np.ndarray        # (E_log,) int32, all >= 1

    @property
    def n_physical(self) -> int:
        return int(self.phys_to_logical.shape[0])

    @property
    def n_logical(self) -> int:
        return int(self.n_replicas.shape[0])

    @property
    def is_identity(self) -> bool:
        """True iff this is the single-placement layout (one slot an
        expert, in order), which takes the path without a placement."""
        return (self.n_physical == self.n_logical and bool(
            (self.phys_to_logical
             == np.arange(self.n_logical, dtype=np.int32)).all()))

    def key(self) -> tuple[int, ...]:
        """Hashable form (what a frozen EPSpec carries)."""
        return tuple(int(v) for v in self.phys_to_logical)


def placement_from_table(phys_to_logical) -> Placement:
    """A full Placement from its (E_phys,) phys -> logical table."""
    p2l = np.ascontiguousarray(np.asarray(phys_to_logical).reshape(-1),
                               np.int32)
    assert p2l.size and p2l.min() >= 0
    n_log = int(p2l.max()) + 1
    reps = np.bincount(p2l, minlength=n_log).astype(np.int32)
    assert (reps > 0).all(), "every logical expert needs >= 1 physical slot"
    # replica order within a logical expert: ascending physical id
    j = _rank_in_group_np(p2l, n_log, np.ones(p2l.size, bool))
    l2p = np.full((n_log, int(reps.max())), -1, np.int32)
    l2p[p2l, j] = np.arange(p2l.size, dtype=np.int32)
    return Placement(p2l, l2p, reps)


def identity_placement(n_experts: int) -> Placement:
    return placement_from_table(np.arange(n_experts, dtype=np.int32))


def replicate_uniform(n_logical: int, factor: int) -> Placement:
    """``factor`` replicas an expert: replica j of expert e at physical slot
    ``j * n_logical + e``, so that one expert's replicas land on distinct
    ranks whenever the slots a rank holds divide ``n_logical``."""
    return placement_from_table(
        np.tile(np.arange(n_logical, dtype=np.int32), factor))


def greedy_placement(loads, n_physical: int, n_ranks: int) -> Placement:
    """Greedy bin-packing placement from observed per-logical-expert loads
    (a numpy array or a tensor, read on the host).

    Two deterministic passes: (1) grant the ``n_physical - E_log`` extra
    replicas one at a time to the expert with the largest load a replica
    (ties: the lowest id); (2) pack the replicas onto ranks, the heaviest
    share first, each onto the least loaded rank with a free slot,
    preferring ranks that hold no replica of that expert yet.  Slot p lands
    on rank ``p // (n_physical // n_ranks)``."""
    if isinstance(loads, torch.Tensor):
        loads = loads.detach().cpu().numpy()
    loads = np.asarray(loads, np.float64).reshape(-1)
    E = loads.shape[0]
    assert n_physical >= E, (n_physical, E)
    assert n_physical % n_ranks == 0, (n_physical, n_ranks)
    eps = n_physical // n_ranks
    if not loads.any():
        loads = np.ones(E, np.float64)
    reps = np.ones(E, np.int64)
    for _ in range(n_physical - E):
        reps[int(np.argmax(loads / reps))] += 1
    items = sorted(((loads[e] / reps[e], e, j)
                    for e in range(E) for j in range(int(reps[e]))),
                   key=lambda it: (-it[0], it[1], it[2]))
    rank_load = np.zeros(n_ranks, np.float64)
    rank_free = np.full(n_ranks, eps, np.int64)
    rank_slots: list[list[int]] = [[] for _ in range(n_ranks)]
    for share, e, _j in items:
        best, best_key = -1, None
        for r in range(n_ranks):
            if not rank_free[r]:
                continue
            k = (e in rank_slots[r], rank_load[r], r)
            if best_key is None or k < best_key:
                best, best_key = r, k
        rank_slots[best].append(e)
        rank_load[best] += share
        rank_free[best] -= 1
    return placement_from_table(np.concatenate(
        [np.asarray(s, np.int32) for s in rank_slots]))


def _to_physical(placement: Placement, top_idx: Tensor, rank: Tensor,
                 valid: Tensor) -> Tensor:
    """Choice -> replica ``rank % n_replicas[e]`` of its expert e; pads
    (-1) pass through."""
    dev = top_idx.device
    e_safe = torch.where(valid, top_idx, 0).to(torch.int64)
    reps = torch.as_tensor(placement.n_replicas, device=dev).to(torch.int64)
    l2p = torch.as_tensor(placement.logical_to_phys, device=dev)
    phys = l2p[e_safe, rank.to(torch.int64) % reps[e_safe]]
    return torch.where(valid, phys.to(top_idx.dtype), top_idx)


def split_to_physical(placement: Placement, top_idx: Tensor) -> Tensor:
    """Deterministic replica split of a logical routing table: each valid
    choice of expert e goes to replica ``arrival_rank % n_replicas[e]``,
    round-robin in arrival order (:func:`rank_in_group`).  An identity
    placement returns ``top_idx`` itself."""
    if placement.is_identity:
        return top_idx
    flat = top_idx.reshape(-1)
    fv = flat >= 0
    rk = rank_in_group(flat, placement.n_logical, fv)
    return _to_physical(placement, flat, rk, fv).reshape(top_idx.shape)


def split_to_physical_world(placement: Placement, top_idx: Tensor) -> Tensor:
    """The (R, T, K) world table's split: every source rank round-robins
    its own choices, as stacking :func:`split_to_physical` per rank would,
    in one pass (expert ids offset per rank, as in
    :func:`make_world_plan`)."""
    if placement.is_identity:
        return top_idx
    R, E = top_idx.shape[0], placement.n_logical
    valid = top_idx >= 0
    r_of = torch.arange(R, device=top_idx.device).reshape(
        (R,) + (1,) * (top_idx.dim() - 1))
    gid = torch.where(valid, top_idx + r_of * E, -1)
    rk = rank_in_group(gid.reshape(-1), R * E,
                       valid.reshape(-1)).reshape(top_idx.shape)
    return _to_physical(placement, top_idx, rk, valid)


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
