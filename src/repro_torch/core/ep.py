"""UCCL-EP expert-parallel dispatch/combine over a rank-stacked world: the
port of ``repro.core.ep``.

Two modes, mirroring the paper (§3.3) and the JAX package:

- **LL (low latency)**: one-shot capacity-bucketed all-to-all per choice
  (token, expert); used for decode.
- **HT (high throughput)**: chunked dispatch with token deduplication and
  hierarchical reduce: a token routed to several experts of one
  destination group crosses that boundary once, and one combined vector
  returns per (token, group).

The rank-stacked world.  The JAX package runs these functions inside
``shard_map``, one program per EP shard.  Here the P ranks of the EP world
sit on a leading tensor axis of one device: every per-rank tensor is
``(R, ...)``.  A tiled ``all_to_all(split 0, concat 0)`` over an EP axis is
a transpose of the (source, destination) block axes (:func:`_all_to_all`),
and ``psum`` over the EP axes is a sum over the rank axis.  Ranks of a
two-level ``("pod", "model")`` world lay out row-major as ``(po, pi)``.
Rank r owns experts ``[r*eps, (r+1)*eps)``; the weights are one tensor and
are never copied per rank.  Plans run for all ranks in one pass (group ids
offset per rank), and each kernel launches once for all ranks: the token
tables of all ranks flatten into one ``(R*N + 1, D)`` table whose last row
is the shared zero scratch row every empty slot gathers.

Replicated expert placement (``EPSpec.placement``): each source rank's
logical choices are split over an expert's physical replicas
(``plan.split_to_physical_world``) before any bucketing, and every bucket
sizes from the physical slot count; the expert function's row blocks are
then physical slots, whose weights the caller gathers through
``phys_to_logical``.  An identity placement takes the path without one.

Per-rank statistics (``dropped``, ``occupancy``) come back as ``(R,)``
tensors; ``load_phys`` (the psum'd load of each physical slot) is one
``(n_physical,)`` tensor.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import plan as planlib
from repro_torch.core.transport.codec import WIRE_QDTYPE
from repro_torch.kernels import ops as kops

Tensor = torch.Tensor


@dataclass(frozen=True)
class EPSpec:
    """Static description of the expert-parallel layout."""

    axes: tuple[str, ...]        # EP axes, outer -> inner
    sizes: tuple[int, ...]       # sizes of those axes
    n_experts: int               # padded (logical, router-space) count
    top_k: int
    capacity_factor: float = 2.0
    chunks: int = 1              # HT pipeline chunks
    dtype: torch.dtype = torch.bfloat16
    mode: str = "ht"             # "ll" (decode) | "ht" (prefill)
    # dispatch payload wire dtype: "fp32" (tokens cross in ``dtype``) |
    # "fp8" | "int8" (block-quantized with per-128-feature fp32 scales,
    # dequantized to fp32 at the receiver); combines stay full precision
    wire_dtype: str = "fp32"
    # replicated expert placement: the phys -> logical slot table as a
    # tuple (``Placement.key()``), one entry a physical slot.  None, or the
    # identity table, keeps the single-placement layout bit for bit;
    # otherwise each logical expert's choices split over its replicas and
    # every bucket sizes from ``n_physical``
    placement: Optional[tuple[int, ...]] = None

    @property
    def degree(self) -> int:
        return math.prod(self.sizes)

    @property
    def experts_per_shard(self) -> int:
        assert self.n_experts % self.degree == 0
        return self.n_experts // self.degree

    @property
    def n_physical(self) -> int:
        """Physical expert slots (``n_experts`` without a placement)."""
        return (len(self.placement) if self.placement is not None
                else self.n_experts)

    @property
    def physical_per_shard(self) -> int:
        assert self.n_physical % self.degree == 0
        return self.n_physical // self.degree

    def placement_obj(self) -> Optional[planlib.Placement]:
        """The Placement, or None for no placement or the identity one
        (which take the same path)."""
        if self.placement is None:
            return None
        pl = planlib.placement_from_table(self.placement)
        return None if pl.is_identity else pl

    @property
    def two_level(self) -> bool:
        return len(self.axes) == 2

    def flat_axis(self):
        return self.axes if len(self.axes) > 1 else self.axes[0]


class DispatchResult(NamedTuple):
    out: Tensor         # (R, T, D) combined expert outputs
    aux: dict           # {"dropped": (R,), "occupancy": (R,), ...}


def _cap(n: float, cf: float, hard_max: int, multiple: int = 8) -> int:
    c = int(math.ceil(n * cf / multiple)) * multiple
    # floor of 32 slots: tiny per-shard token counts (decode) fluctuate a
    # lot relative to the mean; 32 rows cost ~nothing
    floor = min(hard_max, 32)
    return max(floor, min(c, hard_max))


# ============================================ rank-stacked collectives ====
def _all_to_all(spec: EPSpec, t: Tensor, axis) -> Tensor:
    """Tiled ``all_to_all(split 0, concat 0)`` over ``axis`` (one EP axis
    name, or the tuple of all of them) in the rank-stacked world.

    t: (R, G, ...): rank r's send buffer cut into G blocks, block j bound
    for the rank whose ``axis`` coordinate is j (all other coordinates
    equal).  Returns the (R, G, ...) receive buffers, block j coming from
    that rank — a transpose of the rank's ``axis`` coordinate with the
    block axis.
    """
    if isinstance(axis, tuple):                 # flattened: all EP axes
        return t.transpose(0, 1).contiguous()
    i = spec.axes.index(axis)
    n = len(spec.sizes)
    u = t.reshape(*spec.sizes, spec.sizes[i], *t.shape[2:])
    return u.transpose(i, n).reshape(t.shape)


def _shared_scratch_rows(src: Tensor, T: int) -> Tensor:
    """Per-rank row ids (R, n) in [0, T] (T = empty) -> rows of the
    flattened (R*T + 1)-row table, whose last row is the shared scratch."""
    R = src.shape[0]
    r_of = torch.arange(R, device=src.device)[:, None]
    return torch.where(src >= T, R * T, src + r_of * T)


def _ext(x: Tensor, dtype) -> Tensor:
    """(R, T, D) -> (R*T + 1, D) table in ``dtype`` with a zero last row."""
    D = x.shape[-1]
    flat = x.reshape(-1, D).to(dtype)
    return torch.cat([flat, flat.new_zeros((1, D))], dim=0)


# ================================================= wire-dtype dispatch ====
def _quantized_a2a(spec: EPSpec, x_ext_f32: Tensor, src_of_slot: Tensor,
                   counts: Optional[Tensor], axis, G: int) -> Tensor:
    """Dispatch payloads cross the wire block-quantized.

    One fused gather -> quantize launch for all ranks' slots
    (``src_of_slot`` (R*n,) rows of the shared table; ``counts`` (R*E,)
    occupied prefixes or None), the all-to-all of the quantized bytes and
    the fp32 scales, then one dequantize launch.  fp8 crosses as a ``uint8``
    view: the wire carries raw bytes.  Returns (R, n, D) fp32.
    """
    R = spec.degree
    D = x_ext_f32.shape[1]
    q, sc = kops.gather_quantize(x_ext_f32, src_of_slot, counts,
                                 wire_dtype=spec.wire_dtype)
    n = src_of_slot.shape[0] // R
    nb = sc.shape[1]
    qb = q.view(torch.uint8).reshape(R, G, n // G, D)
    qr = _all_to_all(spec, qb, axis)
    sr = _all_to_all(spec, sc.reshape(R, G, n // G, nb), axis)
    qw = qr.reshape(R * n, D).view(WIRE_QDTYPE[spec.wire_dtype])
    return kops.dequantize_tokens(qw, sr.reshape(R * n, nb)).reshape(R, n, D)


# =========================================================== LL mode ======
def dispatch_combine_ll(spec: EPSpec, x: Tensor, top_idx: Tensor,
                        top_w: Tensor, expert_fn: Callable) -> DispatchResult:
    """One-shot per-choice dispatch -> grouped expert FFN -> combine.

    x: (R, T, D); top_idx/top_w: (R, T, K).  expert_fn maps the stacked
    receive buffers of all ranks, (E, P*C, D) with expert e on rank
    e // eps, and their (E, P) per-source occupied counts to outputs of the
    same shape — one call (one kernel launch) for the whole world.  Under a
    replicated ``spec.placement`` E counts physical slots.
    """
    R, T, D = x.shape
    K = spec.top_k
    pl_obj = spec.placement_obj()
    if pl_obj is not None:
        top_idx = planlib.split_to_physical_world(pl_obj, top_idx)
    E, P, eps = spec.n_physical, spec.degree, spec.physical_per_shard
    if R != P:
        raise ValueError(f"{R} ranks stacked for an EP world of {P}")
    dev = x.device
    # hard_max is T*K, not T: a table may send a token to one expert twice
    C = _cap(T * K / E, spec.capacity_factor, hard_max=T * K)

    pl = planlib.make_world_plan(top_idx, E, C)
    flat_e = top_idx.reshape(R, T * K)
    rank, keep = pl.rank.reshape(R, T * K), pl.keep.reshape(R, T * K)
    valid = pl.valid.reshape(R, T * K)
    slot = planlib.flat_slots(flat_e, rank, keep, C, E).to(torch.int64)

    # index-indirection packing: scatter row ids, gather payloads once
    rows = (torch.arange(T * K, device=dev) // K).expand(R, T * K)
    src_of_slot = torch.full((R, E * C + 1), T, dtype=torch.int64,
                             device=dev).scatter_(1, slot, rows)[:, :-1]
    src = _shared_scratch_rows(src_of_slot, T)                  # (R, E*C)
    cnt = torch.clamp(pl.counts, max=C)                         # (R, E)
    if spec.wire_dtype == "fp32":
        send = _ext(x, spec.dtype)[src].reshape(R, P, eps * C, D)
        recv = _all_to_all(spec, send, spec.flat_axis())
    else:
        # quantize from the full-precision source, dequantize to fp32
        deq = _quantized_a2a(spec, _ext(x, torch.float32), src.reshape(-1),
                             cnt.reshape(-1), spec.flat_axis(), P)
        recv = deq.to(spec.dtype).reshape(R, P, eps * C, D)
    # (dest, src, eps, C, D) -> (dest, eps, src, C, D) = (E, P*C, D)
    recv = recv.reshape(R, P, eps, C, D).transpose(1, 2).reshape(E, P * C, D)

    # occupancy exchange: per-(dest expert) occupied counts ride along so
    # the expert kernel skips the capacity padding; layout (E, P sources)
    cnt_recv = _all_to_all(spec, cnt.reshape(R, P, eps), spec.flat_axis())
    out_e = planlib.call_expert_fn(
        expert_fn, recv, cnt_recv.transpose(1, 2).reshape(E, P))

    back = out_e.reshape(R, eps, P, C, D).transpose(1, 2).reshape(
        R, P, eps * C, D)
    back = _all_to_all(spec, back, spec.flat_axis()).reshape(R, E * C, D)

    # combine: each kept choice gathers its slot's row, weighted in fp32,
    # and a token sums its K choices in one fixed order (dropped choices
    # add 0).  No atomics: eager steps and a captured step's replays give
    # the same bits, where index_add_ on the card adds in any order
    w_flat = torch.where(keep, top_w.reshape(R, T * K).to(torch.float32), 0.0)
    sel = torch.where(keep, flat_e * C + rank, 0).to(torch.int64)
    contrib = torch.gather(back, 1, sel[..., None].expand(R, T * K, D))
    contrib = torch.where(keep[..., None],
                          contrib.to(torch.float32) * w_flat[..., None], 0.0)
    out = contrib.reshape(R, T, K, D).sum(2)

    dropped = pl.n_dropped / torch.clamp(valid.sum(1), min=1)
    occupancy = cnt.sum(1) / (E * C)
    load_phys = pl.counts.sum(0)                                 # psum
    return DispatchResult(out.to(x.dtype),
                          {"dropped": dropped, "occupancy": occupancy,
                           "load_phys": load_phys,
                           "imbalance": planlib.load_imbalance(load_phys)})


# =========================================================== HT mode ======
class _GroupPlan(NamedTuple):
    """Source-side bookkeeping of one dedup'd group dispatch (all ranks)."""

    send_eid: Tensor     # (R, G, C, K) expert ids local to the dest group
    send_w: Tensor       # (R, G, C, K) combine weights
    src_of_slot: Tensor  # (R, G*C) source row per slot in the shared
                         # (R*T + 1)-row table (R*T for empty slots): drives
                         # both payload packing and the combine scatter
    dropped: Tensor      # (R,) (token, group) entries lost to capacity


def _dedup_group_dispatch(eid: Tensor, w: Tensor, group_of: Tensor,
                          n_groups: int, C: int) -> _GroupPlan:
    """Deduplicate choices per (token, group); bucket entries by group.

    eid: (R, T, K) expert ids in the group's namespace (-1 pad); w: (R, T,
    K); group_of: (R, T, K) destination group per choice (-1 for pad).
    """
    R, T, K = eid.shape
    dev = eid.device
    valid = eid >= 0
    _, _, rank_tg, keep_tg, dropped = planlib.dedup_entry_table(
        group_of, valid, n_groups, C)
    g_ar = torch.arange(n_groups, device=dev)[None, None]
    slot_tg = planlib.flat_slots(g_ar, rank_tg, keep_tg, C, n_groups)
    t_rows = torch.arange(T, device=dev)[None, :, None].expand(R, T, n_groups)
    src_local = torch.full((R, n_groups * C + 1), T, dtype=torch.int64,
                           device=dev).scatter_(
        1, slot_tg.reshape(R, -1).to(torch.int64), t_rows.reshape(R, -1))
    src = _shared_scratch_rows(src_local[:, :-1], T)
    # metadata: the k-th choice rides on its (t, g) entry
    slot_choice = torch.where(valid, torch.gather(
        slot_tg, 2, torch.where(valid, group_of, 0).to(torch.int64)),
        n_groups * C).to(torch.int64)
    r_idx = torch.arange(R, device=dev)[:, None, None].expand(R, T, K)
    k_idx = torch.arange(K, device=dev)[None, None, :].expand(R, T, K)
    send_eid = torch.full((R, n_groups * C + 1, K), -1, dtype=torch.int32,
                          device=dev)
    send_eid[r_idx, slot_choice, k_idx] = torch.where(
        valid, eid, -1).to(torch.int32)
    send_w = torch.zeros((R, n_groups * C + 1, K), dtype=torch.float32,
                         device=dev)
    send_w[r_idx, slot_choice, k_idx] = torch.where(
        valid, w.to(torch.float32), 0.0)
    return _GroupPlan(send_eid[:, :-1].reshape(R, n_groups, C, K),
                      send_w[:, :-1].reshape(R, n_groups, C, K), src, dropped)


def _wire_dispatch_a2a(spec: EPSpec, x: Tensor, plan: _GroupPlan, axis,
                       G: int, C: int) -> Tensor:
    """Token-payload all-to-all of one dedup'd group dispatch, in the wire
    dtype; returns (R, G, C, D) in ``spec.dtype``.  Metadata (expert ids,
    combine weights) always crosses uncompressed."""
    R, T, D = x.shape
    if spec.wire_dtype == "fp32":
        send = _ext(x, spec.dtype)[plan.src_of_slot].reshape(R, G, C, D)
        return _all_to_all(spec, send, axis)
    rows = _quantized_a2a(spec, _ext(x, torch.float32),
                          plan.src_of_slot.reshape(-1), None, axis, G)
    return rows.to(spec.dtype).reshape(R, G, C, D)


def _expert_apply(spec: EPSpec, x_in: Tensor, eid: Tensor, w: Tensor,
                  expert_fn: Callable, cf: float, n_tokens_hint: int):
    """Final-level compute over entries (R, N, D), each with <= K local
    expert ids: bucket (entry, choice) pairs per local expert, apply
    ``expert_fn.fused`` (gather -> grouped FFN -> weighted scatter-add) or,
    for an ``expert_fn`` without ``fused``, gather an (R*eps, Ce, D) buffer,
    call ``expert_fn(buf, counts)`` with flat per-(rank, expert) counts and
    scatter-add the weighted outputs; return the weighted partial sum per
    entry (R, N, D) fp32 — the intra-node reduce — with per-rank drops and
    occupancy.

    Capacity is sized from the real expected load (``n_tokens_hint`` source
    tokens x K choices over the rank's experts), not from N.
    """
    R, N, D = x_in.shape
    K = eid.shape[2]
    eps = spec.physical_per_shard
    dev = x_in.device
    Ce = _cap(n_tokens_hint * K / eps, cf, hard_max=N * K)
    pl = planlib.make_world_plan(eid, eps, Ce)
    flat_e = eid.reshape(R, N * K)
    rank, keep = pl.rank.reshape(R, N * K), pl.keep.reshape(R, N * K)
    slot = planlib.flat_slots(flat_e, rank, keep, Ce, eps).to(torch.int64)
    rows = (torch.arange(N * K, device=dev) // K).expand(R, N * K)
    ent_local = torch.full((R, eps * Ce + 1), N, dtype=torch.int64,
                           device=dev).scatter_(1, slot, rows)[:, :-1]
    ent = _shared_scratch_rows(ent_local, N).reshape(-1)       # (E*Ce,)
    x_ext = _ext(x_in, spec.dtype)
    w_of_slot = torch.zeros((R, eps * Ce + 1), dtype=torch.float32,
                            device=dev).scatter_(
        1, slot, w.reshape(R, N * K).to(torch.float32))[:, :-1].reshape(-1)
    counts = torch.clamp(pl.counts, max=Ce)                    # (R, eps)
    occupancy = counts.sum(1) / (eps * Ce)
    fused = getattr(expert_fn, "fused", None)
    if fused is not None:
        # fused gather -> expert SwiGLU -> weighted fp32 scatter-add over
        # every rank's slots in one launch
        part = fused(x_ext, ent, w_of_slot, counts.reshape(-1))
    else:
        buf = x_ext[ent].reshape(R * eps, Ce, D)
        out_e = planlib.call_expert_fn(expert_fn, buf, counts.reshape(-1))
        # weighted scatter-add back per entry; slots of weight 0 (empty or
        # dropped) go to the scratch row
        tgt = torch.where(w_of_slot != 0, ent, R * N)
        part = torch.zeros((R * N + 1, D), dtype=torch.float32, device=dev)
        part.index_add_(0, tgt, out_e.reshape(-1, D).to(torch.float32)
                        * w_of_slot[:, None])
        part = part[:-1]
    return part.reshape(R, N, D), pl.n_dropped, occupancy


def _combine_scatter(plan: _GroupPlan, ret: Tensor, T: int) -> Tensor:
    """ret: (R, G, C, D) returned partials; add entries back per token.
    Empty slots carry zero partials and point at the scratch row."""
    R, G, C, D = ret.shape
    out = torch.zeros((R * T + 1, D), dtype=torch.float32, device=ret.device)
    out.index_add_(0, plan.src_of_slot.reshape(-1),
                   ret.reshape(-1, D).to(torch.float32))
    return out[:-1].reshape(R, T, D)


def dispatch_combine_ht(spec: EPSpec, x: Tensor, top_idx: Tensor,
                        top_w: Tensor, expert_fn: Callable) -> DispatchResult:
    """Chunked + dedup'd + hierarchical dispatch/combine (paper HT mode).
    x: (R, T, D); top_idx/top_w: (R, T, K)."""
    R, T, D = x.shape
    if R != spec.degree:
        raise ValueError(f"{R} ranks stacked for an EP world of {spec.degree}")
    pl_obj = spec.placement_obj()
    if pl_obj is not None:
        # one replica split for the whole table, not one a chunk
        top_idx = planlib.split_to_physical_world(pl_obj, top_idx)
    n_chunks = planlib.effective_chunks(T, spec.chunks)
    Tc = T // n_chunks
    outs, occs = [], []
    drops = torch.zeros(R, dtype=torch.int64, device=x.device)
    for c in range(n_chunks):
        sl = slice(c * Tc, (c + 1) * Tc)
        o, d, occ = _ht_one_chunk(spec, x[:, sl], top_idx[:, sl],
                                  top_w[:, sl], expert_fn)
        outs.append(o)
        occs.append(occ)
        drops = drops + d
    out = torch.cat(outs, dim=1) if n_chunks > 1 else outs[0]
    load_phys = planlib.group_counts(top_idx.reshape(-1), spec.n_physical,
                                     (top_idx >= 0).reshape(-1))
    return DispatchResult(out.to(x.dtype),
                          {"dropped": drops / max(T * spec.top_k, 1),
                           "occupancy": sum(occs) / n_chunks,
                           "chunks": n_chunks,
                           "load_phys": load_phys,
                           "imbalance": planlib.load_imbalance(load_phys)})


def _ht_one_chunk(spec: EPSpec, x: Tensor, top_idx: Tensor, top_w: Tensor,
                  expert_fn):
    # top_idx holds physical slots (dispatch_combine_ht split the replicas)
    R, T, D = x.shape
    K = spec.top_k
    E, eps = spec.n_physical, spec.physical_per_shard
    cf = spec.capacity_factor
    valid = top_idx >= 0

    if not spec.two_level:
        # one level: the groups are the EP ranks themselves
        P = spec.degree
        axis = spec.axes[0]
        group_of = torch.where(valid, top_idx // eps, -1)
        eid_local = torch.where(valid, top_idx % eps, -1)
        frac = 1.0 - (1.0 - 1.0 / P) ** K
        C = _cap(T * frac, cf, hard_max=T)
        plan = _dedup_group_dispatch(eid_local, top_w, group_of, P, C)
        rx = _wire_dispatch_a2a(spec, x, plan, axis, P, C)
        re = _all_to_all(spec, plan.send_eid, axis)
        rw = _all_to_all(spec, plan.send_w, axis)
        part, d2, occ = _expert_apply(spec, rx.reshape(R, P * C, D),
                                      re.reshape(R, P * C, K),
                                      rw.reshape(R, P * C, K),
                                      expert_fn, cf, n_tokens_hint=T)
        ret = _all_to_all(spec, part.reshape(R, P, C, D).to(spec.dtype), axis)
        out = _combine_scatter(plan, ret, T)
        return out, plan.dropped + d2, occ

    # ---- two levels: outer = pod (RDMA domain), inner = model (NVLink) ----
    ax_o, ax_i = spec.axes
    Po, Pi = spec.sizes
    e_per_pod = E // Po
    pod_of = torch.where(valid, top_idx // e_per_pod, -1)
    eid_in_pod = torch.where(valid, top_idx % e_per_pod, -1)
    frac_o = 1.0 - (1.0 - 1.0 / Po) ** K
    C1 = _cap(T * frac_o, cf, hard_max=T)
    plan1 = _dedup_group_dispatch(eid_in_pod, top_w, pod_of, Po, C1)
    # inter-pod all-to-all (same rail: inner index unchanged), tokens once
    rx = _wire_dispatch_a2a(spec, x, plan1, ax_o, Po, C1)
    re = _all_to_all(spec, plan1.send_eid, ax_o)
    rw = _all_to_all(spec, plan1.send_w, ax_o)
    N2 = Po * C1
    x2 = rx.reshape(R, N2, D)
    e2 = re.reshape(R, N2, K)                 # expert ids within my pod
    w2 = rw.reshape(R, N2, K)
    # intra-pod forwarding: group by inner rank
    v2 = e2 >= 0
    grp2 = torch.where(v2, e2 // eps, -1)
    eid2 = torch.where(v2, e2 % eps, -1)
    frac_i = 1.0 - (1.0 - 1.0 / Pi) ** K
    C2 = _cap(N2 * frac_i, cf, hard_max=N2)
    plan2 = _dedup_group_dispatch(eid2, w2, grp2, Pi, C2)
    rx2 = _wire_dispatch_a2a(spec, x2, plan2, ax_i, Pi, C2)
    re2 = _all_to_all(spec, plan2.send_eid, ax_i)
    rw2 = _all_to_all(spec, plan2.send_w, ax_i)
    part, d3, occ = _expert_apply(spec, rx2.reshape(R, Pi * C2, D),
                                  re2.reshape(R, Pi * C2, K),
                                  rw2.reshape(R, Pi * C2, K),
                                  expert_fn, cf, n_tokens_hint=T)
    # hierarchical combine A: partials return intra-pod, reduce per (t, pod)
    ret2 = _all_to_all(spec, part.reshape(R, Pi, C2, D).to(spec.dtype), ax_i)
    red2 = _combine_scatter(plan2, ret2, N2)
    # hierarchical combine B: one vector per (token, pod) crosses pods back
    ret1 = _all_to_all(spec, red2.reshape(R, Po, C1, D).to(spec.dtype), ax_o)
    out = _combine_scatter(plan1, ret1, T)
    return out, plan1.dropped + plan2.dropped + d3, occ


# ====================================================== reference oracle ==
def moe_ref(x: Tensor, top_idx: Tensor, top_w: Tensor, w_gate: Tensor,
            w_up: Tensor, w_down: Tensor) -> Tensor:
    """Dense per-token MoE oracle: no parallelism, no capacity drops.
    x: (T, D); top_idx/top_w: (T, K); w_*: (E, D, F) / (E, F, D)."""
    f32 = torch.float32
    E = w_gate.shape[0]
    # one-hot rows of -1 pads are zero (as jax.nn.one_hot gives)
    oh = (top_idx.to(torch.int64)[..., None]
          == torch.arange(E, device=top_idx.device)).to(f32)
    w_e = torch.einsum("tke,tk->te", oh, top_w.to(f32))
    xf = x.to(f32)
    g = torch.einsum("td,edf->tef", xf, w_gate.to(f32))
    u = torch.einsum("td,edf->tef", xf, w_up.to(f32))
    y = torch.einsum("tef,efd->ted", torch.nn.functional.silu(g) * u,
                     w_down.to(f32))
    return torch.einsum("ted,te->td", y, w_e).to(x.dtype)
