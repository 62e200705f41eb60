"""Elastic EP (paper §6, "Elastic EP with CPU proxy"): the port of
``repro.distributed.elastic``, both halves.

The mesh-restart half (:class:`ElasticPlan`, :func:`plan_remesh`,
:func:`reshard_state`).  A job that loses ranks restarts at a smaller EP
degree: (1) take the latest checkpoint, (2) re-derive the world
(``make_dist_ctx`` at the new size), (3) check that the new degree divides
the padded experts and the model axis ``d_model``, and (4) restore the
state under the new layout.  The reference re-shards its state onto a new
device mesh.  The port's state is logical: full tensors on one device,
the EP world only a layout of the compute (the P ranks of a rank-stacked
world share one copy of the weights).  So restoring into a fresh
``init_state`` is the whole of the data movement, and
:func:`reshard_state` checks every EP-split leaf against the new degree
(:func:`repro_torch.distributed.sharding.ep_split_leaves`) and moves
leaves only to a device it is given.

The expert-level half (online expert re-placement and weight migration
through the transport substrate; UltraEP arxiv 2606.04101 / UBEP
2607.06202, DESIGN.md §15).  A :class:`LoadBalancer` tracks
per-logical-expert token counts (the ``aux["load"]`` stat every backend
reports) over a sliding window and periodically recomputes a replicated
placement by greedy bin-packing; rank-degradation recovery reuses the
exact same placement-mutation code path (``degrade`` ->
``plan.greedy_placement`` -> :func:`migrate_expert_weights`), so a hot
expert and a dead rank are the same event from the transport's point of
view: a placement delta whose weight rows move through the substrate as
coalesced, fenced bulk writes.  Decisions, tables and statistics equal
the reference's on the same inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import plan as planlib
from repro_torch.core.backend import _load_imbalance
from repro_torch.core.transport.fifo import FLAG_FENCE, Op, pack_cmds
from repro_torch.core.transport.proxy import Proxy, SymmetricMemory
from repro_torch.core.transport.simulator import Network, NetConfig
from repro_torch.distributed.sharding import DistCtx, ep_split_leaves
from repro_torch.optim.adamw import tree_map


# ===================================================== mesh restart ==
@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """A validated re-mesh: the old and new worlds' ``sizes`` (the port's
    counterpart of a mesh's device shape), the new world's axes, the EP
    degrees and what changes per shard."""

    old_shape: tuple
    new_shape: tuple
    new_axis_names: tuple
    ep_degree_old: int
    ep_degree_new: int
    notes: list


def plan_remesh(cfg: ModelConfig, old: DistCtx, new: DistCtx) -> ElasticPlan:
    """Validate a re-mesh from world ``old`` to world ``new`` and describe
    what changes, with the reference's checks in its order and its error
    texts."""
    notes = []
    if cfg.moe.enabled:
        from repro_torch.core.moe import padded_experts_static
        e = padded_experts_static(cfg)
        if e % max(new.ep_degree, 1):
            raise ValueError(
                f"padded experts {e} not divisible by new EP degree "
                f"{new.ep_degree}; choose a mesh whose EP axes divide {e}")
        notes.append(f"experts/shard: {e // max(old.ep_degree, 1)} -> "
                     f"{e // max(new.ep_degree, 1)}")
    for name in new.axes:
        if name == "model" and cfg.d_model % new.axis_size(name):
            raise ValueError("d_model must divide the model axis")
    return ElasticPlan(
        old_shape=tuple(old.sizes), new_shape=tuple(new.sizes),
        new_axis_names=tuple(new.axes),
        ep_degree_old=old.ep_degree, ep_degree_new=new.ep_degree,
        notes=notes)


def reshard_state(cfg: ModelConfig, state, new: DistCtx, device=None):
    """The train ``state`` laid out for world ``new``: (state, new_dist).
    Checks that the new EP degree divides every EP-split leaf of the
    parameters and both moments (ValueError where it does not), and keeps
    ``opt.step``.  In a restart the leaves are already where they belong:
    ``restore_latest(init_state(cfg, device=...))`` places them, and no
    ``device`` is passed.  With ``device``, every tensor leaf but the step
    (which the optimizer keeps on the CPU) moves there, keeping its
    ``requires_grad``; a leaf already there, or every leaf without
    ``device``, is left as it is, not copied.  ``cfg`` keeps the
    reference's argument order: the layout follows from the tree and
    ``new``."""
    ep_split_leaves(new, state)
    if device is None:
        return state, new

    def move(x):
        y = x.to(device)
        return x if y is x else y.detach().requires_grad_(x.requires_grad)

    opt = state.opt._replace(mu=tree_map(move, state.opt.mu),
                             nu=tree_map(move, state.opt.nu))
    return state._replace(params=tree_map(move, state.params), opt=opt), new


# ============================================ expert-level elasticity ==


@dataclasses.dataclass
class LoadBalancer:
    """Sliding-window load tracker + greedy re-placement policy.

    ``observe()`` per EP round with the logical load vector; every
    ``interval`` observations ``maybe_replace()`` recomputes the placement
    when the window's physical-slot imbalance (max/mean, the shared
    ``aux["imbalance"]`` stat) exceeds ``threshold``.  ``degrade()`` is the
    rank-failure entry point onto the same code path.
    """

    n_logical: int
    n_ranks: int
    slots_per_rank: int
    window: int = 8            # sliding load window, in observations
    interval: int = 4          # re-placement cadence, in observations
    threshold: float = 1.25    # re-place only above this imbalance
    placement: Optional[planlib.Placement] = None
    _hist: list = dataclasses.field(default_factory=list)
    _steps: int = 0

    def __post_init__(self):
        assert self.n_physical >= self.n_logical
        if self.placement is None:
            self.placement = planlib.greedy_placement(
                np.ones(self.n_logical), self.n_physical, self.n_ranks)

    @property
    def n_physical(self) -> int:
        return self.slots_per_rank * self.n_ranks

    def observe(self, load) -> None:
        self._hist.append(np.asarray(load, np.float64).reshape(-1))
        if len(self._hist) > self.window:
            self._hist.pop(0)
        self._steps += 1

    def window_load(self) -> np.ndarray:
        if not self._hist:
            return np.ones(self.n_logical, np.float64)
        return np.sum(self._hist, axis=0)

    def imbalance(self) -> float:
        """Window imbalance under the CURRENT placement: each replica slot
        carries its expert's per-replica load share."""
        p = self.placement
        share = (self.window_load()[p.phys_to_logical]
                 / p.n_replicas[p.phys_to_logical])
        # the float64 max/mean of the numpy path: a float32 one could flip
        # ``<= threshold`` at a tie, and with it the re-placement decisions
        return _load_imbalance(share)

    def maybe_replace(self) -> Optional[planlib.Placement]:
        """Returns the new placement when one is due and different, else
        None (caller then migrates weights and re-splits routing)."""
        if self._steps % self.interval or self.imbalance() <= self.threshold:
            return None
        new = planlib.greedy_placement(self.window_load(), self.n_physical,
                                       self.n_ranks)
        if new.key() == self.placement.key():
            return None
        self.placement = new
        return new

    def degrade(self, dead_rank: int) -> planlib.Placement:
        """Rank loss: re-place every expert onto the survivors via the same
        greedy bin-packing as hot-expert re-placement.  The caller renumbers
        ranks (survivors keep relative order) and migrates weights; the slot
        budget grows to the next multiple that still fits every expert."""
        assert 0 <= dead_rank < self.n_ranks and self.n_ranks > 1
        self.n_ranks -= 1
        while self.n_physical < self.n_logical:
            self.slots_per_rank += 1
        self.placement = planlib.greedy_placement(
            self.window_load(), self.n_physical, self.n_ranks)
        return self.placement


@dataclasses.dataclass(frozen=True)
class MigrationStats:
    """What one placement migration actually moved, on the event clock."""

    wire_slots: int        # slots filled by cross-rank transfer
    local_slots: int       # slots filled by same-rank copy (no wire)
    restored_slots: int    # slots restored from checkpoint (no survivor)
    bytes_moved: int       # wire payload bytes
    clock_us: float        # event-clock time to quiesce
    msgs: int              # wire messages (post-coalescing)
    sub_writes: int        # chunk writes carried (pre-coalescing)


def migrate_expert_weights(old_holdings, new: planlib.Placement,
                           w_full: np.ndarray, *, net_cfg=None,
                           chunk_bytes: int = 4096, n_channels: int = 4,
                           ) -> tuple[np.ndarray, MigrationStats]:
    """Move expert weights into placement ``new`` through the transport
    substrate as coalesced bulk writes, fenced like any other guarded
    region (DESIGN.md §15 migration-fence protocol).

    ``old_holdings``: per rank of the NEW world (survivors renumbered, in
    order), the logical expert ids whose weight rows that rank currently
    holds.  ``w_full``: (E_log, Wb) uint8 — the logical weight rows (also
    the checkpoint reference for experts with no surviving holder, which
    the lowest rank restores and re-distributes).

    Every destination slot is one guarded region: its row is chunked into
    ``chunk_bytes`` WRITE commands forming a contiguous ascending run (what
    the proxy coalescer merges into single RDMA messages) followed by one
    FENCE_ATOMIC carrying the chunk count; the fence fires only when every
    chunk has applied at the receiver.  Same-rank moves are local copies.

    Returns ``(tables, stats)`` with ``tables[r, s]`` the Wb-byte row of
    physical slot ``r * slots_per_rank + s``.
    """

    R = len(old_holdings)
    assert new.n_physical % R == 0
    eps = new.n_physical // R
    E_log, Wb = w_full.shape
    w_full = np.ascontiguousarray(w_full, np.uint8)

    # source selection per destination slot: prefer a same-rank holder
    # (free local copy), else the lowest-rank survivor, else restore from
    # the checkpoint via the lowest rank (a fresh staging row there)
    holders: dict[int, list[tuple[int, int]]] = {}
    send_rows: list[list[int]] = []
    for r, es in enumerate(old_holdings):
        es = [int(e) for e in np.asarray(es, np.int64).reshape(-1)]
        send_rows.append(es)
        for i, e in enumerate(es):
            holders.setdefault(e, []).append((r, i))
    moves, restored = [], 0
    for p in range(new.n_physical):
        e = int(new.phys_to_logical[p])
        dr, dslot = divmod(p, eps)
        hs = holders.get(e)
        if hs:
            same = [row for r, row in hs if r == dr]
            src = (dr, same[0]) if same else hs[0]
        else:
            restored += 1
            send_rows[0].append(e)
            src = (0, len(send_rows[0]) - 1)
        moves.append((*src, dr, dslot))

    ns_max = max(len(rows) for rows in send_rows)
    send0, recv0 = 0, ns_max * Wb
    total = recv0 + eps * Wb
    net = Network(net_cfg or NetConfig(mode="srd", seed=0), R)
    mems = [SymmetricMemory.create(total, n_counters=eps) for _ in range(R)]
    proxies = [Proxy(r, net, mems[r], n_channels=n_channels)
               for r in range(R)]
    table = planlib.receive_bucket_table(eps, recv0, Wb)
    for p in proxies:
        p.register_table(*table)
    for r, rows in enumerate(send_rows):
        if rows:
            mems[r].data[send0:send0 + len(rows) * Wb] = \
                w_full[np.asarray(rows)].reshape(-1)

    n_chunks = -(-Wb // chunk_bytes)
    off = np.arange(n_chunks, dtype=np.int64) * chunk_bytes
    ln = np.minimum(chunk_bytes, Wb - off)
    stats = dict(wire=0, local=0, bytes=0, subw=0)

    def push(r, ch, words):
        done = 0
        while done < len(words):
            done += proxies[r].push_batch(ch, words[done:], block=False)
            if done < len(words):
                proxies[r].drain_inline()

    fence_slots: list[tuple[int, int]] = []
    for sr, srow, dr, dslot in moves:
        if sr == dr:                       # same-rank: free local copy
            b = send0 + srow * Wb
            mems[dr].data[recv0 + dslot * Wb:recv0 + (dslot + 1) * Wb] = \
                mems[dr].data[b:b + Wb]
            stats["local"] += 1
            continue
        ch = dslot % n_channels
        # contiguous ascending chunk run -> the coalescer's ideal input
        writes = pack_cmds(int(Op.WRITE), dr, ch, send0 + srow * Wb + off,
                           recv0 + dslot * Wb + off, ln, 0)
        push(sr, ch, writes)
        # one completion fence per guarded destination slot: applies only
        # after all n_chunks writes into the slot's registered range
        push(sr, ch, pack_cmds(int(Op.ATOMIC), dr, ch, n_chunks, dslot,
                               0, 0, FLAG_FENCE))
        fence_slots.append((dr, dslot))
        stats["wire"] += 1
        stats["bytes"] += Wb
        stats["subw"] += n_chunks

    msgs = 0

    def hook(msg):
        nonlocal msgs
        if msg.kind == "write":
            msgs += 1
    net.on_deliver_hook = hook
    for p in proxies:
        p.drain_inline()
    while net.deliver_ready():
        for p in proxies:
            p.drain_inline()
    net.on_deliver_hook = None
    # clean quiesce + every migration fence fired exactly once
    assert not net.pending and not any(p.busy for p in proxies)
    for dr, dslot in fence_slots:
        assert mems[dr].counters[dslot] == 1, (dr, dslot)

    tables = np.stack([mems[r].data[recv0:total].reshape(eps, Wb)
                       for r in range(R)])
    return tables, MigrationStats(
        wire_slots=stats["wire"], local_slots=stats["local"],
        restored_slots=restored, bytes_moved=stats["bytes"],
        clock_us=float(net.clock_us), msgs=msgs, sub_writes=stats["subw"])
