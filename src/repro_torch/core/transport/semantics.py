"""Delivery-semantics bridging (paper §3.3, §4.1): immediate-data codec,
registered guard ranges, and the receiver-side control buffer.

Heterogeneous NICs differ in ordering: ConnectX RC delivers in order, AWS
EFA SRD is reliable-but-unordered, and EFA lacks hardware atomics.  The
receiver CPU proxy therefore (a) tags every message with a 32-bit immediate,
(b) applies *writes* immediately, and (c) holds *atomics* in a control
buffer until their guard is satisfied:

- LL completion fence: an atomic guarding receive bucket ``g`` with required
  count ``X`` applies only once >= X writes have landed *inside bucket g's
  registered address range* (any order).
- HT partial ordering: an atomic with sequence ``s`` on channel ``c``
  applies only after all messages with smaller sequence on ``c`` applied —
  ordering is per-channel, never global.

Guard state is keyed by **registered address ranges**, not by wire-carried
slots: at world setup each rank registers its receive-bucket table
(base offset, extent, guard id) with its proxy — mirroring how real RDMA
resolves a landing address against a registered MR — and the receiver
resolves each write's ``dst_off`` to a guard id on delivery
(:class:`GuardTable`).  Writes outside any registered range (combine return
regions, HT entry buckets) satisfy no fence, which is why no reserved
"unfenced" wire slot exists anymore; and because guard ids are 32-bit
memory-table indices rather than a 6-bit immediate field, there is no limit
of 64 experts per rank (a 6-bit slot would alias expert ``e`` onto guard
``e % 64`` past that).

The 32-bit immediate layout is per-kind (DESIGN.md §12).  Sequence-carrying
kinds (WRITE, SEQ_ATOMIC, BARRIER) pack

    kind(2) | channel(3) | seq(11) | value(16)

while FENCE_ATOMIC — which does not participate in sequence ordering and
therefore needs no seq field — trades it for a wide count:

    kind(2) | channel(3) | count(21) | unused(6)

so LL fence guards cover receive buckets of up to 2M tokens.  The fence's
guard id rides the descriptor's 32-bit ``dst_off`` field (a zero-byte
transfer has no landing address to resolve), and the SEQ_ATOMIC operand
(HT chunk id) rides the 16-bit value field.  Wire sequences are modulo
``SEQ_MOD``; the receiver unwraps them against the highest sequence seen per
channel, which is safe while delivery displacement stays below
``SEQ_MOD // 4`` *sequences* (half the true unwrap window, margin for
mixed wire sizes).  Two senders together keep it there: the network model
bounds its reorder window below 512 arrivals, and the proxy's write
coalescer caps run length so ``(reorder_window + 1) * cap`` sequences
stay inside the same bound (``Proxy._coalesce_cap``).

The port of ``repro.core.transport.semantics``, field for field.
"""
from __future__ import annotations

import heapq
from bisect import bisect_left, bisect_right
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Callable, Optional

import numpy as np

from repro_torch.core.transport.wire_format import (FENCE_COUNT_MAX,
                                                    IMM_CH_MASK, IMM_CH_SHIFT,
                                                    IMM_COUNT_MASK,
                                                    IMM_COUNT_SHIFT,
                                                    IMM_KIND_MASK,
                                                    IMM_SEQ_MASK,
                                                    IMM_SEQ_SHIFT, IMM_VAL_MAX,
                                                    IMM_VALUE_SHIFT,
                                                    N_CHANNELS_MAX, SEQ_MOD,
                                                    ProtocolError)

__all__ = ["ImmKind", "N_CHANNELS_MAX", "SEQ_MOD", "IMM_VAL_MAX",
           "FENCE_COUNT_MAX", "ProtocolError", "pack_imm", "unpack_imm",
           "GuardTable", "ControlBuffer"]


class ImmKind(IntEnum):
    WRITE = 0          # data write notification
    FENCE_ATOMIC = 1   # LL: apply after `count` writes landed in the guarded
    #                    address range (guard id rides the descriptor dst_off)
    SEQ_ATOMIC = 2     # HT: apply in per-channel sequence order
    BARRIER = 3        # reserved (applies immediately)


# Field widths/masks/shifts and the derived protocol constants
# (N_CHANNELS_MAX, SEQ_MOD, IMM_VAL_MAX, FENCE_COUNT_MAX) live in
# ``wire_format`` — the single source of truth — and are re-exported here
# for existing import sites.


def pack_imm(kind: ImmKind, channel: int, seq: int, value: int) -> int:
    """32-bit immediate; layout is per-kind (see module docstring).  For
    FENCE_ATOMIC, ``seq`` must be 0 (fences carry no sequence number) and
    ``value`` is the required write count (up to :data:`FENCE_COUNT_MAX`);
    the guard id travels in the descriptor, not the immediate.

    Out-of-range fields raise :class:`ProtocolError` (never ``assert`` —
    truncating a field silently corrupts the wire under ``python -O``)."""
    if not 0 <= channel < N_CHANNELS_MAX:
        raise ProtocolError(f"imm channel {channel} not in "
                            f"[0, {N_CHANNELS_MAX})")
    if kind == ImmKind.FENCE_ATOMIC:
        if seq != 0 or not 0 <= value <= FENCE_COUNT_MAX:
            raise ProtocolError(f"fence imm seq={seq} count={value}: seq "
                                f"must be 0 and count <= {FENCE_COUNT_MAX}")
        return int(kind) | (channel << IMM_CH_SHIFT) \
            | (value << IMM_COUNT_SHIFT)
    if not 0 <= seq < SEQ_MOD or not 0 <= value <= IMM_VAL_MAX:
        raise ProtocolError(f"imm seq={seq} value={value}: need seq < "
                            f"{SEQ_MOD} and value <= {IMM_VAL_MAX}")
    return int(kind) | (channel << IMM_CH_SHIFT) | (seq << IMM_SEQ_SHIFT) \
        | (value << IMM_VALUE_SHIFT)


_IMM_KINDS = (ImmKind.WRITE, ImmKind.FENCE_ATOMIC, ImmKind.SEQ_ATOMIC,
              ImmKind.BARRIER)   # tuple dispatch: Enum.__call__ is hot


def unpack_imm(imm: int) -> tuple[ImmKind, int, int, int]:
    kind = _IMM_KINDS[imm & IMM_KIND_MASK]
    if kind is ImmKind.FENCE_ATOMIC:
        return (kind, (imm >> IMM_CH_SHIFT) & IMM_CH_MASK, 0,
                (imm >> IMM_COUNT_SHIFT) & IMM_COUNT_MASK)
    return (kind, (imm >> IMM_CH_SHIFT) & IMM_CH_MASK,
            (imm >> IMM_SEQ_SHIFT) & IMM_SEQ_MASK, imm >> IMM_VALUE_SHIFT)


class GuardTable:
    """Registered receive-bucket table for one rank's symmetric memory.

    Mirrors how a real NIC resolves a landing address against registered
    memory regions: each entry is a non-overlapping ``[base, base + extent)``
    byte range owning a wide integer ``guard_id``.  :meth:`resolve` maps a
    delivered write's destination offset to the guard of the bucket it fell
    in, or ``None`` for unregistered memory (e.g. combine return regions) —
    such writes apply but can never satisfy a completion fence.
    """

    __slots__ = ("_bases", "_ends", "_gids", "_np")

    def __init__(self):
        self._bases: list[int] = []
        self._ends: list[int] = []
        self._gids: list[int] = []
        self._np = None              # cached array form for resolve_batch

    def __len__(self) -> int:
        return len(self._bases)

    def register(self, base: int, extent: int, guard_id: int) -> None:
        """Register one bucket.  Ranges must not overlap (a landing address
        must resolve to exactly one guard, as with real MRs)."""
        base, extent = int(base), int(extent)
        if extent <= 0:
            raise ProtocolError(f"guard range extent must be > 0, got "
                                f"{extent}")
        i = bisect_left(self._bases, base)
        if not ((i == 0 or self._ends[i - 1] <= base) and
                (i == len(self._bases) or base + extent <= self._bases[i])):
            raise ProtocolError(f"guard range [{base}, {base + extent}) "
                                "overlaps a registered one")
        self._bases.insert(i, base)
        self._ends.insert(i, base + extent)
        self._gids.insert(i, int(guard_id))
        self._np = None

    def register_table(self, bases, extents, guard_ids) -> None:
        """Bulk registration of a bucket table; arguments broadcast."""
        bases, extents, guard_ids = np.broadcast_arrays(
            np.asarray(bases), np.asarray(extents), np.asarray(guard_ids))
        for b, x, g in zip(bases.reshape(-1).tolist(),
                           extents.reshape(-1).tolist(),
                           guard_ids.reshape(-1).tolist()):
            self.register(b, x, g)

    def resolve(self, off: int) -> Optional[int]:
        """Guard id of the registered range containing ``off``, else None."""
        i = bisect_right(self._bases, off) - 1
        if i >= 0 and off < self._ends[i]:
            return self._gids[i]
        return None

    def resolve_batch(self, offs) -> np.ndarray:
        """Vectorized :meth:`resolve`: (N,) offsets -> (N,) int64 guard ids,
        -1 where the offset lands in unregistered memory.  One searchsorted
        over the (cached) sorted range table for the whole batch."""
        offs = np.asarray(offs, np.int64)
        if not self._bases:
            return np.full(offs.shape, -1, np.int64)
        if self._np is None:
            self._np = (np.asarray(self._bases, np.int64),
                        np.asarray(self._ends, np.int64),
                        np.asarray(self._gids, np.int64))
        bases, ends, gids = self._np
        i = np.searchsorted(bases, offs, side="right") - 1
        j = np.maximum(i, 0)
        ok = (i >= 0) & (offs < ends[j])
        return np.where(ok, gids[j], -1)


def _noop() -> None:
    """Stand-in apply for batch unrolling: a coalesced run's payload is
    landed by the receiver in one contiguous copy before the semantics
    bookkeeping runs, so the per-write apply has nothing left to do."""


@dataclass(order=True)
class _Held:
    seq: int
    imm: int = field(compare=False)
    apply: Callable[[], None] = field(compare=False)


class ControlBuffer:
    """Receiver-side guard state for one peer connection.

    ``writes_seen[guard_id]`` counts landed writes per registered receive
    bucket (LL fence) — writes are attributed to guards by resolving their
    landing offset against the shared :class:`GuardTable`, never by a
    wire-carried slot; ``next_seq[channel]`` tracks the next expected
    (unwrapped) sequence (HT order).  Held seq atomics live in per-channel
    min-heaps keyed by sequence; held fences live in per-guard lists.
    """

    def __init__(self, guards: Optional[GuardTable] = None,
                 n_channels: int = N_CHANNELS_MAX):
        self.guards = guards
        self.writes_seen: dict[int, int] = {}
        self.next_seq = [0] * n_channels
        self._hi_seq = [0] * n_channels        # unwrap anchor per channel
        # per-channel min-heaps of [start, end) arrived-sequence intervals:
        # a coalesced run buffers as ONE interval, not n entries, so the
        # heap stays O(messages) rather than O(sequences)
        self._arrived: dict[int, list[tuple[int, int]]] = {}
        self.held_seq: dict[int, list[_Held]] = {}
        # guard id -> [(required count, imm, apply)]
        self.held_fence: dict[int, list[tuple[int, int, Callable]]] = {}
        self.applied_log: list[int] = []     # imm values, in application order
        self._held = 0                       # incremental count (hot path)
        self.held_peak = 0

    # ------------------------------------------------------------ events --
    def on_write(self, imm: int, apply: Callable[[], None],
                 dst_off: int = 0) -> None:
        """A data write landed at ``dst_off`` (RDMA writes apply
        immediately); the landing offset resolves to the guard it feeds."""
        kind, ch, seq, value = unpack_imm(imm)
        assert kind == ImmKind.WRITE
        apply()
        gid = self.guards.resolve(dst_off) if self.guards is not None else None
        if gid is not None:
            self.writes_seen[gid] = self.writes_seen.get(gid, 0) + 1
        self._bump_seq(ch, self._unwrap(ch, seq))
        self.applied_log.append(imm)
        if self._held:          # guard the (common) nothing-held fast path
            if gid is not None:
                self._drain_fences(gid)
            self._drain(ch)

    def on_write_batch(self, imms: np.ndarray, dst_offs: np.ndarray) -> None:
        """Batched :meth:`on_write` for a coalesced delivery.  The payload
        is already in place (the caller lands a coalesced run with ONE
        contiguous copy); this attributes every sub-write to its guard with
        one ``searchsorted`` over the registered range table and advances
        the channel's sequence prefix in bulk.

        The vectorized path requires that no held guarded atomic can fire
        mid-run — a held fence on one of the run's own guards, or a held
        seq atomic on the run's channel.  Those cases (out-of-order srd
        stragglers racing their guard) unroll through the scalar
        :meth:`on_write`, which stays the semantics oracle (identical
        apply ordering); held atomics on unrelated guards/channels can't
        observe the run and don't force the fallback."""
        imms = np.asarray(imms, np.uint32)
        n = len(imms)
        if n == 0:
            return
        ch = (int(imms[0]) >> IMM_CH_SHIFT) & IMM_CH_MASK
        dst_offs = np.asarray(dst_offs)
        # guard attribution: a proxy-coalesced run lands in one ascending
        # contiguous interval, so when its offsets are monotone and the
        # first and last resolve to the same bucket, the whole run is
        # inside it (registered ranges are intervals) — two bisect probes
        # plus one comparison, no searchsorted.  Anything else (the API
        # accepts arbitrary offset batches) takes the vectorized resolve.
        uniq = cnt = None
        if self.guards is not None:
            g0 = self.guards.resolve(int(dst_offs[0]))
            if g0 is not None and \
                    self.guards.resolve(int(dst_offs[-1])) == g0 and \
                    bool((dst_offs[1:] >= dst_offs[:-1]).all()):
                uniq, cnt = [g0], [n]
            else:
                gids = self.guards.resolve_batch(dst_offs)
                reg = gids[gids >= 0]
                if len(reg):
                    u, c = np.unique(reg, return_counts=True)
                    uniq, cnt = u.tolist(), c.tolist()
        hf = self.held_fence
        if self.held_seq.get(ch) or (
                hf and uniq is not None and any(g in hf for g in uniq)):
            for i in range(n):                 # scalar oracle path
                self.on_write(int(imms[i]), _noop, int(dst_offs[i]))
            return
        if uniq is not None:
            seen = self.writes_seen
            for g, c in zip(uniq, cnt):
                seen[g] = seen.get(g, 0) + c
        # the sender assigns a coalesced run consecutive sequences
        # [full0, full0 + n), so the prefix state advances in bulk
        full0 = self._unwrap(ch, (int(imms[0]) >> IMM_SEQ_SHIFT)
                             & IMM_SEQ_MASK)
        if full0 + n - 1 > self._hi_seq[ch]:
            self._hi_seq[ch] = full0 + n - 1
        if full0 == self.next_seq[ch]:
            # in-order run: extends the contiguous prefix at once (no held
            # seq atomic on this channel — checked above — so closing more
            # of the prefix releases nothing)
            self.next_seq[ch] = full0 + n
            h = self._arrived.get(ch)
            while h and h[0][0] == self.next_seq[ch]:
                self.next_seq[ch] = heapq.heappop(h)[1]
        else:
            # out-of-order srd straggler-side run: buffer the whole run as
            # ONE [start, end) interval (nothing can pop yet — the prefix
            # below full0 is still open)
            self._bump_seq(ch, full0, full0 + n)
        self.applied_log.extend(imms.tolist())

    def on_atomic(self, imm: int, apply: Callable[[], None],
                  guard: Optional[int] = None) -> None:
        """An atomic-as-immediate landed.  For FENCE_ATOMIC, ``guard`` is
        the wide guard id the descriptor's ``dst_off`` addressed."""
        kind, ch, seq, value = unpack_imm(imm)
        if kind is ImmKind.FENCE_ATOMIC:
            if self.writes_seen.get(guard, 0) >= value:
                apply()
                self.applied_log.append(imm)
            else:
                self.held_fence.setdefault(guard, []).append(
                    (value, imm, apply))
                self._held += 1
                if self._held > self.held_peak:
                    self.held_peak = self._held
        elif kind is ImmKind.SEQ_ATOMIC:
            full = self._unwrap(ch, seq)
            if self.next_seq[ch] >= full:
                apply()
                self.applied_log.append(imm)
                self._bump_seq(ch, full)
                self._drain(ch)
            else:
                heapq.heappush(self.held_seq.setdefault(ch, []),
                               _Held(full, imm, apply))
                self._held += 1
                if self._held > self.held_peak:
                    self.held_peak = self._held
        else:
            apply()
            self.applied_log.append(imm)

    # ----------------------------------------------------------- helpers --
    def _unwrap(self, ch: int, wire_seq: int) -> int:
        """Reconstruct the full sequence from its SEQ_MOD-wrapped wire form,
        nearest to the highest sequence seen on this channel.  Correct while
        delivery displacement < SEQ_MOD // 4 arrivals (network guarantee)."""
        hi = self._hi_seq[ch]
        diff = ((wire_seq - hi + SEQ_MOD // 2) % SEQ_MOD) - SEQ_MOD // 2
        full = hi + diff
        assert full >= 0, (ch, wire_seq, hi)
        if full > hi:
            self._hi_seq[ch] = full
        return full

    def _bump_seq(self, ch: int, seq: int, end: Optional[int] = None) -> None:
        # sequences are assigned consecutively per channel by the sender;
        # next_seq advances over the contiguous prefix of *applied* seqs
        # (writes may land out of order and apply immediately, so arrivals
        # are buffered — as [start, end) intervals — until the prefix
        # closes).
        heapq.heappush(self._arrived.setdefault(ch, []),
                       (seq, seq + 1 if end is None else end))
        h = self._arrived[ch]
        while h and h[0][0] == self.next_seq[ch]:
            self.next_seq[ch] = heapq.heappop(h)[1]

    def _drain(self, ch: int) -> None:
        heap = self.held_seq.get(ch)
        while heap and heap[0].seq <= self.next_seq[ch]:
            h = heapq.heappop(heap)
            h.apply()
            self._held -= 1
            self.applied_log.append(h.imm)
            self._bump_seq(ch, h.seq)

    def _drain_fences(self, gid: int) -> None:
        held = self.held_fence.get(gid)
        if not held:
            return
        seen = self.writes_seen.get(gid, 0)
        still = []
        for value, imm, apply in held:
            if seen >= value:
                apply()
                self._held -= 1
                self.applied_log.append(imm)
            else:
                still.append((value, imm, apply))
        if still:
            self.held_fence[gid] = still
        else:
            del self.held_fence[gid]

    @property
    def n_held(self) -> int:
        return self._held
