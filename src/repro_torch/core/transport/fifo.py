"""CPU-GPU FIFO channel (paper §3.1), bit-faithful at host level.

A TransferCmd is a 128-bit descriptor (4 x uint32) — one GPU instruction /
MMIO doorbell per command in the real system.  The channel is a bounded
single-producer single-consumer ring: the producer ("GPU thread") writes at
the tail, the consumer ("CPU proxy thread") reads at the head.  The bound
``k_max_inflight`` is the paper's flow-control knob: a full ring
back-pressures the producer, pacing GPU-initiated communication.

The GPU side caches the head value (``_cached_head``) so polling for space
does not cross "PCIe" (here: does not touch the consumer-owned counter)
until the cache goes stale — the paper's tail/head-placement optimisation.

The port of ``repro.core.transport.fifo``: the same packed words, ring and
``pcie_reads`` accounting (the tests hold them to the reference).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from enum import IntEnum
from typing import NamedTuple, Optional

import numpy as np

from repro_torch.core.transport.wire_format import (CH_MASK, CH_SHIFT,
                                                    FLAG_FENCE, FLAGS_MASK,
                                                    FLAGS_SHIFT, LEN_MASK,
                                                    MASK32, OP_BITS, OP_MASK,
                                                    RANK_MASK, RANK_SHIFT,
                                                    VALUE_MASK, VALUE_SHIFT)

__all__ = ["Op", "FLAG_FENCE", "TransferCmd", "pack_cmds", "CmdColumns",
           "unpack_cmds", "FifoChannel"]


class Op(IntEnum):
    WRITE = 1          # one-sided RDMA write
    ATOMIC = 2         # standalone atomic (emulated via immediate data);
    #                    src_off carries the 32-bit operand (fence count /
    #                    chunk id), dst_off the wide guard/counter id
    DRAIN = 3          # drain CQ up to idx (scheduling hint)
    BARRIER = 4        # reserved opcode (no receiver-side state; the event
    #                    clock quiesce replaced the barrier round-trip)
    WRITE_ATOMIC = 5   # write with piggybacked atomic (completion counter)


@dataclass(frozen=True)
class TransferCmd:
    """Decoded descriptor.  Packs into exactly 128 bits."""

    op: Op
    dst_rank: int       # 12 bits
    channel: int        # 8 bits
    src_off: int        # 32 bits (symmetric-memory offset)
    dst_off: int        # 32 bits
    length: int         # 20 bits (bytes)
    value: int = 0      # 12 bits (free tag; transport semantics ride
    #                     src_off/dst_off — no expert slot on the wire)
    flags: int = 0      # 8 bits (FLAG_FENCE, ...)

    def pack(self) -> np.ndarray:
        w0 = (int(self.op) & OP_MASK) \
            | ((self.dst_rank & RANK_MASK) << RANK_SHIFT) \
            | ((self.channel & CH_MASK) << CH_SHIFT) \
            | ((self.flags & FLAGS_MASK) << FLAGS_SHIFT)
        w3 = (self.length & LEN_MASK) | ((self.value & VALUE_MASK)
                                         << VALUE_SHIFT)
        return np.array([w0, self.src_off & MASK32,
                         self.dst_off & MASK32, w3], dtype=np.uint32)

    @staticmethod
    def unpack(words: np.ndarray) -> "TransferCmd":
        w0, w1, w2, w3 = words.tolist()
        return TransferCmd(op=_OP_TABLE[w0 & OP_MASK],
                           dst_rank=(w0 >> RANK_SHIFT) & RANK_MASK,
                           channel=(w0 >> CH_SHIFT) & CH_MASK,
                           src_off=w1, dst_off=w2,
                           length=w3 & LEN_MASK,
                           value=(w3 >> VALUE_SHIFT) & VALUE_MASK,
                           flags=(w0 >> FLAGS_SHIFT) & FLAGS_MASK)


# tuple dispatch: Op.__call__ through EnumMeta is hot in the consumer loop
_OP_TABLE = tuple(Op(v) if v in Op._value2member_map_ else None
                  for v in range(1 << OP_BITS))


def pack_cmds(op, dst_rank, channel, src_off, dst_off, length, value,
              flags=0) -> np.ndarray:
    """Vectorized descriptor codec: pack N commands into an (N, 4) uint32
    array (the batched TransferCmd stream a GPU kernel would emit in one
    go).  Arguments broadcast against each other; scalars are fine.
    Row i unpacks (via :meth:`TransferCmd.unpack`) to exactly the same
    128-bit descriptor ``TransferCmd(...).pack()`` would produce.
    """
    op, dst_rank, channel, src_off, dst_off, length, value, flags = (
        np.broadcast_arrays(*[np.asarray(a, np.uint64) for a in
                              (op, dst_rank, channel, src_off, dst_off,
                               length, value, flags)]))
    n = op.size
    out = np.empty((n, 4), np.uint32)
    out[:, 0] = ((op.reshape(-1) & OP_MASK)
                 | ((dst_rank.reshape(-1) & RANK_MASK) << RANK_SHIFT)
                 | ((channel.reshape(-1) & CH_MASK) << CH_SHIFT)
                 | ((flags.reshape(-1) & FLAGS_MASK) << FLAGS_SHIFT)
                 ).astype(np.uint32)
    out[:, 1] = (src_off.reshape(-1) & MASK32).astype(np.uint32)
    out[:, 2] = (dst_off.reshape(-1) & MASK32).astype(np.uint32)
    out[:, 3] = ((length.reshape(-1) & LEN_MASK)
                 | ((value.reshape(-1) & VALUE_MASK) << VALUE_SHIFT)
                 ).astype(np.uint32)
    return out


class CmdColumns(NamedTuple):
    """Columnar view of a packed (N, 4) descriptor batch: one int64 array
    per field (the batched consumer's working set — no per-row TransferCmd
    objects on the hot path; :meth:`TransferCmd.unpack` stays the
    scalar/debug codec)."""

    op: np.ndarray
    dst_rank: np.ndarray
    channel: np.ndarray
    src_off: np.ndarray
    dst_off: np.ndarray
    length: np.ndarray
    value: np.ndarray
    flags: np.ndarray


def unpack_cmds(words: np.ndarray) -> CmdColumns:
    """Vectorized inverse of :func:`pack_cmds`: decode an (N, 4) uint32
    descriptor batch into field columns with bit-ops.  Column row i equals
    the fields ``TransferCmd.unpack(words[i])`` would produce."""
    w = words.astype(np.int64)
    w0, w3 = w[:, 0], w[:, 3]
    return CmdColumns(op=w0 & OP_MASK,
                      dst_rank=(w0 >> RANK_SHIFT) & RANK_MASK,
                      channel=(w0 >> CH_SHIFT) & CH_MASK, src_off=w[:, 1],
                      dst_off=w[:, 2], length=w3 & LEN_MASK,
                      value=(w3 >> VALUE_SHIFT) & VALUE_MASK,
                      flags=(w0 >> FLAGS_SHIFT) & FLAGS_MASK)


class FifoChannel:
    """Bounded SPSC ring of 128-bit TransferCmds.

    Counters are monotonically increasing; slot = counter % capacity.
    ``push`` returns a global index usable with ``check_completion``.
    """

    def __init__(self, k_max_inflight: int = 64):
        self.capacity = k_max_inflight
        self.buf = np.zeros((k_max_inflight, 4), dtype=np.uint32)
        self._tail = 0              # producer-owned (next write)
        self._head = 0              # consumer-owned (next read)
        self._cached_head = 0       # producer's stale copy (avoids "PCIe" read)
        self._pcie_reads = 0        # instrumentation: cross-domain reads
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self.closed = False

    # ----------------------------------------------------- producer (GPU) --
    def try_push(self, cmd: TransferCmd) -> Optional[int]:
        """Non-blocking push; None if the ring is full (flow control)."""
        if self._tail - self._cached_head >= self.capacity:
            with self._lock:
                self._cached_head = self._head      # one "PCIe" crossing
                self._pcie_reads += 1
            if self._tail - self._cached_head >= self.capacity:
                return None
        idx = self._tail
        self.buf[idx % self.capacity] = cmd.pack()
        with self._not_empty:
            self._tail = idx + 1
            self._not_empty.notify()
        return idx

    def try_push_batch(self, words: np.ndarray) -> int:
        """Bulk non-blocking push of packed (N, 4) uint32 descriptors.

        Copies as many rows as fit into the ring in one shot (one doorbell
        for the whole batch instead of one per command — the bulk half of
        the paper's Fig. 4 token-vs-bulk distinction).  Returns the number
        of rows consumed (0 if the ring is full).
        """
        n = len(words)
        if n == 0:
            return 0
        free = self.capacity - (self._tail - self._cached_head)
        if free < n:
            with self._lock:
                self._cached_head = self._head      # one "PCIe" crossing
                self._pcie_reads += 1
            free = self.capacity - (self._tail - self._cached_head)
        m = min(free, n)
        if m <= 0:
            return 0
        pos = (self._tail + np.arange(m)) % self.capacity
        self.buf[pos] = words[:m]
        with self._not_empty:
            self._tail += m
            self._not_empty.notify()
        return m

    def _wait_for_space(self, deadline: float) -> None:
        """Block until the ring has space or the absolute ``deadline``
        (time.monotonic seconds) passes.  One deadline covers a whole
        blocking push: a consumer that drains just slowly enough to keep
        waking the producer must NOT keep extending the timeout."""
        with self._not_full:
            remaining = deadline - time.monotonic()
            ok = remaining > 0 and self._not_full.wait_for(
                lambda: self._tail - self._head < self.capacity or self.closed,
                remaining)
            if not ok:
                raise TimeoutError("FIFO full: consumer stalled")
            if self.closed:
                raise RuntimeError("channel closed")
            self._cached_head = self._head

    def push_batch(self, words: np.ndarray, timeout: float = 10.0) -> int:
        """Blocking bulk push: waits for ring space until every row of
        ``words`` is queued, under ONE absolute deadline for the whole
        batch.  Returns the number of rows pushed (== N)."""
        deadline = time.monotonic() + timeout
        done = 0
        while done < len(words):
            done += self.try_push_batch(words[done:])
            if done < len(words):
                self._wait_for_space(deadline)
        return done

    def push(self, cmd: TransferCmd, timeout: float = 10.0) -> int:
        """Blocking push: waits for space (the paper's sender pacing) under
        one absolute deadline — an iterative retry loop, not recursion."""
        deadline = time.monotonic() + timeout
        while True:
            idx = self.try_push(cmd)
            if idx is not None:
                return idx
            self._wait_for_space(deadline)

    def check_completion(self, idx: int) -> bool:
        """Has the command at ``idx`` been popped by the CPU side?"""
        with self._lock:
            return self._head > idx

    def check_completion_batch(self, idxs) -> np.ndarray:
        """Batched :meth:`check_completion`: one locked head read answers
        for the whole index window (the flow-control wait loop polls its
        outstanding window in ONE lock round-trip, not one per index)."""
        with self._lock:
            head = self._head
        return np.asarray(idxs, np.int64) < head

    # ----------------------------------------------------- consumer (CPU) --
    def poll(self) -> Optional[tuple[int, TransferCmd]]:
        """Read (without consuming) the head command.  The row is copied
        while the lock is held: a wrapping producer may overwrite the slot
        the moment the head counter is published as free, so decoding from
        ``self.buf`` after release would race it."""
        with self._lock:
            if self._head >= self._tail:
                return None
            idx = self._head
            row = self.buf[idx % self.capacity].copy()
        return idx, TransferCmd.unpack(row)

    def pop(self) -> Optional[tuple[int, TransferCmd]]:
        with self._not_full:
            if self._head >= self._tail:
                return None
            idx = self._head
            cmd = TransferCmd.unpack(self.buf[idx % self.capacity])
            self._head = idx + 1
            self._not_full.notify()
        return idx, cmd

    def pop_all(self) -> Optional[np.ndarray]:
        """Bulk pop: consume every queued descriptor in one lock round trip
        (the inline-drain fast path).  Returns a packed (N, 4) copy."""
        with self._not_full:
            n = self._tail - self._head
            if n <= 0:
                return None
            # advanced indexing already materializes a fresh array
            words = self.buf[(self._head + np.arange(n)) % self.capacity]
            self._head += n
            self._not_full.notify()
        return words

    def wait_nonempty(self, timeout: float = 0.1) -> bool:
        with self._not_empty:
            return self._not_empty.wait_for(
                lambda: self._head < self._tail or self.closed, timeout)

    def close(self):
        with self._lock:
            self.closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._tail - self._head

    @property
    def pcie_reads(self) -> int:
        return self._pcie_reads
