"""Network model: event-driven time, reliable transports, configurable order.

- "rc":  reliable, per-QP in-order delivery (ConnectX RC).
- "srd": reliable, UNORDERED delivery (AWS EFA SRD): any in-flight message
  may be delivered next (bounded by a reorder window for realism).

The network is a heap-ordered event queue (DESIGN.md §10): ``send`` computes
an arrival timestamp and schedules the message; ``step``/``run_until``
deliver events in timestamp order, advancing ``clock_us``.  Consumers (the
EP executor) interleave delivery with work — expert FFNs launch for a
receive bucket the moment its completion fence applies, while other buckets'
writes are still in flight.

Latency accounting (honest units, no per-message fudge factor):

- each (src, dst) link serialises: a message starts transmitting when the
  link frees, takes ``(size + hdr_bytes + (n_writes - 1) * sub_hdr_bytes) /
  bw_bytes_per_us`` on the wire (``hdr_bytes`` models per-message
  header/immediate overhead, so zero-byte atomics still occupy a wire slot;
  each *additional* sub-write a coalesced message carries charges
  ``sub_hdr_bytes`` for its ``imm_vec``/``sub_off`` entry — coalescing
  amortizes the message header, not the per-write metadata),
- propagation adds ``base_latency_us`` once per message (NOT accumulated
  across messages — links are parallel),
- srd adds a seeded jitter of up to ``reorder_window`` own-size wire slots,
  so a message can be overtaken by at most ~``reorder_window`` later
  messages of its size class (the same bounded-displacement semantics the
  bounded shuffle gives, in the time domain).

Delivery is deterministic under a seed.  The port of
``repro.core.transport.simulator``: the same seeded draws give the same
clock.
"""
from __future__ import annotations

import heapq
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from repro_torch.core.transport.wire_format import (SRD_DISPLACEMENT_BOUND,
                                                    ProtocolError)


@dataclass(slots=True)
class Message:
    src: int
    dst: int
    qp: int
    kind: str            # "write" | "imm" (atomic-as-immediate)
    dst_off: int
    payload: Optional[np.ndarray]
    imm: Optional[int]
    inject_t: float = 0.0
    deliver_t: float = 0.0
    size: int = 0
    # coalesced RDMA write (proxy write coalescing): one wire message
    # carrying N contiguous sub-writes.  ``imm_vec`` holds each sub-write's
    # 32-bit immediate (srd ordering emulation still sees one immediate per
    # fenced write), ``sub_off`` each sub-write's landing offset — the
    # receiver unrolls both against its guard table in one vectorized pass.
    imm_vec: Optional[np.ndarray] = None
    sub_off: Optional[np.ndarray] = None

    @property
    def n_writes(self) -> int:
        """Sub-writes this wire message carries (1 unless coalesced)."""
        return 1 if self.imm_vec is None else len(self.imm_vec)


class Timer:
    """A scheduled callback on the event clock (no wire footprint).

    Timers share the delivery heap with messages: ``step``/``deliver_ready``
    pop them in timestamp order, advance ``clock_us``, and invoke ``fn`` —
    with no receiver dispatch, no byte accounting, and no delivery hook.
    The EP step pipeline uses them to model serial *compute* segments
    (non-MoE forward/backward time) between communication events: a timer
    models "this rank's compute finishes at t", and its callback enqueues
    the next layer's commands — comm scheduled earlier keeps draining on
    the same clock underneath (comm/compute overlap, DESIGN.md §16)."""

    __slots__ = ("fn", "deliver_t")

    def __init__(self, fn: Callable[[], None], deliver_t: float = 0.0):
        self.fn = fn
        self.deliver_t = deliver_t


@dataclass
class NetConfig:
    mode: str = "srd"            # "rc" | "srd"
    reorder_window: int = 64     # srd: max messages a later one can overtake
    base_latency_us: float = 5.0
    bw_bytes_per_us: float = 25_000.0   # ~200 Gbit/s
    hdr_bytes: int = 64          # per-message wire overhead (header + imm)
    # per-sub-write metadata a coalesced message carries for each sub-write
    # beyond the first: its 4B immediate + 8B landing offset + 4B length.
    # The first sub-write's metadata rides in hdr_bytes (same as an
    # uncoalesced write), so coalescing N writes costs
    # hdr_bytes + (N-1)*sub_hdr_bytes, never less than one write's header.
    sub_hdr_bytes: int = 16
    seed: int = 0


class Network:
    """Central message switch with an event-driven clock.

    ``send`` schedules delivery at ``inject_t + serialization + latency``
    (+ bounded srd jitter); ``step`` delivers the earliest scheduled message
    to its registered receiver; ``run_until``/``flush`` drain in timestamp
    order.  Thread-safe: proxies may ``send`` from worker threads while one
    pump thread steps.
    """

    def __init__(self, cfg: NetConfig, n_ranks: int, threadsafe: bool = True):
        # seq unwrap at the receiver (semantics.ControlBuffer) tolerates
        # displacement < SEQ_MOD // 4 arrivals; the bound is derived from
        # the wire seq width, and raised (not assert-ed) so a mis-sized
        # window can't slip through under ``python -O``
        if cfg.reorder_window >= SRD_DISPLACEMENT_BOUND:
            raise ProtocolError(
                f"reorder_window {cfg.reorder_window} >= SEQ_MOD // 4 = "
                f"{SRD_DISPLACEMENT_BOUND}: receiver seq unwrap would be "
                "ambiguous")
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.n_ranks = n_ranks
        self.receivers: dict[int, Callable[[Message], None]] = {}
        self._heap: list[tuple[float, int, Message]] = []
        self._order = 0                       # FIFO tiebreak for equal times
        self._link_free: dict[tuple[int, int], float] = {}
        # lock elision for the (deterministic) single-threaded executor:
        # every send/step pays two lock ops otherwise
        self._lock = threading.Lock() if threadsafe else None
        self._srd = cfg.mode == "srd"
        self._jit = np.empty(0, np.int64)     # batched reorder-jitter draws
        self._jit_pos = 0                     # cursor into the draw buffer
        self.delivered = 0
        self.bytes_moved = 0
        self.hdr_bytes_moved = 0      # header + per-sub-write metadata bytes
        self.coalesced_msgs = 0       # delivered messages carrying >1 write
        self.coalesced_writes = 0     # sub-writes delivered inside those
        self.clock_us = 0.0
        self.on_deliver_hook: Optional[Callable[[Message], None]] = None

    def register(self, rank: int, on_deliver: Callable[[Message], None]):
        self.receivers[rank] = on_deliver

    # ------------------------------------------------------------- sending --
    def _jitter_batch(self, n: int) -> np.ndarray:
        """Next ``n`` seeded reorder draws, in draw order (a cursor into a
        replenished buffer — scalar and batched sends consume the identical
        stream, so a non-coalescing batched sender schedules bit-identically
        to a scalar one)."""
        end = self._jit_pos + n
        if end > len(self._jit):
            fresh = self.rng.integers(0, self.cfg.reorder_window + 1,
                                      size=max(4096, n))
            self._jit = np.concatenate([self._jit[self._jit_pos:], fresh])
            self._jit_pos, end = 0, n
        out = self._jit[self._jit_pos:end]
        self._jit_pos = end
        return out

    def _jitter(self) -> int:
        return int(self._jitter_batch(1)[0])

    def _schedule(self, msg: Message):
        msg.size = 0 if msg.payload is None else msg.payload.nbytes
        cfg = self.cfg
        meta = cfg.hdr_bytes + (msg.n_writes - 1) * cfg.sub_hdr_bytes
        tx = (msg.size + meta) / cfg.bw_bytes_per_us
        link = (msg.src, msg.dst)
        msg.inject_t = self.clock_us
        free = self._link_free.get(link, 0.0)
        start = free if free > msg.inject_t else msg.inject_t
        self._link_free[link] = start + tx
        arrival = start + tx + cfg.base_latency_us
        if self._srd:
            # jitter in units of this message's own wire slot: a message
            # can be overtaken by at most ~reorder_window later ones
            arrival += self._jitter() * tx
        msg.deliver_t = arrival
        self._order += 1
        heapq.heappush(self._heap, (arrival, self._order, msg))

    def send(self, msg: Message):
        if self._lock is None:
            self._schedule(msg)
        else:
            with self._lock:
                self._schedule(msg)

    def _schedule_batch(self, msgs: list) -> None:
        """Vectorized :meth:`_schedule` for a whole batch under one lock:
        per-link serialization via a grouped cumulative sum, one batched
        jitter draw, and a bulk heap extension (heapify beats N pushes once
        the batch stops being small relative to the heap)."""
        cfg = self.cfg
        n = len(msgs)
        if n < 8:          # vectorization overhead beats tiny batches
            for m in msgs:
                self._schedule(m)
            return
        clock = self.clock_us
        nr = self.n_ranks
        sz = [0] * n
        ky = [0] * n
        nw = [0] * n
        for i, m in enumerate(msgs):
            if m.payload is not None:
                sz[i] = m.payload.nbytes
            m.size = sz[i]
            m.inject_t = clock
            ky[i] = m.src * nr + m.dst
            nw[i] = m.n_writes
        sizes = np.asarray(sz, np.int64)
        key = np.asarray(ky, np.int64)
        meta = cfg.hdr_bytes + (np.asarray(nw, np.int64) - 1) \
            * cfg.sub_hdr_bytes
        tx = (sizes + meta) / cfg.bw_bytes_per_us
        order = np.argsort(key, kind="stable")
        ko, txo = key[order], tx[order]
        brk = np.empty(n, bool)
        brk[0] = True
        np.not_equal(ko[1:], ko[:-1], out=brk[1:])
        starts = np.flatnonzero(brk)
        reps = np.diff(np.append(starts, n))
        # per-link serialization: message i on a link starts when the
        # previous one finishes.  cumsum seeded with the link-free base is
        # the exact scalar recurrence (np.add.accumulate is sequential), so
        # batched scheduling is bit-identical to N _schedule calls.
        finish = np.empty(n)
        for j, s in enumerate(starts.tolist()):
            cnt = int(reps[j])
            m = msgs[int(order[s])]
            free = self._link_free.get((m.src, m.dst), 0.0)
            seg = txo[s:s + cnt].copy()
            seg[0] += free if free > self.clock_us else self.clock_us
            fin = np.cumsum(seg)
            finish[s:s + cnt] = fin
            self._link_free[(m.src, m.dst)] = float(fin[-1])
        arrival = np.empty(n)
        arrival[order] = finish + cfg.base_latency_us
        if self._srd:
            arrival += self._jitter_batch(n) * tx
        arr = arrival.tolist()          # one C conversion, not n boxings
        seq0 = self._order
        entries = [(arr[i], seq0 + 1 + i, m) for i, m in enumerate(msgs)]
        for i, m in enumerate(msgs):
            m.deliver_t = arr[i]
        self._order = seq0 + n
        heap = self._heap
        if n >= max(64, len(heap) // 4):
            heap.extend(entries)
            heapq.heapify(heap)
        else:
            for e in entries:
                heapq.heappush(heap, e)

    # ------------------------------------------------------------- timers --
    def call_at(self, t: float, fn: Callable[[], None]) -> None:
        """Schedule ``fn`` to run when the event clock reaches ``t`` (>= now).
        Fires in timestamp order interleaved with message deliveries."""
        tm = Timer(fn, max(float(t), self.clock_us))
        lock = self._lock
        if lock is not None:
            lock.acquire()
        try:
            self._order += 1
            heapq.heappush(self._heap, (tm.deliver_t, self._order, tm))
        finally:
            if lock is not None:
                lock.release()

    def advance(self, dt: float) -> None:
        """Advance the clock by ``dt`` us of serial host/compute time (the
        *un*-overlapped baseline: nothing is delivered meanwhile — in-flight
        messages keep their timestamps and deliver on the next pump)."""
        assert dt >= 0.0
        lock = self._lock
        if lock is not None:
            lock.acquire()
        try:
            self.clock_us += dt
        finally:
            if lock is not None:
                lock.release()

    def send_batch(self, msgs: list) -> None:
        """Schedule a whole batch of messages in one lock round-trip (the
        proxy's batched-RDMA issue path)."""
        if not msgs:
            return
        if self._lock is None:
            self._schedule_batch(msgs)
        else:
            with self._lock:
                self._schedule_batch(msgs)

    # ------------------------------------------------------------ delivery --
    @property
    def pending(self) -> int:
        # worker threads send() (heap push) concurrently in threadsafe mode;
        # readers must take the same lock (len() alone is atomic in CPython,
        # but the quiesce loop pairs this with next_event_t and must not see
        # a heap mid-mutation)
        if self._lock is None:
            return len(self._heap)
        with self._lock:
            return len(self._heap)

    def next_event_t(self) -> Optional[float]:
        if self._lock is None:
            return self._heap[0][0] if self._heap else None
        with self._lock:
            return self._heap[0][0] if self._heap else None

    def step(self) -> bool:
        """Deliver the earliest in-flight message (advances the clock).
        Returns False when nothing is in flight."""
        lock = self._lock
        if lock is not None:
            lock.acquire()
        try:
            heap = self._heap
            if not heap:
                return False
            t, _, m = heapq.heappop(heap)
            if t > self.clock_us:
                self.clock_us = t
            if isinstance(m, Message):
                self._account(m)
        finally:
            if lock is not None:
                lock.release()
        # deliver OUTSIDE the lock: receivers may trigger further sends
        if isinstance(m, Timer):
            m.fn()
            return True
        self.receivers[m.dst](m)
        if self.on_deliver_hook is not None:
            self.on_deliver_hook(m)
        return True

    def _account(self, m: Message) -> None:
        # caller holds the lock (threadsafe mode)
        cfg = self.cfg
        self.bytes_moved += m.size
        self.hdr_bytes_moved += cfg.hdr_bytes \
            + (m.n_writes - 1) * cfg.sub_hdr_bytes
        self.delivered += 1
        if m.imm_vec is not None and len(m.imm_vec) > 1:
            self.coalesced_msgs += 1
            self.coalesced_writes += len(m.imm_vec)

    @property
    def wire_bytes_moved(self) -> int:
        """Total bytes the serialization model charged: payload + headers +
        per-sub-write metadata — the honest on-the-wire figure."""
        return self.bytes_moved + self.hdr_bytes_moved

    def deliver_ready(self) -> int:
        """Deliver every event sharing the frontier timestamp in ONE lock
        round-trip (the batched half of :meth:`step`).  Returns the number
        of messages delivered (0 when nothing is in flight)."""
        lock = self._lock
        if lock is not None:
            lock.acquire()
        try:
            heap = self._heap
            if not heap:
                return 0
            t0 = heap[0][0]
            batch = []
            while heap and heap[0][0] == t0:
                batch.append(heapq.heappop(heap)[2])
            if t0 > self.clock_us:
                self.clock_us = t0
            for m in batch:
                if isinstance(m, Message):
                    self._account(m)
        finally:
            if lock is not None:
                lock.release()
        hook = self.on_deliver_hook
        for m in batch:         # deliver OUTSIDE the lock (receivers send)
            if isinstance(m, Timer):
                m.fn()
                continue
            self.receivers[m.dst](m)
            if hook is not None:
                hook(m)
        return len(batch)

    def run_until(self, t: float) -> int:
        """Deliver every message scheduled at or before ``t``."""
        n = 0
        while True:
            nxt = self.next_event_t()
            if nxt is None or nxt > t:
                return n
            self.step()
            n += 1

    def flush(self, steps: Optional[int] = None) -> int:
        """Deliver everything currently in flight (and anything scheduled by
        the deliveries themselves), in timestamp order.  ``steps`` bounds the
        number of deliveries (None = drain completely); returns how many
        messages were delivered."""
        n = 0
        while (steps is None or n < steps) and self.step():
            n += 1
        return n
