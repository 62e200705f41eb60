"""Spans, counters and gauges inside the port, kept in memory while no
profiler runs.

    from repro_torch import tracing

    with tracing.span("train.forward"):
        loss = ...
    tracing.count("requests")
    tracing.gauge("serve.graph_nodes", 4903)
    json.dumps(tracing.snapshot())

A span records, when its ``with`` body returns (nothing when it raises):

- its path, the names of the spans open around it and its own, joined by
  ``/`` (``train.step/train.backward/ep.plan``).  A thread with no span of
  its own open nests under the span the process last opened: autograd's
  worker thread, which runs the backward (and a layer's recompute) while
  the caller waits in ``loss.backward()``, nests under ``train.backward``;
- its host time (``time.perf_counter_ns``);
- where CUDA is initialised, its device interval: a pair of timing events
  recorded on the current stream at entry and exit, so the stream time the
  span's work occupied, waits inside it included.  A pair costs tens of
  microseconds of host time on an H100 host (the current stream, two
  records, a query and the elapsed time), so the device is timed on one in
  ``SAMPLE`` occurrences of each outermost path, the ``SAMPLE``-th, the
  ``2 SAMPLE``-th, ..., and on every span nested in those: the spans of a
  sampled step share their steps, so a ratio of device totals compares
  like with like, and no first call's one-time costs (library
  initialisation, the allocator's growth) stand in a device interval.
  The pairs come from a pool and are resolved lazily, without blocking,
  by ``query()`` at the entry of each outermost span; at most
  ``MAX_PENDING`` wait at once (past that a span goes without, counted in
  ``tracing.pairs_dropped``), and :func:`snapshot` synchronises once and
  resolves the rest;
- its bucket: ``profiled`` where ``torch.profiler`` was recording while
  it was open, ``after_profiler`` where none was but a span has seen one
  since the last :func:`reset` (a process the profiler has run in issues
  its launches slower from then on: a decode graph's launch took 1.9 ms
  there against 0.15 ms before, on an H100), else ``unprofiled``, which so
  stays clean.  Under a profiler a span also opens a named range on the
  profiler's host timeline, on the clock its device activities share
  (``torch._C._profiler._RecordFunctionFast``: the range of
  ``torch.profiler.record_function`` is a user annotation, which the
  profiler mirrors as a device activity over the kernels inside it, and
  so would count as the device's busy time).

Each path and bucket keeps its count, host and device totals and the last
``RING`` host and device durations (for medians).  Inside
:func:`suspended` (a CUDA graph's capture) spans record nothing and add no
node to the graph.  There are no switches: the aggregates are always kept,
and an operator reads them through :func:`snapshot`.
"""
from __future__ import annotations

import statistics
import threading
import time
from collections import deque
from contextlib import contextmanager

import torch

RING = 4096           # durations kept a path and bucket, for medians
MAX_PENDING = 8192    # event pairs awaiting resolution
SAMPLE = 8            # device-timed occurrences: one in SAMPLE a root path


class _Agg:
    """One path in one bucket."""

    __slots__ = ("count", "host_ns", "device_ms", "device_count",
                 "host_ring", "device_ring")

    def __init__(self):
        self.count, self.host_ns = 0, 0
        self.device_ms, self.device_count = 0.0, 0
        self.host_ring = deque(maxlen=RING)
        self.device_ring = deque(maxlen=RING)

    def add_device(self, ms: float):
        self.device_ms += ms
        self.device_count += 1
        self.device_ring.append(ms)

    def as_dict(self) -> dict:
        out = {"count": self.count, "host_ms": self.host_ns * 1e-6,
               "host_median_ms": statistics.median(self.host_ring) * 1e-6,
               "device_count": self.device_count,
               "device_ms": self.device_ms}
        if self.device_ring:
            out["device_median_ms"] = statistics.median(self.device_ring)
        return out


_lock = threading.Lock()
_aggs: dict = {}          # (path, bucket) -> _Agg
_counters: dict = {}
_gauges: dict = {}
_open: list = []          # [thread id, path] of the open spans, in order
_pending: deque = deque()  # (agg, device, stream, start, end)
_free: dict = {}          # device index -> idle timing events
_seen: dict = {}          # outermost path -> occurrences so far
_timed = False            # the open outermost span is device-timed
_profiler_seen = False    # a span closed under a profiler since reset()
_suspended = 0


def _parent(tid: int):
    """The path a new span on thread ``tid`` nests under: the innermost
    span open on that thread, else the span the process opened last."""
    for t, p in reversed(_open):
        if t == tid:
            return p
    return _open[-1][1] if _open else None


def _resolve(block: bool = False):
    """Fold the finished event pairs into their aggregates, oldest first;
    stop at the first unfinished one unless ``block``."""
    while _pending:
        agg, dev, _, a, b = _pending[0]
        if not block and not b.query():
            return
        _pending.popleft()
        agg.add_device(a.elapsed_time(b))
        _free[dev].extend((a, b))


class span:
    """``with span(name):`` records its body as the span ``name`` (the
    module's docstring)."""

    __slots__ = ("name", "entry", "prof", "rf", "pair", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _timed
        self.entry = self.pair = self.rf = None
        if _suspended:
            return self
        self.prof = torch.autograd._profiler_enabled()
        with _lock:
            parent = _parent(threading.get_ident())
            if parent is None:
                if _pending:
                    _resolve()
                n = _seen.get(self.name, 0) + 1
                _seen[self.name] = n
                _timed = n % SAMPLE == 0
            path = self.name if parent is None else f"{parent}/{self.name}"
            self.entry = [threading.get_ident(), path]
            _open.append(self.entry)
            if _timed and torch.cuda.is_initialized():
                if len(_pending) < MAX_PENDING:
                    dev = torch.cuda.current_device()
                    pool = _free.setdefault(dev, [])
                    self.pair = (dev, torch.cuda.current_stream(dev), *(
                        pool.pop() if pool else
                        torch.cuda.Event(enable_timing=True)
                        for _ in range(2)))
                else:
                    _counters["tracing.pairs_dropped"] = _counters.get(
                        "tracing.pairs_dropped", 0) + 1
        if self.prof:
            self.rf = torch._C._profiler._RecordFunctionFast(self.name)
            self.rf.__enter__()
        if self.pair is not None:
            self.pair[2].record(self.pair[1])
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        global _profiler_seen
        if self.entry is None:
            return False
        host = time.perf_counter_ns() - self.t0
        pair = self.pair
        if pair is not None:
            pair[3].record(pair[1])
        if self.rf is not None:
            self.rf.__exit__(exc_type, exc, tb)
        prof = self.prof or torch.autograd._profiler_enabled()
        with _lock:
            _open.remove(self.entry)
            if exc_type is not None:
                if pair is not None:
                    _free[pair[0]].extend(pair[2:])
                return False
            _profiler_seen = _profiler_seen or prof
            bucket = ("profiled" if prof else "after_profiler"
                      if _profiler_seen else "unprofiled")
            agg = _aggs.get((self.entry[1], bucket))
            if agg is None:
                agg = _aggs[(self.entry[1], bucket)] = _Agg()
            agg.count += 1
            agg.host_ns += host
            agg.host_ring.append(host)
            if pair is not None:
                _pending.append((agg, *pair))
        return False


@contextmanager
def suspended():
    """Spans inside record nothing, and launch no event: a CUDA graph's
    capture holds no node of theirs."""
    global _suspended
    with _lock:
        _suspended += 1
    try:
        yield
    finally:
        with _lock:
            _suspended -= 1


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def gauge(name: str, value):
    """Set the gauge ``name`` to ``value`` (a number)."""
    with _lock:
        _gauges[name] = value


def snapshot() -> dict:
    """Everything recorded so far as a JSON-serialisable dict: ``spans``
    (path -> bucket -> count, host and device totals and medians in ms;
    a bucket with no record is left out), ``counters``, ``gauges``, and
    the kernels' ``launches`` (``kernels.ops.launch_counts()``) and
    ``build_seconds`` (``kernels.build.last_build_seconds``) read where
    they live.  Synchronises the device once, when event pairs wait."""
    from repro_torch.kernels import build, ops
    with _lock:
        if _pending:
            torch.cuda.synchronize()
            _resolve(block=True)
        spans: dict = {}
        for (path, bucket), agg in sorted(_aggs.items()):
            spans.setdefault(path, {})[bucket] = agg.as_dict()
        return {"spans": spans, "counters": dict(_counters),
                "gauges": dict(_gauges), "launches": ops.launch_counts(),
                "build_seconds": build.last_build_seconds}


def reset():
    """Forget every span, counter and gauge, the sampling's counts and
    that a profiler was seen (the kernels' launch counts and build time
    are theirs, and stay)."""
    global _profiler_seen
    with _lock:
        if _pending:
            torch.cuda.synchronize()
            _resolve(block=True)
        _aggs.clear()
        _counters.clear()
        _gauges.clear()
        _seen.clear()
        _profiler_seen = False


def graph_nodes(raw_graph: int) -> dict:
    """The nodes of a captured CUDA graph (``CUDAGraph(keep_graph=True)``'s
    ``raw_cuda_graph()``) by kind, and their ``total``: the driver's
    ``cuGraphGetNodes`` and ``cuGraphNodeGetType`` (what the runtime's
    ``cudaGraphGetNodes`` and ``cudaGraphNodeGetType`` call) through
    ctypes.  Adds no node."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]
    cu.cuGraphGetNodes.restype = cu.cuGraphNodeGetType.restype = ctypes.c_int

    def check(err: int, what: str):
        if err:
            raise RuntimeError(f"{what} failed: CUresult {err}")
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(raw_graph, None, ctypes.byref(n)),
          "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(raw_graph, nodes, ctypes.byref(n)),
          "cuGraphGetNodes")
    # CUgraphNodeType: 0 kernel, 1 memcpy, 2 memset
    kinds = {"kernel": 0, "memcpy": 0, "memset": 0, "other": 0}
    t = ctypes.c_int()
    for node in nodes[:n.value]:
        check(cu.cuGraphNodeGetType(node, ctypes.byref(t)),
              "cuGraphNodeGetType")
        kinds[{0: "kernel", 1: "memcpy", 2: "memset"}.get(t.value,
                                                           "other")] += 1
    kinds["total"] = n.value
    return kinds
