"""The traced slice of a run and the counters the per-layer readers use.

A ``--trace 1`` run profiles a bounded slice of its steps with
``torch.profiler`` (CPU and CUDA activities) and reduces the trace here:
the wall time of the slice, the union of the device's activity intervals
(its busy time), the device time of the EP kernels by kind (by their
kernel names, ``roofline.DEVICE_KINDS``), the device operations with the
most time, and the longest idle gaps named by the host operation that
was running in them.  The profiler can lose a few device records late in
a process; a kernel that every step launches the same number of times is
counted at that number, at the mean time of the records kept.

Under :func:`recording` a driver runs one more step of its cell with each
EP kernel's wrapper standing in a recorder that adds up the frozen bound
of every call (``roofline.kernel_bound``) from the call's own shapes and
counts (a replayed CUDA graph shows none of its calls' inputs).
"""
from __future__ import annotations

import bisect
import time
from contextlib import contextmanager

import torch

from epbench import roofline


class Slice:
    """``start()`` / ``stop(steps)`` around the profiled steps."""

    def __init__(self):
        self.prof = None
        self.result = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self, steps: int, **extra):
        torch.cuda.synchronize()
        wall = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        self.result = summarize(self.prof, wall, steps)
        self.result.update(extra)
        self.prof = None
        return self.result


def summarize(prof, wall: float, steps: int) -> dict:
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.events():
        rng = (e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            dev.append((*rng, e.name))
        elif e.device_type == DeviceType.CPU:
            host.append((*rng, e.name))
    dev.sort()
    spans = []
    for a, b, _ in dev:
        if spans and a <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], b)
        else:
            spans.append([a, b])
    busy_us = sum(b - a for a, b in spans)
    # per kernel name: its records, and the count a step launches
    by_name: dict = {}
    for a, b, n in dev:
        c = by_name.setdefault(n, [0, 0.0])
        c[0] += 1
        c[1] += (b - a) * 1e-6
    kinds: dict = {}
    ops = []
    for n, (count, secs) in by_name.items():
        per_step = max(1, round(count / steps))
        whole = secs / count * per_step * steps
        ops.append((whole, n))
        k = roofline.device_kind(n)
        if k is not None:
            kinds[k] = kinds.get(k, 0.0) + whole
    ops.sort(reverse=True)
    # the gaps between busy intervals within the traced host time
    lo = min([h[0] for h in host] + [s[0] for s in spans], default=0.0)
    hi = max([h[1] for h in host] + [s[1] for s in spans], default=0.0)
    gaps, prev = [], lo
    for a, b in spans:
        if a > prev:
            gaps.append((a - prev, prev, a))
        prev = max(prev, b)
    if hi > prev:
        gaps.append((hi - prev, prev, hi))
    gaps.sort(reverse=True)
    host.sort()
    starts = [h[0] for h in host]
    named = []
    for length, a, b in gaps[:10]:
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid)
        inner = None
        for j in range(i - 1, max(-1, i - 4000), -1):
            s, e, n = host[j]
            if e >= mid and (inner is None or e - s < inner[0]):
                inner = (e - s, n)
        named.append([inner[1] if inner else "(no host operation)",
                      length * 1e-6])
    return {"wall_s": wall, "steps": steps, "busy_s": busy_us * 1e-6,
            "device_records": len(dev), "kind_s": kinds,
            "device_ops": [[n[:160], s] for s, n in ops[:10]],
            "idle_gaps": named}


@contextmanager
def recording(names=roofline.EP_KERNELS):
    """Recorders in place of the port's CUDA wrappers of ``names``; yields
    a dict that adds up each call's bound (seconds) and work."""
    from repro_torch.kernels import ops
    originals = {n: ops.KERNELS[n] for n in names if n in ops.KERNELS}
    total = {"bound_s": 0.0, "experts": []}

    def wrap(name, fn):
        def rec(*args, **kwargs):
            out = fn(*args, **kwargs)
            t, work = roofline.kernel_bound(name, args)
            total["bound_s"] += t
            if "experts" in work and name in ("grouped_swiglu",
                                              "gather_swiglu_scatter"):
                total["experts"].append(work["experts"])
            return out
        return rec

    for n, (cuda, plain) in originals.items():
        ops.KERNELS[n] = (wrap(n, cuda), plain)
    try:
        yield total
    finally:
        ops.KERNELS.update(originals)
