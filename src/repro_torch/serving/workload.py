"""Request workload models: seeded arrival processes on the event clock
(the port of ``repro.serving.workload``: the same arrivals and lengths
from the same seed).

A :class:`Request` is one user call: it arrives at ``arrival_us`` (event
clock, not wall clock), carries ``prompt_len`` tokens to prefill and asks
for ``max_new_tokens`` decode tokens.  Arrival processes are deterministic
functions of their seed so every benchmark/test run sees the same traffic:

- :func:`poisson_arrivals` — memoryless traffic at one offered load
  (exponential inter-arrival gaps), the open-loop load-sweep workhorse.
- :func:`bursty_arrivals` — on/off (interrupted-Poisson) traffic: bursts at
  ``rate_rps * burst_factor`` separated by idle gaps, same mean load.
- :func:`load_curve_arrivals` — piecewise-constant offered-load curve
  (ramps, spikes, diurnal shapes) for scenario tests.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Request:
    """One serving request, timestamped on the event clock."""

    rid: int
    arrival_us: float
    prompt_len: int
    max_new_tokens: int

    def __post_init__(self):
        assert self.prompt_len > 0 and self.max_new_tokens > 0, self


def _lengths(rng: np.random.Generator, n: int, lo_hi: tuple[int, int],
             ) -> np.ndarray:
    lo, hi = lo_hi
    assert 0 < lo <= hi, lo_hi
    return rng.integers(lo, hi + 1, size=n)


def poisson_arrivals(rate_rps: float, n: int, *, seed: int,
                     prompt_len: tuple[int, int] = (16, 64),
                     gen_len: tuple[int, int] = (8, 32),
                     start_us: float = 0.0, rid0: int = 0) -> list[Request]:
    """``n`` requests with exponential inter-arrival gaps at ``rate_rps``
    requests/second (event-clock microseconds)."""
    assert rate_rps > 0 and n > 0
    rng = np.random.default_rng(seed)
    gaps_us = rng.exponential(1e6 / rate_rps, size=n)
    t = start_us + np.cumsum(gaps_us)
    pl = _lengths(rng, n, prompt_len)
    gl = _lengths(rng, n, gen_len)
    return [Request(rid0 + i, float(t[i]), int(pl[i]), int(gl[i]))
            for i in range(n)]


def bursty_arrivals(rate_rps: float, n: int, *, seed: int,
                    burst_factor: float = 4.0, burst_len: int = 8,
                    prompt_len: tuple[int, int] = (16, 64),
                    gen_len: tuple[int, int] = (8, 32),
                    start_us: float = 0.0) -> list[Request]:
    """Interrupted-Poisson traffic: bursts of ``burst_len`` requests at
    ``rate_rps * burst_factor``, separated by idle gaps sized so the MEAN
    offered load stays ``rate_rps`` — the tail-latency stressor."""
    assert burst_factor > 1.0 and burst_len > 0
    rng = np.random.default_rng(seed)
    in_burst = rng.exponential(1e6 / (rate_rps * burst_factor), size=n)
    # each burst of B requests owes (B gaps at the mean rate) total time;
    # the idle gap carries what the fast in-burst gaps did not spend
    idle_gap = burst_len * 1e6 * (1.0 / rate_rps
                                  - 1.0 / (rate_rps * burst_factor))
    gaps = in_burst.copy()
    gaps[burst_len - 1::burst_len] += idle_gap * rng.uniform(
        0.5, 1.5, size=len(gaps[burst_len - 1::burst_len]))
    t = start_us + np.cumsum(gaps)
    pl = _lengths(rng, n, prompt_len)
    gl = _lengths(rng, n, gen_len)
    return [Request(i, float(t[i]), int(pl[i]), int(gl[i]))
            for i in range(n)]


def load_curve_arrivals(curve: list[tuple[float, float]], *, seed: int,
                        prompt_len: tuple[int, int] = (16, 64),
                        gen_len: tuple[int, int] = (8, 32)) -> list[Request]:
    """Piecewise-constant offered load: ``curve`` is a list of
    ``(duration_us, rate_rps)`` segments; requests are Poisson within each
    segment.  ``rate_rps == 0`` segments are idle gaps."""
    rng = np.random.default_rng(seed)
    out: list[Request] = []
    t0 = 0.0
    rid = 0
    for dur_us, rate in curve:
        assert dur_us > 0 and rate >= 0, (dur_us, rate)
        t = t0
        while rate > 0:
            t += rng.exponential(1e6 / rate)
            if t >= t0 + dur_us:
                break
            out.append(Request(rid, float(t),
                               int(_lengths(rng, 1, prompt_len)[0]),
                               int(_lengths(rng, 1, gen_len)[0])))
            rid += 1
        t0 += dur_us
    return out
