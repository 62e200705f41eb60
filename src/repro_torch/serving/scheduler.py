"""Continuous-batching scheduler with prefill/decode disaggregation (the
port of ``repro.serving.scheduler``, over the port's :class:`KVBlockPool`).

Forms one :class:`Microbatch` per engine step under two constraints:

- **token budget** — at most ``token_budget`` tokens per microbatch (the
  fixed EP geometry the persistent session is registered for; the engine
  pads the remainder with invalid routing entries that move no traffic);
- **cache pressure** — a token is scheduled ONLY after its KV block is
  allocated (``KVBlockPool.grow`` before the slice is emitted).  A decode
  step that cannot get a block stalls that sequence for the step; a prompt
  that cannot get its first chunk's blocks blocks admission (head-of-line,
  so admission stays FIFO and deterministic).

Decode runs first (keeps inter-token latency flat under load), then
*chunked prefill* fills the remaining budget — at most ``prefill_chunk``
prompt tokens per request per step, so one long prompt cannot freeze every
running decode (the prefill/decode disaggregation knob; chunk == budget
degenerates to whole-prompt prefill).  When a sequence's last prompt chunk
completes, that same model step's logits yield its first generated token —
time-to-first-token is measured to the END of that step on the event clock.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.serving.kv_cache import KVBlockPool
from repro_torch.serving.workload import Request


@dataclass(frozen=True)
class Slice:
    """One request's contribution to a microbatch: ``n_tokens`` tokens of
    ``kind`` ("prefill" | "decode") covering positions
    ``[start, start + n_tokens)`` of sequence ``rid``."""
    rid: int
    kind: str
    start: int
    n_tokens: int


@dataclass
class Microbatch:
    slices: list[Slice] = field(default_factory=list)

    @property
    def n_tokens(self) -> int:
        return sum(s.n_tokens for s in self.slices)

    def count(self, kind: str) -> int:
        return sum(s.n_tokens for s in self.slices if s.kind == kind)


@dataclass
class SeqState:
    req: Request
    admitted_us: float
    prefilled: int = 0         # prompt tokens staged into the KV cache
    generated: int = 0         # tokens produced (first comes with prefill)
    done: bool = False
    first_token_us: Optional[float] = None
    finish_us: Optional[float] = None
    token_times: list[float] = field(default_factory=list)

    @property
    def cache_len(self) -> int:
        """Tokens resident in the KV cache: the prompt prefix staged so far
        plus every generated token that has been fed back (all but the
        newest)."""
        return self.prefilled + max(0, self.generated - 1)


@dataclass(frozen=True)
class SchedulerConfig:
    token_budget: int          # microbatch size (== the session's T)
    prefill_chunk: int         # max prompt tokens per request per step
    max_running: int = 1 << 30

    def __post_init__(self):
        assert 0 < self.prefill_chunk <= self.token_budget


class Scheduler:
    def __init__(self, cfg: SchedulerConfig, pool: KVBlockPool):
        self.cfg = cfg
        self.pool = pool
        self.waiting: deque[Request] = deque()
        self.running: dict[int, SeqState] = {}
        self.finished: dict[int, SeqState] = {}
        self.counters = {
            "scheduled_tokens": 0, "prefill_tokens": 0, "decode_tokens": 0,
            "generated_tokens": 0, "evicted_blocks": 0, "decode_stalls": 0,
            "admission_blocked": 0, "microbatches": 0, "completed": 0,
        }

    # -------------------------------------------------------------- intake --
    def add(self, req: Request) -> None:
        self.waiting.append(req)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting) or any(not s.done
                                         for s in self.running.values())

    # ------------------------------------------------------------ schedule --
    def schedule(self, now_us: float) -> Optional[Microbatch]:
        """Form the next microbatch.  Every slice returned already has its
        KV blocks allocated (the no-token-without-a-block invariant)."""
        pool, c = self.pool, self.counters
        budget = self.cfg.token_budget
        mb = Microbatch()

        # 1) decode: one token per running, fully-prefilled, live sequence
        for rid, st in self.running.items():
            if budget == 0:
                break
            if st.done or st.prefilled < st.req.prompt_len:
                continue
            pos = st.cache_len                     # feed back the newest tok
            if not pool.can_grow(rid, pos + 1):
                c["decode_stalls"] += 1            # stalled, retried next mb
                continue
            pool.grow(rid, pos + 1)
            mb.slices.append(Slice(rid, "decode", pos, 1))
            budget -= 1

        # 2) chunked prefill of partially-staged running prompts
        for rid, st in self.running.items():
            if budget == 0:
                break
            if st.done or st.prefilled >= st.req.prompt_len:
                continue
            n = min(self.cfg.prefill_chunk, st.req.prompt_len - st.prefilled,
                    budget)
            if not pool.can_grow(rid, st.prefilled + n):
                c["decode_stalls"] += 1
                continue
            pool.grow(rid, st.prefilled + n)
            mb.slices.append(Slice(rid, "prefill", st.prefilled, n))
            budget -= n

        # 3) admit new requests (FIFO; head-of-line on cache pressure)
        n_live = sum(not s.done for s in self.running.values())
        while self.waiting and budget > 0 and n_live < self.cfg.max_running:
            req = self.waiting[0]
            n = min(self.cfg.prefill_chunk, req.prompt_len, budget)
            if not pool.can_grow(req.rid, n):
                c["admission_blocked"] += 1
                break
            self.waiting.popleft()
            pool.grow(req.rid, n)
            self.running[req.rid] = SeqState(req, admitted_us=now_us)
            mb.slices.append(Slice(req.rid, "prefill", 0, n))
            budget -= n
            n_live += 1

        if not mb.slices:
            return None
        c["microbatches"] += 1
        c["scheduled_tokens"] += mb.n_tokens
        c["prefill_tokens"] += mb.count("prefill")
        c["decode_tokens"] += mb.count("decode")
        return mb

    # ------------------------------------------------------------ complete --
    def complete_step(self, mb: Microbatch, t_end_us: float) -> list[int]:
        """Apply a finished microbatch at event-clock time ``t_end_us``:
        advance prefill offsets, emit tokens (the last prompt chunk's logits
        yield the first generated token), retire + evict finished sequences.
        Returns the rids that finished this step."""
        c = self.counters
        done_now: list[int] = []
        for s in mb.slices:
            st = self.running[s.rid]
            if s.kind == "prefill":
                assert s.start == st.prefilled, (s, st.prefilled)
                st.prefilled += s.n_tokens
                if st.prefilled == st.req.prompt_len:
                    st.generated = 1              # first token: last logit
                    st.first_token_us = t_end_us
                    st.token_times.append(t_end_us)
                    c["generated_tokens"] += 1
            else:
                st.generated += 1
                st.token_times.append(t_end_us)
                c["generated_tokens"] += 1
            if st.generated >= st.req.max_new_tokens and not st.done:
                st.done = True
                st.finish_us = t_end_us
                done_now.append(s.rid)
        for rid in done_now:
            c["evicted_blocks"] += self.pool.release(rid)
            c["completed"] += 1
            self.finished[rid] = self.running.pop(rid)
        return done_now

    # ------------------------------------------------------------- metrics --
    def latency_stats(self) -> dict:
        """TTFT and inter-token latency percentiles over finished (and
        in-flight) sequences, event-clock microseconds."""
        ttft, itl = [], []
        for st in list(self.finished.values()) + list(self.running.values()):
            if st.first_token_us is not None:
                ttft.append(st.first_token_us - st.req.arrival_us)
            ts = st.token_times
            itl.extend(float(b - a) for a, b in zip(ts, ts[1:]))
        out = {}
        for name, xs in (("ttft", ttft), ("itl", itl)):
            if xs:
                arr = np.asarray(xs)
                out[f"{name}_p50_us"] = float(np.percentile(arr, 50))
                out[f"{name}_p99_us"] = float(np.percentile(arr, 99))
        return out
