"""The EP-native continuous-batching serving engine (DESIGN.md §18): the
port of ``repro.serving.engine``.

:class:`ServingEngine` closes the loop the ROADMAP's top open item asked
for: requests (seeded arrival processes) -> continuous-batching scheduler
(:mod:`repro_torch.serving.scheduler`) over a paged KV pool
(:mod:`repro_torch.serving.kv_cache`) -> one *model step* per microbatch whose
``n_layers`` MoE layers dispatch through a persistent EP session
(``SimulatedRDMABackend.dispatch_step``) on the deterministic event clock.

Time accounting is entirely event-clock: a microbatch's cost is the span
``dispatch_step`` reports (L non-MoE attention segments + L LL
dispatch/combine rounds, overlapped or not per ``step_mode``), and the
engine clock jumps forward by that span.  Requests arrive on the same
clock, so tokens/s, TTFT and inter-token latency are deterministic
functions of (config, workload seed) — the property the exact-equality
benchmark rows gate on.

The serving A/B the fig13 benchmark measures is ``step_mode``:

- ``"pipelined"`` — persistent session, one quiesce drain per microbatch,
  rank-local cross-layer overlap (the training-step pipeline, forward-only);
- ``"serial"``    — persistent session, one drain per layer;
- ``"per_layer"`` — naive: a fresh world per layer per microbatch
  (registration rebuilt every call), clocks summed.

Token embeddings and router choices are seeded functions of
``(rid, position, layer)`` ONLY — never of generated token values — so the
three modes run bit-identical routing and the cross-layer pipelining that
makes the session path fast is legitimate (layer l+1's dispatch does not
depend on layer l's combine output).  The replica path hangs a
:class:`~repro_torch.distributed.elastic.LoadBalancer` off the router: logical
routing tables are split across replica slots per microbatch and the
placement is re-fit online when the load window skews.

The port keeps the reference's host loop, event clock and counters, and
draws the same expert weights from the same seed; it holds them as tensors
on ``device`` (fp32 on the CPU, bf16 on the card, the kernel's dtype), so
each launched expert of each layer runs through ``ops.grouped_swiglu`` on
that device (:func:`repro_torch.core.transport.ep_executor.tensor_swiglu`):
the ``grouped_swiglu`` CUDA kernel on the card, its plain version on the
CPU.  Counters, clock, TTFT and inter-token latencies do not depend on the
device; on the CPU the outputs match the reference's within 1e-5.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core import plan as planlib
from repro_torch.core.backend import SimulatedRDMABackend
from repro_torch.core.ep import EPSpec
from repro_torch.core.transport.simulator import NetConfig
from repro_torch.distributed.elastic import LoadBalancer
from repro_torch.serving.kv_cache import KVBlockPool
from repro_torch.serving.scheduler import (Microbatch, Scheduler,
                                           SchedulerConfig)
from repro_torch.serving.workload import Request


@dataclass(frozen=True)
class EngineConfig:
    """Static serving configuration (model geometry + EP + cache + step)."""

    n_layers: int = 2          # MoE layers per model step
    n_experts: int = 8         # logical experts
    top_k: int = 2
    d_model: int = 16
    d_ff: int = 32
    ep_degree: int = 4         # simulated EP ranks
    token_budget: int = 32     # microbatch tokens == the session's T
    prefill_chunk: int = 16
    block_size: int = 16       # KV block, tokens
    n_blocks: int = 512        # KV pool size
    step_mode: str = "pipelined"   # "pipelined" | "serial" | "per_layer"
    wire_dtype: str = "fp32"       # "fp32" | "fp8" | "int8" (the row codecs)
    nonmoe_us: float = 20.0    # attention/norm segment per layer, eventclock
    replicas_per_expert: int = 1   # >1 engages the LoadBalancer path
    route_alpha: float = 0.0   # Zipf skew of expert popularity (0 = uniform)
    seed: int = 0
    n_channels: int = 4
    net_cfg: Optional[object] = None   # transport NetConfig (seeded default)

    def __post_init__(self):
        assert self.token_budget % self.ep_degree == 0, \
            "token_budget must be divisible by ep_degree (session geometry)"
        assert self.step_mode in ("pipelined", "serial", "per_layer")
        E_phys = self.n_experts * self.replicas_per_expert
        assert E_phys % self.ep_degree == 0, (E_phys, self.ep_degree)


def _weight_dtype(device: torch.device) -> torch.dtype:
    """fp32 on the CPU (the reference's arithmetic), bf16 on the card (the
    ``grouped_swiglu`` kernel's dtype); a CUDA device without a card
    raises, with no fallback to the CPU."""
    if device.type == "cpu":
        return torch.float32
    if device.type != "cuda":
        raise ValueError(f"ServingEngine: no expert kernel for device "
                         f"{device}")
    if not torch.cuda.is_available():
        raise RuntimeError("ServingEngine: device cuda asked for, and no "
                           "CUDA device is available")
    return torch.bfloat16


class ServingEngine:
    """Continuous-batching decode engine over a persistent EP session; its
    experts compute on ``device``."""

    def __init__(self, cfg: EngineConfig, device="cuda"):
        device = torch.device(device)
        dtype = _weight_dtype(device)
        self.cfg = cfg
        self.clock_us = 0.0
        self.pool = KVBlockPool(cfg.n_blocks, cfg.block_size)
        self.sched = Scheduler(
            SchedulerConfig(cfg.token_budget, cfg.prefill_chunk), self.pool)
        net_cfg = cfg.net_cfg or NetConfig(mode="srd", seed=cfg.seed)
        session = cfg.step_mode != "per_layer"
        self.backend = SimulatedRDMABackend(
            net_cfg, n_channels=cfg.n_channels,
            session_layers=cfg.n_layers if session else 0)
        # expert FFN weights, shared across layers (serving replicas of one
        # deployment); physical slots view logical weights through p2l
        E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
        rng = np.random.default_rng((cfg.seed, 0xEF))
        self._wg, self._wu, self._wd = (
            torch.from_numpy((rng.standard_normal(shape) * 0.1)
                             .astype(np.float32)).to(device=device,
                                                     dtype=dtype)
            for shape in ((E, D, F), (E, D, F), (E, F, D)))
        # Zipf expert-popularity weights with a per-layer permutation, so
        # skew hits different physical ranks per layer (the LB stressor)
        p = 1.0 / np.arange(1, E + 1, dtype=np.float64) ** cfg.route_alpha
        self._route_p = []
        for l in range(cfg.n_layers):
            perm = np.random.default_rng((cfg.seed, 0x9E, l)).permutation(E)
            pl = np.empty(E)
            pl[perm] = p
            self._route_p.append(pl / pl.sum())
        # replica path: placement starts uniform, re-fit online by the LB
        self.lb = None
        if cfg.replicas_per_expert > 1:
            self.lb = LoadBalancer(
                n_logical=E, n_ranks=cfg.ep_degree,
                slots_per_rank=E * cfg.replicas_per_expert // cfg.ep_degree)
        self.spec = EPSpec(
            axes=("ep",), sizes=(cfg.ep_degree,),
            n_experts=E * cfg.replicas_per_expert, top_k=cfg.top_k,
            mode="ll", wire_dtype=cfg.wire_dtype)
        self._pending: list[Request] = []    # not yet arrived, time-sorted
        self.counters = {
            "steps": 0, "rebalances": 0, "drains": 0, "cmds": 0,
            "dispatch_payload_bytes": 0, "dispatch_wire_bytes": 0,
            "dispatch_msgs": 0, "moe_elapsed_us": 0,
        }
        self.output_digest = 0.0   # order-independent sum over valid rows
        self.last_outs: list = []  # the last step's per-layer (T, D) outputs

    # ---------------------------------------------------------- submission --
    def submit(self, req: Request) -> None:
        self._pending.append(req)
        self._pending.sort(key=lambda r: (r.arrival_us, r.rid))

    def submit_all(self, reqs: list[Request]) -> None:
        self._pending.extend(reqs)
        self._pending.sort(key=lambda r: (r.arrival_us, r.rid))

    def _admit_arrived(self) -> None:
        while self._pending and self._pending[0].arrival_us <= self.clock_us:
            self.sched.add(self._pending.pop(0))

    # --------------------------------------------------------- model inputs --
    def _token_inputs(self, mb: Microbatch):
        """Build the padded step arrays for a microbatch: x ``(T, D)`` and
        per-layer LOGICAL routing ``(T, K)`` (+ weights), all seeded by
        ``(rid, position, layer)``.  Padding rows carry ``ti = -1`` and move
        no traffic, keeping the session's registered geometry fixed."""
        cfg = self.cfg
        T, D, K, L = cfg.token_budget, cfg.d_model, cfg.top_k, cfg.n_layers
        x = np.zeros((T, D), np.float32)
        tis = [np.full((T, K), -1, np.int32) for _ in range(L)]
        tws = [np.zeros((T, K), np.float32) for _ in range(L)]
        row = 0
        for s in mb.slices:
            for pos in range(s.start, s.start + s.n_tokens):
                rng = np.random.default_rng((cfg.seed, s.rid, pos))
                x[row] = rng.standard_normal(D).astype(np.float32)
                for l in range(L):
                    tis[l][row] = rng.choice(cfg.n_experts, size=K,
                                             replace=False, p=self._route_p[l])
                    w = rng.random(K).astype(np.float32) + 1e-3
                    tws[l][row] = w / w.sum()
                row += 1
        assert row == mb.n_tokens <= T
        return x, tis, tws

    def _physical(self, tis):
        """Translate logical routing to physical replica slots (identity
        when ``replicas_per_expert == 1``) and return per-layer ``(T, K)``
        physical tables plus the physical-slot weight views."""
        cfg = self.cfg
        if self.lb is None:
            return tis, self._wg, self._wu, self._wd
        pl_obj = self.lb.placement
        R, T = cfg.ep_degree, cfg.token_budget
        out = []
        for ti in tis:
            ti_r = torch.from_numpy(ti.reshape(R, T // R, cfg.top_k))
            out.append(planlib.split_to_physical_world(pl_obj, ti_r)
                       .numpy().reshape(T, cfg.top_k))
        p2l = torch.as_tensor(np.asarray(pl_obj.phys_to_logical, np.int64),
                              device=self._wg.device)
        return out, self._wg[p2l], self._wu[p2l], self._wd[p2l]

    # -------------------------------------------------------------- stepping --
    def step(self) -> bool:
        """Run ONE engine step: admit arrivals, schedule a microbatch, run
        the model step on the event clock, apply completions.  Returns False
        when there is nothing left to do (now or in the future)."""
        self._admit_arrived()
        mb = self.sched.schedule(self.clock_us)
        if mb is None:
            if not self._pending:
                if self.sched.has_work:
                    raise RuntimeError(
                        "serving stalled: work queued but unschedulable "
                        "(KV pool too small for the running set)")
                return False
            # idle: jump the event clock to the next arrival
            self.clock_us = max(self.clock_us, self._pending[0].arrival_us)
            self._admit_arrived()
            mb = self.sched.schedule(self.clock_us)
            if mb is None:
                raise RuntimeError("arrival admitted but not schedulable")
        x, tis_log, tws = self._token_inputs(mb)
        tis, wg, wu, wd = self._physical(tis_log)
        outs, elapsed, stats = self.backend.dispatch_step(
            self.spec, [x] * self.cfg.n_layers, tis, tws, wg, wu, wd,
            nonmoe_fwd_us=self.cfg.nonmoe_us, mode=self.cfg.step_mode)
        self.clock_us += elapsed
        self.last_outs = outs
        self.sched.complete_step(mb, self.clock_us)
        self.pool.assert_consistent()     # no double-alloc / leak, per step
        c = self.counters
        c["steps"] += 1
        c["drains"] += stats["drains_per_step"]
        c["cmds"] += stats["cmds_per_step"]
        c["dispatch_payload_bytes"] += stats["dispatch_payload_bytes"]
        c["dispatch_wire_bytes"] += stats["dispatch_wire_bytes"]
        c["dispatch_msgs"] += stats["dispatch_msgs"]
        c["moe_elapsed_us"] += int(round(elapsed))
        n = mb.n_tokens
        self.output_digest += float(np.abs(outs[-1][:n]).sum())
        if self.lb is not None:
            # observe LOGICAL loads of the last layer's routing; re-fit the
            # placement when the window imbalance trips the threshold
            flat = tis_log[-1].reshape(-1)
            self.lb.observe(np.bincount(flat[flat >= 0],
                                        minlength=self.cfg.n_experts)
                            .astype(np.int32))
            if self.lb.maybe_replace() is not None:
                c["rebalances"] += 1
        return True

    def run(self, max_steps: int = 1 << 30) -> dict:
        """Drive the engine until every submitted request completes (or
        ``max_steps``), then return :meth:`stats`."""
        steps = 0
        while steps < max_steps and self.step():
            steps += 1
        return self.stats()

    # --------------------------------------------------------------- stats --
    def stats(self) -> dict:
        sc = self.sched.counters
        gen = sc["generated_tokens"]
        out = {
            "elapsed_us": self.clock_us,
            "generated_tokens": gen,
            "tokens_per_s": gen / (self.clock_us / 1e6)
            if self.clock_us > 0 else 0.0,
            **{f"sched_{k}": v for k, v in sc.items()},
            **dict(self.counters),
            "kv_allocs": self.pool.allocs, "kv_frees": self.pool.frees,
            "kv_high_water": self.pool.high_water,
            **self.sched.latency_stats(),
        }
        return out
