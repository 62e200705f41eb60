"""Pluggable EP transport backends behind one dispatch/combine seam (the
port of ``repro.core.backend``'s registry).

Every backend implements

    ``dispatch_combine(spec, x, top_idx, top_w, expert_fn) -> DispatchResult``

Registered here:

- ``torch_collectives``: LL or HT per ``spec.mode`` over the rank-stacked
  EP world of :mod:`repro_torch.core.ep` (the counterpart of the JAX
  package's ``jax_collectives``; :class:`TorchCollectivesBackend` is its
  ``JaxCollectivesBackend``).
- ``simulated_rdma``: the transport-substrate path — numpy host execution
  over FIFO channels, CPU proxies and the ordered/unordered network model
  (:class:`repro_torch.core.transport.ep_executor.EPWorld`).  Bit-level
  protocol reference, and the cross-check oracle for routing equivalence
  tests; the model's expert function still runs on the weights' device
  (:func:`repro_torch.core.moe._moe_host_sim`).

``jit_compatible`` says whether a backend may run inside a captured CUDA
graph (the reference's "inside jit"): a host backend reads device values
on the host, so ``moe_apply`` routes it to its host path and ``generate``
decodes eagerly.
"""
from __future__ import annotations

from typing import Callable, Dict, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import plan as planlib


@runtime_checkable
class EPBackend(Protocol):
    """One EP transport implementation behind the dispatch/combine seam."""

    name: str
    # True: runs on the device over tensors, and may run inside a captured
    # CUDA graph.  False: host backend (numpy arrays, eager only); the moe
    # layer routes these generically, with no case by name
    jit_compatible: bool

    def dispatch_combine(self, spec, x, top_idx, top_w, expert_fn):
        """x: (R, T, D); top_idx/top_w: (R, T, K) -> DispatchResult."""
        ...


_REGISTRY: Dict[str, Callable[..., EPBackend]] = {}


def register_backend(name: str):
    """Class/factory decorator: ``@register_backend("my_transport")``."""
    def deco(factory):
        _REGISTRY[name] = factory
        return factory
    return deco


def get_backend(name: str, **kwargs) -> EPBackend:
    if name not in _REGISTRY:
        raise KeyError(f"unknown EP backend {name!r}; "
                       f"available: {available_backends()}")
    return _REGISTRY[name](**kwargs)


def available_backends() -> list[str]:
    return sorted(_REGISTRY)


@register_backend("torch_collectives")
class TorchCollectivesBackend:
    """One-shot LL or chunked/dedup'd HT dispatch over the rank-stacked
    world, selected by ``spec.mode``."""

    name = "torch_collectives"
    jit_compatible = True

    def dispatch_combine(self, spec, x, top_idx, top_w, expert_fn):
        from repro_torch.core.ep import dispatch_combine_ht, dispatch_combine_ll
        fn = dispatch_combine_ll if spec.mode == "ll" else dispatch_combine_ht
        return fn(spec, x, top_idx, top_w, expert_fn)


def _load_imbalance(counts: np.ndarray) -> float:
    """max/mean load over the physical slots (1.0 when empty)."""
    c = np.asarray(counts, np.float64)
    m = float(c.mean()) if c.size else 0.0
    return float(c.max() / m) if m > 0 else 1.0


# ===================================================== simulated RDMA =====
@register_backend("simulated_rdma")
class SimulatedRDMABackend:
    """Host-side reference backend over the transport substrate.

    Simulates ``spec.degree`` ranks in-process: tokens are split row-major
    across ranks, dispatched as batched TransferCmd streams through FIFO
    channels + CPU proxies over the (ordered RC / unordered SRD) network
    model, and combined with per-token weighted reduce at the source.

    Capacity is lossless (``T_local * K`` slots per (src, expert) bucket),
    so with a spec whose capacity factor avoids drops the two backends
    agree on the same routing table.  Host arrays in and out: ``x`` (T, D)
    and ``top_idx``/``top_w`` (T, K) numpy, the result's ``out`` (T, D)
    fp32 numpy (the collectives take and give rank-stacked tensors).  ``expert_fn`` must cover
    all ``spec.n_physical`` global expert slots: ``(E, N, D) -> (E, N, D)``
    (== ``spec.n_experts`` without a replicated placement; with one, row
    block p holds physical slot p = logical ``phys_to_logical[p]``).

    Replicated placements translate the logical routing table to physical
    slots per source rank (``plan.split_to_physical_world`` — the same
    deterministic round-robin split the collectives apply per rank) before
    command-stream generation, so guard tables, fence counts and
    ``ret_pos`` all size from the replicated layout with no executor
    changes.
    """

    name = "simulated_rdma"
    # numpy on the host: reads device values, so it can run neither under
    # a CUDA graph capture nor under autograd
    jit_compatible = False

    def __init__(self, net_cfg=None, n_channels: int = 8,
                 use_threads: bool = False, n_threads: int = 4,
                 columnar: bool = True, coalesce: bool = True,
                 session_layers: int = 0, session_mirror: bool = False):
        from repro_torch.core.transport.simulator import NetConfig
        self.net_cfg = net_cfg or NetConfig(mode="srd", seed=0)
        self.n_channels = n_channels
        # threaded proxies exercise the concurrent FIFO/quiesce path (the
        # semantics conformance fuzz drives both); inline is deterministic
        self.use_threads = use_threads
        self.n_threads = n_threads
        # columnar=False runs the scalar TransferCmd drain (the conformance
        # oracle); coalesce=False disables RDMA write coalescing only
        self.columnar = columnar
        self.coalesce = coalesce
        # session_layers > 0: persistent EP session (DESIGN §16) — ONE
        # EPWorld per spec shape kept across dispatch_combine calls, guard
        # tables/buckets/proxies registered once; call l mod session_layers
        # routes to layer slot l, and the wrap to slot 0 begins a new step
        self.session_layers = session_layers
        self.session_mirror = session_mirror
        self._sessions: dict = {}
        self._layer_cursor = 0
        self.last_world = None      # exposed for stats/introspection

    def begin_step(self):
        """Realign the layer cursor (the next dispatch_combine is layer 0
        of a fresh step).  Safe to call with no session configured."""
        self._layer_cursor = 0

    def dispatch_combine(self, spec, x, top_idx, top_w, expert_fn):
        from repro_torch.core.ep import DispatchResult
        from repro_torch.core.transport.ep_executor import EPWorld

        x = np.asarray(x, np.float32)
        top_idx = np.asarray(top_idx)
        top_w = np.asarray(top_w, np.float32)
        T, D = x.shape
        K = top_idx.shape[1]
        R = spec.degree
        assert T % R == 0, f"token count {T} not divisible by EP degree {R}"
        Tl = T // R

        def global_expert_fn(toks, counts=None):
            out = planlib.call_expert_fn(expert_fn, toks, counts)
            return np.asarray(out, np.float32)

        # replicated placement: translate logical->physical per source rank
        # (the same deterministic split the collectives run, on CPU tensors)
        pl_obj = None
        p_tab = getattr(spec, "placement", None)
        if p_tab is not None:
            pl_obj = planlib.placement_from_table(np.asarray(p_tab, np.int32))
            if pl_obj.is_identity:
                pl_obj = None
        E_phys = len(p_tab) if p_tab is not None else spec.n_experts

        wire_dtype = getattr(spec, "wire_dtype", "fp32")
        layer = 0
        if self.session_layers > 0:
            # persistent session: one world per spec shape, reused across
            # layers and steps; the cursor assigns layer slots in call
            # order (the model calls its MoE layers in a fixed sequence)
            skey = (spec.mode, R, E_phys, K, D, Tl, spec.chunks, wire_dtype)
            world = self._sessions.get(skey)
            if world is None:
                world = EPWorld(n_ranks=R, n_experts=E_phys, top_k=K, d=D,
                                capacity=Tl * K, net_cfg=self.net_cfg,
                                n_channels=self.n_channels,
                                columnar=self.columnar,
                                coalesce=self.coalesce,
                                wire_dtype=wire_dtype, session=True,
                                n_layers=self.session_layers,
                                mirror=self.session_mirror)
                self._sessions[skey] = world
            layer = self._layer_cursor % self.session_layers
            self._layer_cursor += 1
            if layer == 0:
                world.begin_step()
        else:
            world = EPWorld(n_ranks=R, n_experts=E_phys, top_k=K, d=D,
                            capacity=Tl * K, net_cfg=self.net_cfg,
                            n_channels=self.n_channels,
                            use_threads=self.use_threads,
                            n_threads=self.n_threads,
                            columnar=self.columnar, coalesce=self.coalesce,
                            wire_dtype=wire_dtype)
        xs = x.reshape(R, Tl, D)
        tis = top_idx.reshape(R, Tl, K)
        tws = top_w.reshape(R, Tl, K)
        if pl_obj is not None:
            tis = planlib.split_to_physical_world(
                pl_obj, torch.from_numpy(np.ascontiguousarray(tis))).numpy()
        if spec.mode == "ht":
            # HT: chunked dedup'd dispatch + hierarchical reduce, executed
            # literally on the substrate; capacity Tl per (src, dst) bucket
            # is lossless (a token crosses each rank boundary at most once)
            out = world.run_ht(xs, tis, tws, expert_fn=global_expert_fn,
                               n_chunks=spec.chunks, capacity=Tl,
                               layer=layer)
        else:
            out = world.run(xs, tis, tws, expert_fn=global_expert_fn,
                            layer=layer)
        self.last_world = world
        flat = np.asarray(tis).reshape(-1)
        load_phys = np.bincount(flat[flat >= 0], minlength=E_phys).astype(
            np.int32)
        return DispatchResult(
            out.reshape(T, D),
            {"dropped": np.float32(0.0), "load_phys": load_phys,
             "imbalance": np.float32(_load_imbalance(load_phys))})

    # per-step counters aggregated by dispatch_step (exact-gated rows)
    _STEP_COUNTERS = ("drains_per_step", "cmds_per_step",
                      "dispatch_payload_bytes", "dispatch_wire_bytes",
                      "dispatch_msgs")
    # ibv_reg_mr page-pin cost, us per 4 KiB page — the per-call memory
    # registration a persistent session pays once instead of every call
    _PIN_US_PER_PAGE = 0.3

    def _rendezvous_us(self, R: int, ctrl_bytes: int) -> float:
        """Event-clock cost of the control-plane rendezvous a NON-session
        dispatch must run before payload flies: every receiver advertises
        its bucket layout (base addr + rkey + capacity per local expert,
        ``ctrl_bytes``) to every sender, then an ack barrier confirms all
        sides saw it.  Simulated with real control messages on a scratch
        :class:`Network` under the backend's own ``NetConfig`` (same
        latency/bandwidth/jitter model as the payload path), so the number
        scales with fabric parameters instead of being a magic constant.
        Persistent sessions run this ONCE at open (DESIGN §16/§18)."""
        key = (R, ctrl_bytes)
        cache = getattr(self, "_rdv_cache", None)
        if cache is None:
            cache = self._rdv_cache = {}
        v = cache.get(key)
        if v is not None:
            return v
        from repro_torch.core.transport.simulator import Message, Network
        net = Network(self.net_cfg, R, threadsafe=False)
        for r in range(R):
            net.register(r, lambda m: None)
        for phase_bytes in (ctrl_bytes, 8):      # advertise, then ack
            net.send_batch([
                Message(src=r, dst=s, qp=0, kind="write", dst_off=0,
                        payload=np.zeros(phase_bytes, np.uint8), imm=None)
                for r in range(R) for s in range(R) if s != r])
            while net.pending:
                net.deliver_ready()
        cache[key] = net.clock_us
        return net.clock_us

    def _setup_us(self, world) -> float:
        """Per-call session-open cost for ``world``'s geometry: pin+register
        the receive buckets and return region (page-granular, all ranks in
        parallel), then the advertisement rendezvous."""
        reg_bytes = (world.n_experts * world.capacity * world.tok_bytes
                     + world.capacity * world.top_k * world.d * 4)
        reg_us = -(-reg_bytes // 4096) * self._PIN_US_PER_PAGE
        ctrl = 64 + (world.n_experts // world.n_ranks) * 24
        return reg_us + self._rendezvous_us(world.n_ranks, ctrl)

    def dispatch_step(self, spec, xs, tis, tws, wg, wu, wd, *,
                      nonmoe_fwd_us: float = 0.0, mode: str = "pipelined"):
        """One full model step for a serving microbatch: ``L`` MoE layers
        worth of dispatch+combine on the event clock, with a non-MoE
        (attention/norm) compute segment of ``nonmoe_fwd_us`` ahead of each
        layer.  ``xs/tis/tws`` are length-``session_layers`` lists of
        ``(T, D)`` / ``(T, K)`` arrays (``top_idx < 0`` rows are padding and
        move no traffic); ``wg/wu/wd`` are the shared per-expert FFN weights.

        ``mode`` selects the step runner — the serving A/B switch:

        - ``"pipelined"`` — persistent session, all layers' command streams
          prepared up front, rank-local cross-layer overlap, ONE quiesce
          drain per step (``EPWorld.run_step_pipelined``);
        - ``"serial"`` — same persistent session, layer-serialized drains
          (isolates the cross-layer contribution);
        - ``"per_layer"`` — the naive comparator: a FRESH non-session world
          per layer (registration, guard tables and buckets rebuilt each
          call), clocks summed across layers.  Per-expert overlap stays ON
          inside every layer in all three modes.

        Returns ``(outs, elapsed_us, stats)``: per-layer ``(T, D)`` outputs,
        the step's event-clock span (including the L non-MoE segments), and
        the aggregated per-step transport counters.
        """
        from repro_torch.core.transport.ep_executor import EPWorld

        assert spec.mode == "ll", "serving decode dispatch is LL-mode"
        assert getattr(spec, "placement", None) is None, \
            "dispatch_step takes pre-translated physical routing tables"
        assert mode in ("pipelined", "serial", "per_layer"), mode
        L = len(xs)
        assert len(tis) == L and len(tws) == L and L > 0
        x0 = np.asarray(xs[0], np.float32)
        T, D = x0.shape
        R = spec.degree
        assert T % R == 0, f"token count {T} not divisible by EP degree {R}"
        Tl = T // R
        K = np.asarray(tis[0]).shape[1]
        E_phys = spec.n_experts
        wire_dtype = getattr(spec, "wire_dtype", "fp32")
        xs_r = [np.asarray(x, np.float32).reshape(R, Tl, D) for x in xs]
        tis_r = [np.asarray(t).reshape(R, Tl, K) for t in tis]
        tws_r = [np.asarray(w, np.float32).reshape(R, Tl, K) for w in tws]

        if mode == "per_layer":
            outs, elapsed = [], 0.0
            stats = dict.fromkeys(self._STEP_COUNTERS, 0)
            for l in range(L):
                world = EPWorld(n_ranks=R, n_experts=E_phys, top_k=K, d=D,
                                capacity=Tl * K, net_cfg=self.net_cfg,
                                n_channels=self.n_channels,
                                columnar=self.columnar,
                                coalesce=self.coalesce,
                                wire_dtype=wire_dtype)
                t0 = world.net.clock_us
                world.net.advance(nonmoe_fwd_us)
                # non-persistent dispatch: registration + rendezvous per
                # call (what the session amortizes to once at open)
                world.net.advance(self._setup_us(world))
                out = world.run(xs_r[l], tis_r[l], tws_r[l], wg, wu, wd)
                elapsed += world.net.clock_us - t0
                for k in self._STEP_COUNTERS:
                    stats[k] += int(world.timeline.get(k, 0))
                outs.append(out.reshape(T, D))
                self.last_world = world
            return outs, elapsed, stats

        assert self.session_layers == L, \
            f"backend session_layers={self.session_layers} != {L} layers"
        skey = (spec.mode, R, E_phys, K, D, Tl, spec.chunks, wire_dtype)
        world = self._sessions.get(skey)
        opened = world is None
        if opened:
            world = EPWorld(n_ranks=R, n_experts=E_phys, top_k=K, d=D,
                            capacity=Tl * K, net_cfg=self.net_cfg,
                            n_channels=self.n_channels,
                            columnar=self.columnar, coalesce=self.coalesce,
                            wire_dtype=wire_dtype, session=True,
                            n_layers=L, mirror=self.session_mirror)
            self._sessions[skey] = world
        world.begin_step()
        t0 = world.net.clock_us
        if opened:
            # session open: registration + rendezvous ONCE, charged to the
            # first step (the naive path re-pays it every layer, every step)
            world.net.advance(self._setup_us(world))
        world.net.advance(nonmoe_fwd_us)     # leading non-MoE segment
        runner = (world.run_step_pipelined if mode == "pipelined"
                  else world.run_step_serial)
        outs = runner(xs_r, tis_r, tws_r, wg, wu, wd,
                      nonmoe_fwd_us=nonmoe_fwd_us)
        elapsed = world.net.clock_us - t0
        assert not world.net.pending, "step ended with traffic in flight"
        stats = {k: int(world.timeline.get(k, 0))
                 for k in self._STEP_COUNTERS}
        self.last_world = world
        self._layer_cursor = 0
        return [o.reshape(T, D) for o in outs], elapsed, stats
