"""Training step and loop: the port of ``repro.training.train_loop``.
Autograd over the model, AdamW / factored updates, the aux-loss-free
router-bias rule, watchdog straggler flags, checkpoint-restore recovery.

The reference's XLA-only knobs have no counterpart: ``unroll`` (a Python
loop for cost extraction; the port always loops), ``sp_islands`` (shard_map
islands on a mesh) and ``remat_policy="dots"`` (an XLA checkpoint policy;
``cfg.remat`` recomputes each whole layer), and ``state_shardings`` (the
state's shardings over a mesh).  There is no ``jit``: a step
runs eagerly, so :func:`make_train_step` binds the step's configuration
and donates nothing (the step updates the state in place).
"""
from __future__ import annotations

import bisect
import time
from dataclasses import dataclass
from functools import partial
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.core.routing import RouterParams, update_aux_free_bias
from repro_torch.distributed.sharding import DistCtx
from repro_torch.models import model_zoo as Z
from repro_torch.optim import adamw
from repro_torch.optim.schedule import cosine_with_warmup


class TrainState(NamedTuple):
    params: dict
    opt: adamw.AdamWState


@dataclass(frozen=True)
class HParams:
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    max_grad_norm: float = 1.0
    moe_mode: str = "ht"            # "ht" | "ll" | "ref"
    moe_chunks: int = 1
    causal_skip: bool = False
    router_bias_lr: float = 1e-3
    loss_chunk: int = 2048
    seed: int = 0


def init_state(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> TrainState:
    """fp32 parameters from ``seed`` (leaves require grad) and a zero
    optimizer state."""
    if cfg.param_dtype != "float32":
        raise NotImplementedError(f"param_dtype {cfg.param_dtype!r}: the "
                                  "port keeps parameters in float32")
    params = Z.init_params(cfg, seed=seed, device=device)
    adamw.tree_map(lambda p: p.requires_grad_(True), params)
    return TrainState(params, adamw.init_state(
        params, factored=(cfg.optimizer == "adafactor")))


@torch.no_grad()
def _update_router_biases(cfg: ModelConfig, params: dict, loads: dict,
                          lr: float) -> dict:
    """Aux-loss-free balancing: sign-rule bias update per MoE layer (in
    place); ``loads`` maps a layer index to its (E_pad,) expert loads."""
    if not cfg.moe.enabled or lr == 0.0:
        return params
    for i, load in loads.items():
        moe_p = params["blocks"][i].get("moe")
        if moe_p is None or "router_b" not in moe_p:
            continue
        rp = RouterParams(moe_p["router_w"], moe_p["router_b"])
        moe_p["router_b"].copy_(update_aux_free_bias(
            rp, load, cfg.moe.n_experts, lr).bias)
    return params


def _batch_to(batch: dict, device) -> dict:
    """tokens and labels as int64, and ``prefix`` (frontend embeddings,
    where the batch has them) as fp32, on ``device``."""
    out = {k: torch.as_tensor(batch[k], device=device).to(torch.int64)
           for k in ("tokens", "labels")}
    prefix = batch.get("prefix")
    out["prefix"] = (None if prefix is None else torch.as_tensor(
        prefix, device=device).to(torch.float32))
    return out


def train_step(cfg: ModelConfig, hp: HParams, dist: Optional[DistCtx],
               state: TrainState, batch: dict) -> tuple[TrainState, dict]:
    """One optimizer step: ``loss.backward()``, then AdamW, then the
    router-bias update.  ``batch``: tokens (B, S) and labels (B, S), and
    for a model with a frontend prefix (B, P, D) embeddings ``prefix``, as
    numpy arrays or tensors.  The parameters and the optimizer moments are
    updated in place.  The spans ``train.step`` and, inside it,
    ``train.forward``, ``train.backward``, ``train.optimizer`` (clipping
    included) and ``train.router_bias`` time its phases
    (``repro_torch.tracing``)."""
    with tracing.span("train.step"):
        params = state.params
        b = _batch_to(batch, params["embed"].device)
        leaves = adamw.tree_leaves(params)
        for p in leaves:
            p.grad = None
        with tracing.span("train.forward"):
            loss, metrics = Z.loss_fn(
                cfg, params, b["tokens"], b["labels"], b["prefix"],
                dist=dist, moe_mode=hp.moe_mode, moe_chunks=hp.moe_chunks,
                causal_skip=hp.causal_skip, loss_chunk=hp.loss_chunk)
        with tracing.span("train.backward"):
            loss.backward()
        with tracing.span("train.optimizer"):
            # a parameter outside the graph (the routers' selection-only
            # bias) has a zero gradient, as under jax.grad
            grads = adamw.tree_map(lambda p: p.grad if p.grad is not None
                                   else torch.zeros_like(p), params)
            lr = cosine_with_warmup(state.opt.step, peak_lr=hp.peak_lr,
                                    warmup=hp.warmup, total=hp.total_steps)
            params, opt, om = adamw.apply_updates(
                params, grads, state.opt, lr=lr, b1=hp.b1, b2=hp.b2,
                weight_decay=hp.weight_decay,
                factored=(cfg.optimizer == "adafactor"),
                max_grad_norm=hp.max_grad_norm)
            del grads
            for p in leaves:
                p.grad = None
        with tracing.span("train.router_bias"):
            params = _update_router_biases(cfg, params, metrics.pop("loads"),
                                           hp.router_bias_lr)
        out = {"loss": loss.detach(), "lr": lr, **om,
               **{k: v.detach() for k, v in metrics.items()}}
        return TrainState(params, opt), out


def make_train_step(cfg: ModelConfig, hp: HParams,
                    dist: Optional[DistCtx]) -> Callable:
    """``step(state, batch) -> (state, metrics)``: :func:`train_step` with
    its configuration bound (the reference jits this partial)."""
    return partial(train_step, cfg, hp, dist)


@dataclass
class WatchdogEvent:
    step: int
    elapsed: float
    kind: str       # "straggler" | "failure"


class Watchdog:
    """Per-step wall-clock watermarking: flags stragglers (steps slower than
    ``straggler_factor`` x the running median) and failures (a step over
    the deadline)."""

    def __init__(self, deadline_s: float = 600.0, straggler_factor: float = 2.0):
        self.deadline = deadline_s
        self.factor = straggler_factor
        self.history: list[float] = []   # arrival-order window (<= 100)
        self._sorted: list[float] = []   # same window, kept sorted
        self.events: list[WatchdogEvent] = []

    def observe(self, step: int, elapsed: float) -> Optional[WatchdogEvent]:
        ev = None
        if elapsed > self.deadline:
            ev = WatchdogEvent(step, elapsed, "failure")
        elif self.history:
            med = self._sorted[len(self._sorted) // 2]
            if elapsed > self.factor * med and len(self.history) >= 5:
                ev = WatchdogEvent(step, elapsed, "straggler")
        self.history.append(elapsed)
        bisect.insort(self._sorted, elapsed)
        if len(self.history) > 100:
            oldest = self.history.pop(0)
            del self._sorted[bisect.bisect_left(self._sorted, oldest)]
        if ev:
            self.events.append(ev)
        return ev


def train_loop(cfg: ModelConfig, hp: HParams, dist, data, *,
               steps: int, state: Optional[TrainState] = None,
               checkpointer=None, ckpt_every: int = 0,
               log_every: int = 10, watchdog: Optional[Watchdog] = None,
               fail_injector: Optional[Callable[[int], bool]] = None,
               log_fn: Callable[[str], None] = print,
               device="cuda") -> tuple[TrainState, list]:
    """Fault-tolerant loop: on an injected failure, restore the latest
    checkpoint and continue.  ``data``: ``fn(step) -> batch`` (a replayed
    step re-reads the same batch) or an iterator.  A new state is made on
    ``device`` from ``hp.seed`` unless ``state`` is given.  Step times are
    host clock around work that ends in a device synchronise."""
    dev = (torch.device(device) if state is None
           else state.params["embed"].device)
    if state is None:
        state = init_state(cfg, seed=hp.seed, device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if callable(data) and not hasattr(data, "__next__"):
        get_batch = data
    else:
        it = iter(data)
        get_batch = lambda s: next(it)  # noqa: E731
    step_fn = make_train_step(cfg, hp, dist)
    start = 0
    if checkpointer is not None:
        restored = checkpointer.restore_latest(state)
        if restored is not None:
            state, start = restored
            log_fn(f"[train] restored checkpoint at step {start}")
    history = []
    step = start
    while step < steps:
        t0 = time.perf_counter()
        if fail_injector is not None and fail_injector(step):
            log_fn(f"[train] simulated failure at step {step}; recovering")
            assert checkpointer is not None, "failure without checkpointing"
            restored = checkpointer.restore_latest(state)
            if restored is not None:
                state, step = restored
            # a fresh step, as the reference builds a fresh executable
            step_fn = make_train_step(cfg, hp, dist)
            continue
        state, metrics = step_fn(state, get_batch(step))
        sync()
        elapsed = time.perf_counter() - t0
        if watchdog is not None:
            ev = watchdog.observe(step, elapsed)
            if ev is not None:
                log_fn(f"[watchdog] {ev.kind} at step {ev.step}: {ev.elapsed:.2f}s")
        if log_every and step % log_every == 0:
            log_fn(f"[train] step={step} loss={float(metrics['loss']):.4f} "
                   f"xent={float(metrics['xent']):.4f} "
                   f"gnorm={float(metrics['grad_norm']):.3f} "
                   f"({elapsed*1e3:.0f} ms)")
        history.append({k: float(v) for k, v in metrics.items()
                        if v.dim() == 0})
        step += 1
        if checkpointer is not None and ckpt_every and step % ckpt_every == 0:
            checkpointer.save(state, step)
    return state, history
