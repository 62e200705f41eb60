"""EP training: the port's ``make_train_step`` (HT over the rank-stacked
EP world, the fp32 wire, per-layer recompute, AdamW, the router-bias
rule) on a fresh batch of ``batch`` x ``seq_len`` random tokens, drawn
from the seed, every step.

Set-up builds the one train state from the seed's weights and drives it
through its first ``setup_steps`` steps through the window's own call and
feed; the window continues that same state.  Metric:
``train_tokens_per_s``, the tokens of the steps completed in the window
over the window.  Check: those first steps against the plain reference
(``epbench.reference.train``): each step's loss, the first gradient as
AdamW got it (its first moment after one step, over 1 - b1), and each
leaf's change over the steps (against the initial weights drawn again).
"""
from __future__ import annotations

import time

import torch

from epbench import checks, trace, weights
from epbench.common import mix_seed

BATCH_STREAM = 3000


def batch(seed: int, i: int, B: int, S: int, V: int, device) -> dict:
    g = torch.Generator(device=device).manual_seed(
        mix_seed(seed, BATCH_STREAM + i))
    t = torch.randint(0, V, (B, S + 1), generator=g, device=device)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def hparams(tr: dict) -> dict:
    return {"peak_lr": tr["peak_lr"], "warmup": tr["warmup"],
            "total_steps": tr["total_steps"], "b1": 0.9, "b2": 0.95,
            "weight_decay": 0.1, "max_grad_norm": 1.0,
            "router_bias_lr": 1e-3}


def run(ctx) -> dict:
    from repro_torch.distributed.sharding import make_dist_ctx
    from repro_torch.optim import adamw
    from repro_torch.training.train_loop import (HParams, TrainState,
                                                 make_train_step)

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    B, S, V = tr["batch"], tr["seq_len"], cfg.vocab_size
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    hp = hparams(tr)
    step_fn = make_train_step(cfg, HParams(
        peak_lr=hp["peak_lr"], warmup=hp["warmup"],
        total_steps=hp["total_steps"], weight_decay=hp["weight_decay"],
        b1=hp["b1"], b2=hp["b2"], max_grad_norm=hp["max_grad_norm"],
        moe_mode=tr.get("moe_mode", "ht"),
        router_bias_lr=hp["router_bias_lr"]),
        make_dist_ctx(cfg, model=tr["ep_world"]))
    params = weights.make_params(cfg, ctx.seed, dev, torch.float32)
    state = TrainState(params, adamw.init_state(params))

    n0 = tr["setup_steps"]
    prog, held, check_s = {"losses": []}, {}, 0.0
    for i in range(n0):
        state, m = step_fn(state, batch(ctx.seed, i, B, S, V, dev))
        prog["losses"].append(float(m["loss"]))
        prog.setdefault("gnorm", float(m["grad_norm"]))
        prog.setdefault("dropped", float(m["dropped"]))
        if i == 0:
            # the first gradient as AdamW got it: its first moment over
            # 1 - b1, kept on the host for the reference to compare; each
            # leaf's norm taken on the device, as the reference's is (the
            # host's fp32 norm of an expert leaf, 185M elements, reads
            # 2.6% low)
            sync()
            tc = time.perf_counter()
            held["first"], prog["grad_norms"] = {}, {}
            with torch.no_grad():
                for p, t in weights.leaves(state.opt.mu):
                    g = t / (1 - hp["b1"])
                    prog["grad_norms"][p] = float(g.norm())
                    held["first"][p] = g.cpu()
            check_s = time.perf_counter() - tc
    sync()
    tc = time.perf_counter()
    with torch.no_grad():
        cur = dict(weights.leaves(state.params))
        prog["change_norms"] = {
            p: float((cur[p].detach() - p0).norm())
            for p, p0 in weights.initial_leaves(cfg, ctx.seed, dev)}
        held["final"] = {p: t.detach().cpu() for p, t in cur.items()}
    sync()
    # the check's own records are not set-up
    ctx.setup_done(check_s + time.perf_counter() - tc)

    dropped, i = [], n0
    t0 = time.perf_counter()
    while True:
        state, m = step_fn(state, batch(ctx.seed, i, B, S, V, dev))
        float(m["loss"])
        te = time.perf_counter()
        dropped.append(m["dropped"])
        i += 1
        if te - t0 >= ctx.seconds:
            break
    window = te - t0
    steps = i - n0
    drop = float(torch.stack(dropped).mean())
    prof = bound = None
    if ctx.trace and on_card:
        # the traced slice after the window: a process the profiler has run
        # in issues its launches slower from then on
        prof = trace.Slice()
        n_slice = tr.get("trace_steps", 2)
        prof.start()
        for _ in range(n_slice):
            state, m = step_fn(state, batch(ctx.seed, i, B, S, V, dev))
            i += 1
        prof.stop(n_slice)
        with trace.recording() as rec:
            state, m = step_fn(state, batch(ctx.seed, i, B, S, V, dev))
            sync()
        bound = rec
    sync()
    peak = ctx.memory_peak()
    del state, params, cur, m
    ctx.free()

    batches = [batch(ctx.seed, j, B, S, V, dev) for j in range(n0)]
    initial = _Initial(cfg, ctx.seed, dev)
    pairs = [(b["tokens"], b["labels"]) for b in batches]
    low = (checks.train_reference(initial, pairs, ctx.sz, hp, n0,
                                  precision="fp8", keep=True)
           if ctx.control else None)
    ref = checks.train_reference(
        initial, pairs, ctx.sz, hp, n0,
        others=[held] + ([low.pop("tensors")] if low else []))
    del held
    numbers = checks.train_numbers(prog, ref)
    control = ({k: v for k, v in checks.train_numbers(low, ref, 1).items()
                if not k.startswith("_")} if low else None)
    rec = {"window_s": window, "attempted": steps, "failed": 0,
           "memory_peak": peak,
           "e2e": {"train_tokens_per_s": steps * B * S / window},
           "dropped_share": drop * 100.0,
           "checks": {k: v for k, v in numbers.items()
                      if not k.startswith("_")},
           "check_detail": {k: v for k, v in numbers.items()
                            if k.startswith("_")}, "control": control,
           "tokens_per_step": B * S, "cfg": cfg}
    if prof is not None:
        rec["slice"] = prof.result
        # a step's wall time in the window, which no profiler slowed
        rec["step_s"] = window / steps
        rec["bound"] = {"per_step_s": bound["bound_s"],
                        "experts": bound["experts"]}
    return rec


class _Initial:
    """The initial weights of the seed, drawn again: ``()`` a whole fp32
    tree, ``.leaves()`` one leaf at a time."""

    def __init__(self, cfg, seed, device):
        self.cfg, self.seed, self.device = cfg, seed, device

    def __call__(self):
        return weights.make_params(self.cfg, self.seed, self.device,
                                   torch.float32)

    def leaves(self):
        return weights.initial_leaves(self.cfg, self.seed, self.device)
