"""Closed-loop LL decode: one client, back-to-back cycles of ``batch``
requests.  Each request's ``prompt_len`` tokens, drawn from the seed, go
through the captured decode step (the per-token prefill the port's
``generate`` runs under a model axis), then ``gen_len`` greedy tokens
follow; every step's tokens are copied to the host, as a streaming server
sends them.  The decode step is the port's ``model_zoo.decode_step``,
captured once in a CUDA graph (``launch.serve.capture_decode_step``) and
replayed; ``model_zoo.reset_cache`` runs between cycles.

Metrics: ``decode_tokens_per_s``, the generated tokens that reached the
host in the window over the window; ``itl_p95_ms``, the 95th percentile
over every generated token of the gap since its sequence's previous
token.  Check: every request of a finished cycle drawn from the seed,
teacher-forced through the plain reference; the number is the mean gap
by which a served token's logit lies below the reference's best, in
units of that position's logit spread (``checks.py``).
"""
from __future__ import annotations

import time

import torch

from epbench import checks, trace, weights
from epbench.common import mix_seed, quantile

PROMPT_STREAM = 1000


def prompts(seed: int, cycle: int, B: int, P: int, V: int, device):
    g = torch.Generator(device=device).manual_seed(
        mix_seed(seed, PROMPT_STREAM + cycle))
    return torch.randint(0, V, (B, P), generator=g, device=device)


def run(ctx) -> dict:
    from repro_torch.distributed.sharding import make_dist_ctx
    from repro_torch.launch.serve import capture_decode_step
    from repro_torch.models import model_zoo as Z

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    B, P, G = tr["batch"], tr["prompt_len"], tr["gen_len"]
    L = P + G
    V = cfg.vocab_size
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    params = weights.make_params(cfg, ctx.seed, dev, torch.bfloat16)
    dist = make_dist_ctx(cfg, model=tr["ep_world"])
    cache = Z.init_cache(cfg, B, L, dtype=torch.bfloat16, device=dev)
    first = prompts(ctx.seed, 0, B, P, V, dev)
    with torch.inference_mode():
        if on_card:
            step, _ = capture_decode_step(cfg, params, cache, first[:, :1],
                                          dist=dist)
        else:
            def step(tok, t):
                logits, _, aux = Z.decode_step(cfg, params, cache, tok, t,
                                               dist=dist, moe_mode="ll")
                return logits, aux
        # the window's shapes once: a replay, the argmax, the copy out
        for t in range(tr.get("warm_steps", 2)):
            logits, _ = step(first[:, t:t + 1], t)
            torch.argmax(logits[:, :V], dim=-1).cpu()
        Z.reset_cache(cache)
    sync()
    ctx.setup_done()

    n_slice = tr.get("trace_steps", 16)
    slice_at = min(tr.get("trace_at", 256), L - 1 - n_slice)
    prof = trace.Slice() if (ctx.trace and on_card) else None
    tokens_done, gaps, arrivals, dropped = 0, [], [], []
    finished: list = []        # (prompts, generated) of finished cycles
    cycle, stop = 0, False
    t0 = time.perf_counter()
    with torch.inference_mode():
        while not stop:
            pr = first if cycle == 0 else prompts(ctx.seed, cycle, B, P, V,
                                                  dev)
            if cycle:
                Z.reset_cache(cache)
            out = torch.empty((B, G), dtype=torch.int64)
            tok, last = pr[:, :1], None
            for t in range(L - 1):
                if prof is not None and cycle == 0 and t == slice_at:
                    prof.start()
                logits, aux = step(tok, t)
                dropped.append(aux["dropped"])
                if t < P - 1:
                    tok = pr[:, t + 1:t + 2]
                else:
                    tok = torch.argmax(logits[:, :V], dim=-1)[:, None]
                    out[:, t - (P - 1)] = tok[:, 0].cpu()
                    now = time.perf_counter()
                    tokens_done += B
                    if last is not None:
                        gaps.append(now - last)
                    last = now
                    arrivals.append(now)
                if prof is not None and cycle == 0 and t == slice_at + \
                        n_slice - 1:
                    prof.stop(n_slice, positions=[slice_at, slice_at
                                                  + n_slice - 1])
                if (gaps and time.perf_counter() - t0 >= ctx.seconds
                        and (prof is None or prof.result is not None)):
                    stop = True
                    break
            if not stop:
                finished.append((cycle, pr, out))
            cycle += 1
        t_end = arrivals[-1]
        window = t_end - t0
        # the sample's cycle must be whole: finish the first if the window
        # closed inside it (untimed)
        if not finished:
            for t2 in range(t + 1, L - 1):
                # t2 >= P: the window closed after the first served token
                logits, _ = step(tok, t2)
                tok = torch.argmax(logits[:, :V], dim=-1)[:, None]
                out[:, t2 - (P - 1)] = tok[:, 0].cpu()
            finished.append((cycle, pr, out))
        bound = None
        if prof is not None:
            with trace.recording() as rec:
                pos = torch.full((), L - 2, dtype=torch.int32, device=dev)
                Z.decode_step(cfg, params, cache, tok, pos, dist=dist,
                              moe_mode="ll")
                sync()
            bound = rec
    sync()
    peak = ctx.memory_peak()
    del step, cache
    ctx.free()

    # the check: every request of a finished cycle, the cycle drawn from
    # the seed
    g = torch.Generator().manual_seed(mix_seed(ctx.seed, 7))
    c = int(torch.randint(0, len(finished), (1,), generator=g))
    _, pr, out = finished[c]
    seqs = torch.cat([pr, out.to(dev)], dim=1)              # (B, L)
    got, low = checks.decode_gaps(params, seqs, P, ctx.sz,
                                  control=ctx.control)
    control = checks.decode_numbers(low) if low is not None else None
    rec = {"window_s": window, "tokens": tokens_done,
           "attempted": B * cycle, "failed": 0, "memory_peak": peak,
           "e2e": {"decode_tokens_per_s": tokens_done / window,
                   "itl_p95_ms": quantile(gaps, 0.95) * 1e3},
           "checks": checks.decode_numbers(got), "control": control,
           "check_detail": {
               "program": checks.gap_stats(got),
               "control": checks.gap_stats(low) if low is not None else None,
               "dropped": float(torch.stack(dropped).mean())},
           "batch": B, "cfg": cfg}
    if prof is not None:
        rec["slice"] = prof.result
        rec["bound"] = {"per_step_s": bound["bound_s"],
                        "experts": bound["experts"]}
    return rec
