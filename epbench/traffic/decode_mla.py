"""Closed-loop LL decode of an MLA model (Moonlight-16B-A3B): the loop of
``decode.py`` (one client, back-to-back cycles of ``batch`` requests,
each request's ``prompt_len`` tokens from the seed through the captured
decode step, then ``gen_len`` greedy tokens, every step's tokens copied
to the host), with the MLA model's weights (``weights_mla.py``), its
reference (``reference/mla.py``) and its bounds (``roofline_mla.py``).

Metrics: ``decode_tokens_per_s`` and ``itl_p95_ms`` as ``decode.py``
takes them.  Checks, each with the fp8 control beside it when asked:

- ``mean_gap`` over every request of a finished cycle drawn from the
  seed, teacher-forced through the plain reference in its non-absorbed
  form (``checks.py``'s gaps);
- ``latent_err``: the latent rows the window's cache holds (the cycle the
  window closed in, every request, every position written) in the layers
  up to the first MoE layer's output (``row_layers``), each row's
  relative error against the reference's on the same tokens; the largest
  over those layers of the rows' ``ROW_QUANTILE`` quantile.  No routing
  choice comes before these rows but the first MoE layer's, whose flips
  (a token's 6th and 7th scores a rounding apart) move few rows, under
  the quantile; so depth does not amplify it as it does ``mean_gap``.

A traced run also records, over its slice, each device kernel's time by
name (the absorbed-MLA kernel's, the summed device
time) and, in one instrumented step after it, the EP kernels' frozen
bounds (``trace.recording``); the MLA kernel's bound comes from the
slice's positions (``roofline_mla.mla_kernel_bound``).
"""
from __future__ import annotations

import dataclasses
import time

import torch

from epbench import checks, roofline_mla, trace, weights_mla
from epbench.common import mix_seed, quantile
from epbench.reference import mla as R
from epbench.traffic.decode import prompts

# a fragment of the absorbed-MLA decode kernel's device name
MLA_KERNEL = "mla_decode_kernel"
# ``latent_err``'s quantile over the rows of a layer
ROW_QUANTILE = 0.9


def row_layers(cfg) -> int:
    """The layers whose latent rows ``latent_err`` reads: the dense ones,
    the first MoE layer, and the one after it, which reads that layer's
    output."""
    return cfg.first_k_dense + 2


def kernel_seconds(prof, steps: int) -> dict:
    """{device kernel name: its device seconds over the slice}, counted as
    ``trace.summarize`` counts them (a kernel every step launches the same
    number of times is counted at that number, at the mean time of the
    records kept)."""
    from torch.autograd import DeviceType
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            c = by_name.setdefault(e.name, [0, 0.0])
            c[0] += 1
            c[1] += (e.time_range.end - e.time_range.start) * 1e-6
    out = {}
    for n, (count, secs) in by_name.items():
        per_step = max(1, round(count / steps))
        out[n] = secs / count * per_step * steps
    return out


class MLASlice(trace.Slice):
    """``trace.Slice``, and the MLA kernel's and all kernels' summed
    device seconds (``mla_kernel_s``, ``device_sum_s``)."""

    def stop(self, steps: int, **extra):
        torch.cuda.synchronize()
        wall = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        self.result = trace.summarize(self.prof, wall, steps)
        secs = kernel_seconds(self.prof, steps)
        self.result["mla_kernel_s"] = sum(s for n, s in secs.items()
                                          if MLA_KERNEL in n)
        self.result["device_sum_s"] = sum(secs.values())
        self.result.update(extra)
        self.prof = None
        return self.result


def decode_gaps(params, seqs, P, sz, control: bool = False,
                block: int = 8):
    """``checks.decode_gaps`` through ``reference/mla.py``: the served
    tokens' gaps (B, L - P), and with ``control`` the gaps of the tokens
    the fp8 reference puts first."""
    B, L = seqs.shape
    got, low = [], []
    with checks.no_tf32(), torch.no_grad():
        h = R.hidden(params, seqs[:, :L - 1], sz, "ll")
        h_low = (R.hidden(params, seqs[:, :L - 1], sz, "ll", "fp8")
                 if control else None)
        for r in range(0, B, block):
            ref = R.head(params, h[r:r + block, P - 1:L - 1], sz)
            got.append(checks.gaps(ref, seqs[r:r + block, P:L]))
            if control:
                lo = R.head(params, h_low[r:r + block, P - 1:L - 1], sz,
                            "fp8")
                low.append(checks.gaps(ref, lo.argmax(-1)))
            del ref
    return torch.cat(got), (torch.cat(low) if control else None)


def row_errors(got, ref) -> list:
    """Per layer, the ``ROW_QUANTILE`` quantile over rows of |got - ref| /
    |ref|, each row (B, S, c + rope) a position's latent row."""
    out = []
    for g, r in zip(got, ref):
        e = (g.float() - r).norm(dim=-1) / r.norm(dim=-1).clamp_min(1e-30)
        out.append(float(torch.quantile(e.reshape(-1), ROW_QUANTILE)))
    return out


def latent_errors(params, seqs, rows, sz, control: bool = False):
    """The cached latent rows ``rows`` (one (B, S, c + rope) a layer, of
    token rows ``seqs`` (B, S)) against ``reference/mla.py``'s: the
    per-layer errors (``row_errors``), and with ``control`` the fp8
    reference's rows' against the same."""
    with checks.no_tf32(), torch.no_grad():
        ref = R.cache_rows(params, seqs, sz, len(rows), "ll")
        got = row_errors(rows, ref)
        low = (row_errors(R.cache_rows(params, seqs, sz, len(rows), "ll",
                                       "fp8"), ref) if control else None)
    return got, low


def run(ctx) -> dict:
    from repro_torch.distributed.sharding import make_dist_ctx
    from repro_torch.launch.serve import capture_decode_step
    from repro_torch.models import model_zoo as Z

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    sz = R.sizes(dataclasses.asdict(cfg), tr)
    B, P, G = tr["batch"], tr["prompt_len"], tr["gen_len"]
    L = P + G
    V = cfg.vocab_size
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    params = weights_mla.make_params(cfg, ctx.seed, dev, torch.bfloat16)
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
    prof = MLASlice() if (ctx.trace and on_card) else None
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
        n_rows = t + 1
        if not finished:
            for t2 in range(t + 1, L - 1):
                logits, _ = step(tok, t2)
                tok = torch.argmax(logits[:, :V], dim=-1)[:, None]
                out[:, t2 - (P - 1)] = tok[:, 0].cpu()
            finished.append((cycle, pr, out))
            n_rows = L - 1
        # the rows the cache holds now, of positions 0..n_rows - 1 of the
        # cycle last served, and their tokens; on the host, off the peak
        held = (torch.cat([pr, out.to(dev)], dim=1)[:, :n_rows].cpu(),
                [cache[i]["latent"][:, :n_rows].cpu()
                 for i in range(row_layers(cfg))])
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

    g = torch.Generator().manual_seed(mix_seed(ctx.seed, 7))
    c = int(torch.randint(0, len(finished), (1,), generator=g))
    _, pr, out = finished[c]
    seqs = torch.cat([pr, out.to(dev)], dim=1)              # (B, L)
    got, low = decode_gaps(params, seqs, P, sz, control=ctx.control)
    rows_got, rows_low = latent_errors(
        params, held[0].to(dev), [r.to(dev) for r in held[1]], sz,
        control=ctx.control)
    del held
    numbers = {**checks.decode_numbers(got), "latent_err": max(rows_got)}
    control = ({**checks.decode_numbers(low), "latent_err": max(rows_low)}
               if low is not None else None)
    rec = {"window_s": window, "tokens": tokens_done,
           "attempted": B * cycle, "failed": 0, "memory_peak": peak,
           "e2e": {"decode_tokens_per_s": tokens_done / window,
                   "itl_p95_ms": quantile(gaps, 0.95) * 1e3},
           "checks": numbers, "control": control,
           "check_detail": {
               "program": checks.gap_stats(got),
               "control": checks.gap_stats(low) if low is not None else None,
               "latent_rows": n_rows, "latent_err": rows_got,
               "control_latent_err": rows_low,
               "dropped": float(torch.stack(dropped).mean())},
           "batch": B, "cfg": cfg}
    if prof is not None:
        a, b = prof.result["positions"]
        rec["slice"] = prof.result
        rec["bound"] = {"per_step_s": bound["bound_s"],
                        "experts": bound["experts"]}
        rec["mla_bound_s"] = sum(
            cfg.n_layers * roofline_mla.mla_kernel_bound(
                B, cfg.n_heads, t, cfg.kv_lora_rank + cfg.qk_rope_head_dim,
                cfg.kv_lora_rank) for t in range(a, b + 1))
    return rec
