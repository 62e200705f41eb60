"""Serving launcher: batched HT prefill + greedy LL decode (the port of
``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_moe_a2_7b \\
      --mesh local --local-model-axis 4 --batch 4 --prompt-len 256 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_4b \\
      --batch 4 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon_mamba_7b \\
      --batch 4 --prompt-len 64 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen_large \\
      --batch 4 --prompt-len 1024 --gen 16

Every config of ``repro_torch.configs`` serves: the dense phi3_medium_14b,
qwen2_72b (72.7B parameters, 145 GB in bf16: one card serves it only
cut in depth, as ``chip_smoke.py`` does), qwen3_4b, qwen3_1_7b,
internvl2_26b and musicgen_large; the MoE qwen2_moe_a2_7b and moonshot_v1_16b_a3b; the
Mamba falcon_mamba_7b and the jamba hybrid.  internvl2-26b and
musicgen-large are served on text (codec) tokens alone, without their
frontend prefix, as the reference's launcher serves them.  On the card the
attention kernels take head dim 64 or 128 (a reduced config needs
``--d-model`` 256 or 512 with its 4 heads).

Runs on ``cuda`` unless ``--device cpu``.  Prefill and decode run their
norms and attention through the RMSNorm, flash attention and flash
decoding kernels, under ``torch.inference_mode()``.  On the card the
decode step is captured once in a CUDA graph and replayed for every
position (:func:`capture_decode_step`), as the reference jits it.  With ``--mesh
local`` the MoE layers run expert parallel over a rank-stacked world of
``--local-model-axis`` ranks on the one device, and, as in the reference,
whose cache is then sharded over the model axis, the prompt runs through
decode steps (LL) and no TTFT is reported; ``--mesh none`` prefills in one
batched pass (the MoE layers through the dense oracle).  A model with
Mamba layers (falcon-mamba, the jamba hybrid) always runs its prompt
through decode steps, as the reference's does: a batched prefill would
need the recurrent state after the prompt.  Decode goes token by token
through LL.

``--ep-backend simulated_rdma`` runs every MoE layer's dispatch and
combine over the host transport substrate (``repro_torch.core.transport``)
and its experts through the ``grouped_swiglu`` kernel on the card.  A host
backend reads device values on the host, which no CUDA graph can hold, so
``generate`` then decodes through the eager step.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional


WARMUP_STEPS = 2    # eager decode steps before a capture


def host_backend(cfg) -> bool:
    """True when ``cfg``'s MoE layers run a host backend (one that is not
    ``jit_compatible``), which reads device values on the host and so
    cannot run inside a captured CUDA graph."""
    if not cfg.moe.enabled:
        return False
    from repro_torch.core.backend import get_backend
    return not get_backend(cfg.moe.ep_backend).jit_compatible


class CapturedStep:
    """A decode step captured in a CUDA graph (:func:`capture_decode_step`):
    ``step(tok, t)`` copies ``tok`` and ``t`` into the static buffers,
    replays the graph, and returns clones of its static outputs ``(logits,
    aux)`` (the next replay overwrites them); ``replays`` counts the
    replays.  It holds no reference to itself, so the graph is destroyed
    when the last reference to the step goes, never by the cyclic garbage
    collector at some later moment, which may fall inside another
    capture: destroying a graph there invalidates that capture."""

    def __init__(self, graph, tok_s, pos_s, logits_s, aux_s):
        self.graph, self.tok_s, self.pos_s = graph, tok_s, pos_s
        self.logits_s, self.aux_s = logits_s, aux_s
        self.replays = 0

    def __call__(self, tok, t):
        import torch
        # the static buffers are inference tensors: written under its mode
        with torch.inference_mode():
            self.tok_s.copy_(tok)
            self.pos_s.fill_(t)
            self.graph.replay()
            self.replays += 1
            return self.logits_s.clone(), {k: v.clone()
                                           for k, v in self.aux_s.items()}


def capture_decode_step(cfg, params, cache, tokens, *, dist=None):
    """``Z.decode_step`` captured once in a CUDA graph: the port's
    counterpart of the reference's ``jax.jit(decode_step)``
    (repro/launch/serve.py:72).  The token (B, 1) and the position (a 0-d
    int32) live in static buffers, and ``cache`` is the graph's own: the
    caller fills it in place (the prefill writes ``cache[:, :S]``).  The
    warm-up steps (first launches, one-time kernel attributes, the
    allocator's growth) and the capture run at position 0 with
    ``tokens``, and so update the cache: a K/V row the prefill or the first
    decode step would write again, but also the Mamba layers' conv history
    and ssm state, which every step carries on.  So the cache is zeroed in
    place after the capture (``model_zoo.reset_cache``), as
    ``init_cache`` made it.

    Returns ``(step, captured)``: ``step`` a :class:`CapturedStep`,
    ``captured`` the launches one replay makes of each kernel.  A capture
    that fails raises."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import model_zoo as Z

    dev = tokens.device
    tok_s = tokens.clone()
    pos_s = torch.zeros((), dtype=torch.int32, device=dev)

    def run():
        logits, _, aux = Z.decode_step(cfg, params, cache, tok_s, pos_s,
                                       dist=dist, moe_mode="ll")
        return logits, aux

    # warm-up and capture on a side stream; not through torch.cuda.graph,
    # which empties the allocator's cache first, so that the prefill would
    # cudaMalloc its activations anew (TTFT)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        for _ in range(WARMUP_STEPS):
            run()
        side.synchronize()
        before = ops.launch_counts()
        graph.capture_begin()
        try:
            logits_s, aux_s = run()
        finally:
            graph.capture_end()
        Z.reset_cache(cache)
    torch.cuda.current_stream(dev).wait_stream(side)
    captured = {n: c - before[n] for n, c in ops.launch_counts().items()}
    return CapturedStep(graph, tok_s, pos_s, logits_s, aux_s), captured


def generate(cfg, params, prompts, n_gen, *, dist=None,
             batched_prefill: Optional[bool] = None,
             cuda_graph: Optional[bool] = None) -> dict:
    """Prefill ``prompts`` (B, S), then decode greedily until ``n_gen``
    tokens per sequence exist.  ``batched_prefill`` None takes the
    reference's rule (repro/launch/serve.py): one batched HT prefill unless
    the model has Mamba layers or ``dist`` has a model axis; otherwise the
    prompt runs through S - 1 LL decode steps, as the reference prefills
    its model-sharded cache, and there is no TTFT (``ttft_s`` None);
    ``prompt_s`` is the prompt's time either way.  True forces the batched
    prefill.

    ``cuda_graph`` None means yes on the card and no on the CPU: the decode
    step is captured once (:func:`capture_decode_step`) before the clock
    starts, reported as ``capture_s``, and replayed for every decode step,
    the per-token prefill's included; the prefill stays eager.  True on the
    CPU raises; False keeps the eager step.  With a host EP backend
    (:func:`host_backend`, e.g. ``simulated_rdma``) None means no, and True
    raises: the host path reads device values, which a capture cannot
    hold.  Times on the host clock around work that ends in a device
    synchronise."""
    import torch

    from repro_torch.models import model_zoo as Z

    dev = prompts.device
    on_host = host_backend(cfg)
    if cuda_graph is None:
        cuda_graph = dev.type == "cuda" and not on_host
    elif cuda_graph and on_host:
        raise ValueError(f"generate: cuda_graph=True with the host EP "
                         f"backend {cfg.moe.ep_backend!r}, which reads "
                         "device values on the host; a capture cannot hold "
                         "that (decode eagerly: cuda_graph=False)")
    elif cuda_graph and dev.type != "cuda":
        raise ValueError(f"generate: cuda_graph=True needs the prompts on a "
                         f"CUDA device, not {dev}")
    if batched_prefill is None:
        batched_prefill = not cfg.mamba.enabled and (
            dist is None or dist.model_axis is None)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    B, S = prompts.shape
    max_len = S + n_gen
    cache = Z.init_cache(cfg, B, max_len, dtype=Z.compute_dtype(cfg),
                         device=dev)
    capture_s = captured = None
    # no gradients: the norm and attention kernels have no backward
    with torch.inference_mode():
        if cuda_graph:
            sync()
            tc = time.perf_counter()
            step, captured = capture_decode_step(cfg, params, cache,
                                                 prompts[:, :1], dist=dist)
            sync()
            capture_s = time.perf_counter() - tc
        else:
            def step(tok, t):
                logits, _, aux = Z.decode_step(cfg, params, cache, tok, t,
                                               dist=dist, moe_mode="ll")
                return logits, aux
    sync()
    t0 = time.perf_counter()
    with torch.inference_mode():
        if batched_prefill:
            logits, cache, aux = Z.prefill(cfg, params, cache, prompts,
                                           dist=dist, moe_mode="ht")
            tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)[:, None]
            out, prefill = [tok], [aux]
            t_start = S
        else:
            tok, prefill = prompts[:, :1], []
            for t in range(S - 1):
                logits, aux = step(tok, t)
                tok = prompts[:, t + 1:t + 2]
                prefill.append(aux)
            out, t_start = [], S - 1
        sync()
        t_prompt = time.perf_counter() - t0
        dropped = []                 # the decode steps'
        for t in range(t_start, max_len - 1):
            logits, aux = step(tok, t)
            tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)[:, None]
            out.append(tok)
            dropped.append(aux["dropped"])
        sync()
    dt = time.perf_counter() - t0
    total = B * len(out)
    per_layer = (torch.stack([a["dropped_per_layer"] for a in prefill])
                 .mean(0).tolist() if prefill else [])
    return {"tokens": torch.cat(out, dim=1), "logits": logits,
            "ttft_s": t_prompt if batched_prefill else None,
            "prompt_s": t_prompt,
            "total_s": dt, "tokens_per_s": total / dt,
            "decode_tokens_per_s": (B * len(dropped) / (dt - t_prompt)
                                    if dropped else None),
            "batched_prefill": batched_prefill,
            "cuda_graph": cuda_graph, "capture_s": capture_s,
            "captured_launches": captured,
            "graph_replays": step.replays if cuda_graph else 0,
            "prefill_dropped": (float(torch.stack(
                [a["dropped"] for a in prefill]).mean()) if prefill else 0.0),
            "prefill_dropped_per_layer": per_layer,
            "decode_dropped": (float(torch.stack(dropped).mean())
                               if dropped else 0.0)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="a config of repro_torch.configs, e.g. "
                         "qwen2_moe_a2_7b, qwen3_4b, phi3_medium_14b, "
                         "qwen2_72b, internvl2_26b, musicgen_large, "
                         "falcon_mamba_7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--mesh", default="none", choices=["none", "local"])
    ap.add_argument("--local-model-axis", type=int, default=4)
    ap.add_argument("--ep-backend", default="",
                    help="EP transport backend; default: the config's")
    ap.add_argument("--wire-dtype", default="",
                    choices=["", "fp32", "fp8", "int8"],
                    help="dispatch wire payload dtype")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.distributed.sharding import make_dist_ctx
    from repro_torch.models import model_zoo as Z

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg, n_layers=args.layers, d_model=args.d_model,
                             vocab=args.vocab)
    moe_over = {}
    if args.ep_backend:
        moe_over["ep_backend"] = args.ep_backend
    if args.wire_dtype:
        moe_over["wire_dtype"] = args.wire_dtype
    if moe_over:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_over))
    dist = (make_dist_ctx(cfg, model=args.local_model_axis)
            if args.mesh == "local" else None)
    device = torch.device(args.device)
    params = Z.init_params(cfg, seed=args.seed, device=device,
                           dtype=Z.compute_dtype(cfg))
    gen = torch.Generator().manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen).to(device)
    res = generate(cfg, params, prompts, args.gen, dist=dist)
    n = res["tokens"].numel()
    ttft = (f", ttft {res['ttft_s'] * 1e3:.0f}ms"
            if res["ttft_s"] is not None else "")
    print(f"[serve] generated {n} tokens in {res['total_s']:.2f}s "
          f"({res['tokens_per_s']:.1f} tok/s{ttft}) on {device}, first "
          f"sequence: {res['tokens'][0, :8].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
