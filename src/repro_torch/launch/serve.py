"""Serving launcher: batched HT prefill + greedy LL decode (the port of
``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_moe_a2_7b \\
      --mesh local --local-model-axis 4 --batch 4 --prompt-len 256 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_4b \\
      --batch 4 --prompt-len 2048 --gen 32

Runs on ``cuda`` unless ``--device cpu``.  Prefill and decode run their
norms and attention through the RMSNorm, flash attention and flash
decoding kernels, under ``torch.inference_mode()``.  With ``--mesh
local`` the MoE layers run expert parallel over a rank-stacked world of
``--local-model-axis`` ranks on the one device; the KV cache is local, so
prefill is one batched pass through the HT dispatch and decode goes token
by token through LL.  ``--mesh none`` runs the dense MoE oracle.
"""
from __future__ import annotations

import argparse
import dataclasses
import time


def generate(cfg, params, prompts, n_gen: int, *, dist=None) -> dict:
    """Prefill ``prompts`` (B, S) in one pass, then decode greedily until
    ``n_gen`` tokens per sequence exist.  Times on the host clock around
    work that ends in a device synchronise."""
    import torch

    from repro_torch.models import model_zoo as Z

    dev = prompts.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    B, S = prompts.shape
    max_len = S + n_gen
    cache = Z.init_cache(cfg, B, max_len, dtype=Z.compute_dtype(cfg),
                         device=dev)
    sync()
    t0 = time.perf_counter()
    # no gradients: the norm and attention kernels have no backward
    with torch.inference_mode():
        logits, cache, aux = Z.prefill(cfg, params, cache, prompts,
                                       dist=dist, moe_mode="ht")
        tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)[:, None]
        sync()
        t_first = time.perf_counter() - t0
        out, dropped = [tok], [aux["dropped"]]
        prefill_per_layer = aux["dropped_per_layer"]
        for t in range(S, max_len - 1):
            logits, cache, aux = Z.decode_step(cfg, params, cache, tok, t,
                                               dist=dist, moe_mode="ll")
            tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)[:, None]
            out.append(tok)
            dropped.append(aux["dropped"])
        sync()
    dt = time.perf_counter() - t0
    total = B * len(out)
    return {"tokens": torch.cat(out, dim=1), "logits": logits,
            "ttft_s": t_first, "total_s": dt, "tokens_per_s": total / dt,
            "decode_tokens_per_s": (B * (len(out) - 1) / (dt - t_first)
                                    if len(out) > 1 else None),
            "prefill_dropped": float(dropped[0]),
            "prefill_dropped_per_layer": prefill_per_layer.tolist(),
            "decode_dropped": (float(torch.stack(dropped[1:]).mean())
                               if len(dropped) > 1 else 0.0)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
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
    print(f"[serve] generated {n} tokens in {res['total_s']:.2f}s "
          f"({res['tokens_per_s']:.1f} tok/s, ttft "
          f"{res['ttft_s'] * 1e3:.0f}ms) on {device}, first sequence: "
          f"{res['tokens'][0, :8].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
