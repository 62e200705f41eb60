"""Training launcher (the port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch falcon_mamba_7b \\
      --reduced --steps 20 --batch 4 --seq 64 --device cpu

Runs on ``cuda`` unless ``--device cpu``.  ``--reduced`` runs the
family-faithful small config (``--layers``, ``--d-model``, ``--vocab``
act only with it); without it the published config trains as it is.
``--mesh none`` runs MoE layers through the dense oracle; ``--mesh local``
runs them expert parallel over a rank-stacked world of
``--local-model-axis`` ranks (``--moe-mode ht`` or ``ll``, ``--wire-dtype``),
on the card through the EP kernels and their backward kernels:

  python -m repro_torch.launch.train --arch qwen2_moe_a2_7b --reduced \\
      --mesh local --local-model-axis 4 --steps 20 --batch 4 --seq 64

A model with a frontend prefix (internvl2-26b, musicgen-large) trains on
batches that carry ``frontend_prefix`` stub embeddings before the tokens,
as the reference's launcher builds them.  The reference's TPU mesh
choices (``single``, ``multi``) and its ``--xla-pipelining`` preset
(``XLA_PIPELINING_FLAGS``, ``apply_xla_pipelining_flags``: XLA's GPU
latency-hiding flags) have no counterpart on one card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--moe-mode", default="ht", choices=["ht", "ll", "ref"])
    ap.add_argument("--moe-chunks", type=int, default=1)
    ap.add_argument("--ep-backend", default="",
                    help="EP transport backend; default: the config's")
    ap.add_argument("--wire-dtype", default="",
                    choices=["", "fp32", "fp8", "int8"],
                    help="dispatch wire payload dtype")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="none", choices=["none", "local"])
    ap.add_argument("--local-model-axis", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fail-at", default="",
                    help="comma-separated steps to inject failures (demo)")
    ap.add_argument("--history-out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.pipeline import DataConfig, data_iterator
    from repro_torch.distributed.fault import FailureInjector
    from repro_torch.distributed.sharding import make_dist_ctx
    from repro_torch.training.train_loop import HParams, Watchdog, train_loop

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

    hp = HParams(peak_lr=args.lr, total_steps=args.steps,
                 warmup=max(1, args.steps // 10), moe_mode=args.moe_mode,
                 moe_chunks=args.moe_chunks, seed=args.seed)
    dc = DataConfig(vocab_size=cfg.vocab_size, batch=args.batch,
                    seq_len=args.seq, seed=args.seed,
                    prefix_len=cfg.frontend_prefix, d_model=cfg.d_model)
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    injector = None
    if args.fail_at:
        injector = FailureInjector(tuple(int(s) for s in
                                         args.fail_at.split(",")))
    state, history = train_loop(
        cfg, hp, dist, data_iterator(dc), steps=args.steps,
        checkpointer=ckpt, ckpt_every=args.ckpt_every,
        log_every=args.log_every, watchdog=Watchdog(),
        fail_injector=injector, device=args.device)
    if args.history_out:
        Path(args.history_out).write_text(json.dumps(history))
    first = history[0]["loss"] if history else float("nan")
    last = history[-1]["loss"] if history else float("nan")
    print(f"[train] finished: loss {first:.4f} -> {last:.4f} "
          f"over {len(history)} steps")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
