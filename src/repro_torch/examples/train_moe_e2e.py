"""End-to-end example: train a ~100M-parameter MoE LM for a few hundred
steps with the HT (dedup + hierarchical) EP path over a rank-stacked EP
world of 4, with checkpoints, the watchdog, and a mid-run injected failure
that recovers from the checkpoint.  The counterpart of the reference's
``examples/train_moe_e2e.py``; on the card (unless ``--device cpu``) the
MoE layers run through ``gather_swiglu_scatter`` and its backward kernel.

  python -m repro_torch.examples.train_moe_e2e [--steps 200] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
from functools import partial

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.distributed.fault import FailureInjector
from repro_torch.distributed.sharding import make_dist_ctx
from repro_torch.training.train_loop import HParams, Watchdog, train_loop

# ~100M params: 4 layers, d=512, 8 experts of f=1024, vocab 8192
MODEL = dict(n_layers=4, d_model=512, n_experts=8, vocab=8192,
             d_expert=1024)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    kw = dict(MODEL)
    d_expert = kw.pop("d_expert")
    cfg = reduced_config(get_config("moonshot_v1_16b_a3b"), **kw)
    cfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, d_expert=d_expert, top_k=2))
    n = cfg.param_count()
    print(f"[e2e] model: {n/1e6:.1f}M params "
          f"({cfg.active_param_count()/1e6:.1f}M active), "
          f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k}")

    dist = make_dist_ctx(cfg, model=4)
    print(f"[e2e] world: {dict(zip(dist.axes, dist.sizes))}, "
          f"EP axes: {dist.ep_axes}")

    hp = HParams(peak_lr=1e-3, total_steps=args.steps, warmup=20,
                 moe_mode="ht", moe_chunks=1, loss_chunk=args.seq)
    dc = DataConfig(vocab_size=cfg.vocab_size, batch=args.batch,
                    seq_len=args.seq, seed=0)
    with tempfile.TemporaryDirectory() as td:
        ckpt = Checkpointer(td, keep=2)
        injector = FailureInjector(at_steps=(args.steps // 2,))
        watchdog = Watchdog()
        state, hist = train_loop(
            cfg, hp, dist, partial(synth_batch, dc), steps=args.steps,
            checkpointer=ckpt, ckpt_every=25, log_every=20,
            watchdog=watchdog, fail_injector=injector, device=args.device)
    losses = [h["loss"] for h in hist]
    print(f"[e2e] loss: first={losses[0]:.4f} last={losses[-1]:.4f}")
    assert losses[-1] < losses[0] - 0.3, "loss did not decrease"
    assert injector.fired, "the injected failure did not fire"
    print("[e2e] OK: loss decreased and failure recovery exercised")
    return {"losses": losses, "steps_run": len(hist),
            "step_seconds": list(watchdog.history)}


if __name__ == "__main__":
    main()
