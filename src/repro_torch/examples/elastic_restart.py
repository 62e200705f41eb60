"""Elastic EP demo (paper §6 made concrete): train over an EP world of 4,
checkpoint, "lose" half the ranks, re-mesh to an EP world of 2, restore,
and keep training: the loss continues from where it left off.  The
counterpart of the reference's ``examples/elastic_restart.py`` (its
(data 2, model 4) mesh of 8 devices, then (2, 2): EP 4, then EP 2); on the
card (unless ``--device cpu``) the MoE layers run through
``gather_swiglu_scatter`` and its backward kernel, at 4 experts a rank and
then 8.

  python -m repro_torch.examples.elastic_restart [--device cpu]

As in the reference, the first loop runs ``STEPS // 2`` steps at EP 4
(60 of the reference's 120) and the second ``STEPS`` at EP 2 (120), on
the batches that follow the checkpoint (60-179): the second loop counts
its steps from 0, while the optimizer's step, which drives the
learning-rate schedule, carries on from the checkpoint in both.
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import DataConfig, data_iterator
from repro_torch.distributed.elastic import plan_remesh, reshard_state
from repro_torch.distributed.sharding import make_dist_ctx
from repro_torch.training.train_loop import HParams, init_state, train_loop

STEPS = 120


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    half = STEPS // 2

    cfg = reduced_config(get_config("moonshot_v1_16b_a3b"), n_layers=2,
                         d_model=128, n_experts=8, vocab=1024)
    hp = HParams(peak_lr=1e-3, total_steps=STEPS, warmup=10,
                 moe_mode="ht", loss_chunk=64)
    dc = DataConfig(vocab_size=cfg.vocab_size, batch=8, seq_len=64, seed=0)

    dist4 = make_dist_ctx(cfg, model=4)
    with tempfile.TemporaryDirectory() as td:
        ckpt = Checkpointer(td)
        print("[elastic] phase 1: EP world", dict(zip(dist4.axes,
                                                      dist4.sizes)))
        state, hist1 = train_loop(cfg, hp, dist4, data_iterator(dc),
                                  steps=half, checkpointer=ckpt,
                                  ckpt_every=max(half // 2, 1), log_every=20,
                                  device=args.device)
        ckpt.save(state, half)
        del state

        # "node failure": only 2 ranks remain -> re-mesh to EP 2
        dist2 = make_dist_ctx(cfg, model=2)
        plan = plan_remesh(cfg, dist4, dist2)
        print(f"[elastic] re-mesh {plan.old_shape} -> {plan.new_shape}; "
              f"EP {plan.ep_degree_old} -> {plan.ep_degree_new}; "
              f"{plan.notes}")
        restored, step = ckpt.restore_latest(
            init_state(cfg, seed=0, device=args.device))
        state2, dist2 = reshard_state(cfg, restored, dist2)
        state2, hist2 = train_loop(cfg, hp, dist2,
                                   data_iterator(dc, start_step=step),
                                   steps=STEPS, state=state2,
                                   log_every=20, device=args.device)
    l0, l1, l2 = hist1[0]["loss"], hist1[-1]["loss"], hist2[-1]["loss"]
    print(f"[elastic] loss: start={l0:.4f} before-failure={l1:.4f} "
          f"after-remesh-end={l2:.4f}")
    assert l2 <= l1 + 0.2, "training regressed after elastic re-mesh"
    print("[elastic] OK: training continued across the re-mesh")
    return {"plan": plan, "restored_step": step, "hist1": hist1,
            "hist2": hist2}


if __name__ == "__main__":
    main()
