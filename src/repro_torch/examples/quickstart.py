"""Quickstart: UCCL-EP dispatch/combine over a rank-stacked world.

Runs the paper's two EP modes (LL one-shot, HT dedup + hierarchical) over
a (pod 2, model 4) world of 8 ranks and checks both against the dense MoE
oracle ``moe_ref``, as the reference's ``examples/quickstart.py`` does on
8 CPU devices.

  python -m repro_torch.examples.quickstart [--device cpu]

On the CPU everything is fp32 and the experts run through the kernels'
plain versions: each mode within the reference's 1e-4 of the oracle.  On
the card the tokens and weights are bf16 and the experts run through the
hand-written kernels (``grouped_swiglu`` for LL, ``gather_swiglu_scatter``
for HT): each mode within ``CARD_TOL`` of the oracle's largest output.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core.ep import (EPSpec, dispatch_combine_ht,
                                 dispatch_combine_ll, moe_ref)
from repro_torch.core.moe import expert_fn

CPU_TOL = 1e-4
# the expert kernels agree with their plain versions within 1e-2
# (grouped_swiglu) and 5e-3 (gather_swiglu_scatter) of the output's range,
# and the combined output rounds to bf16 once more (2^-8 of a value)
CARD_TOL = 2e-2


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    dtype = torch.float32 if dev.type == "cpu" else torch.bfloat16

    E, K, D, F, T = 16, 3, 64, 96, 128
    axes, sizes = ("pod", "model"), (2, 4)
    R = 8
    g = torch.Generator().manual_seed(0)
    x = torch.randn((T, D), generator=g)
    top_idx = torch.randint(0, E, (T, K), generator=g, dtype=torch.int32)
    top_w = torch.softmax(torch.randn((T, K), generator=g), dim=-1)
    wg, wu = (torch.randn((E, D, F), generator=g) * 0.1 for _ in range(2))
    wd = torch.randn((E, F, D), generator=g) * 0.1
    x, wg, wu, wd = (t.to(dev, dtype) for t in (x, wg, wu, wd))
    top_idx, top_w = top_idx.to(dev), top_w.to(dev)

    ref = moe_ref(x, top_idx, top_w, wg, wu, wd).float()
    scale = float(ref.abs().max())
    fn = expert_fn(wg, wu, wd)
    errs = {}
    for mode, dispatch in [("LL (one-shot, decode)", dispatch_combine_ll),
                           ("HT (dedup + hierarchical, train)",
                            dispatch_combine_ht)]:
        spec = EPSpec(axes=axes, sizes=sizes, n_experts=E, top_k=K,
                      capacity_factor=4.0, chunks=2 if "HT" in mode else 1,
                      dtype=dtype)
        # T tokens over the 8 ranks, T / 8 each, in rank order
        with torch.no_grad():
            r = dispatch(spec, x.reshape(R, T // R, D),
                         top_idx.reshape(R, T // R, K),
                         top_w.reshape(R, T // R, K), fn)
        out = r.out.reshape(T, D).float()
        err = float((out - ref).abs().max())
        dropped = float(r.aux["dropped"].float().mean())
        tol = CPU_TOL if dev.type == "cpu" else CARD_TOL * scale
        print(f"{mode:36s} max|err| vs oracle = {err:.2e} (limit "
              f"{tol:.2e})  dropped = {dropped:.3f}")
        assert err < tol, "EP output diverged from the oracle"
        errs[mode.split()[0]] = err
    print("quickstart OK")
    return {"max_abs_err": errs, "oracle_max": scale}


if __name__ == "__main__":
    main()
