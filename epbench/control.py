"""Read a cell's compared numbers over many seeds in one process, with the
control beside each: the program's reading (the lower end of a limit),
the reference in fp8 in the program's place (the upper end), and, with
``--fault``, the program with one fault planted (``epbench/faults.py``).
``--plain`` runs the named kernels as the port's plain PyTorch versions
(autograd differentiating them), a second witness beside the CUDA
kernels; ``--dtype`` sets the port's compute dtype (``float32``: the
program's arithmetic, less its bf16 rounding).  The benchmark's own runs
never run this.

  python3 epbench/control.py --workload <cell> --seeds 1,2,3 \\
      [--seconds 2] [--fault NAME] [--plain gather_swiglu_scatter] \\
      [--out chiprun_out/x.jsonl]

One JSON line a seed: the cell, the seed, the fault, the program's
numbers, the control's, the end-to-end metrics and the set-up time.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from epbench import common  # noqa: E402
from epbench import run as R  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", default="")
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--plain", default="")
    ap.add_argument("--dtype", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    common.set_cache_dirs()
    common.ensure_src_on_path()
    import torch
    from repro_torch.kernels import build

    from epbench import faults
    build.library()
    bench = common.benchmark()
    cell, conf, traffic, _ = R.prepare(args.workload, bench)
    dev = torch.device("cuda", 0)
    undo = faults.plant(args.fault) if args.fault else None
    if args.plain:
        from repro_torch.kernels import ops
        plain, pick = args.plain.split(","), ops._pick
        ops._pick = lambda name, *t: (ops.KERNELS[name][1] if name in plain
                                      else pick(name, *t))
    out = open(args.out, "a") if args.out else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        R.T_START = t0
        torch.cuda.reset_peak_memory_stats()
        ctx = R.make_context(cell, conf, traffic, dev, seed, args.seconds,
                             False, control=not args.no_control)
        if args.dtype:
            ctx.cfg = dataclasses.replace(ctx.cfg, dtype=args.dtype)
        rec = common.load_module("traffic", traffic["driver"]).run(ctx)
        line = {"cell": cell["name"], "seed": seed, "fault": args.fault,
                "plain": args.plain, "dtype": args.dtype,
                "program": rec["checks"], "control": rec.get("control"),
                "detail": rec.get("check_detail"), "e2e": rec["e2e"],
                "setup_s": ctx.setup_s, "peak": rec["memory_peak"],
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        del rec
        ctx.free()
    if undo:
        undo()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
