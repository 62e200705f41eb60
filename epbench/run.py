"""Run one cell of the port's benchmark once and print its result line.

  python3 epbench/run.py --workload <cell> --seed <n> --seconds <s> \\
      --trace <0|1>

From the root of a checkout.  The cell's configuration, traffic mix,
driver, per-layer readers and limits are found by the names in
``BENCHMARK.json`` (see ``epbench/common.py``).  Set-up (the kernels'
build on a checkout's first run, the weights drawn on the card from the
seed, the warm-up of the cell's own shapes, a decode cell's capture) is
``setup_s``; then the driver measures for ``--seconds``.  Once the window
has closed, the harness checks that no module of JAX or of the JAX
package was loaded, frees the program's state, compares what the timed
path produced with the plain reference (``epbench/checks.py``), and
prints each number compared beside its limit on standard error and, as
the last line of standard output, one JSON object.

Exits with code 2 and prints no result where no CUDA card (or fewer than
the cell asks for) is visible, or where the port is not beside it (a
directory holding only ``BENCHMARK.json`` and ``epbench/``); with code 3
where a forbidden module was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from epbench import common  # noqa: E402


class Context:
    """What a driver is handed: the run's arguments, the cell's port
    configuration (``cfg``), the reference's plain sizes (``sz``), the
    traffic mix, the device, and three calls back into the harness."""

    def __init__(self, *, cell, cfg, sz, traffic, device, seed, seconds,
                 trace, control=False):
        self.cell, self.cfg, self.sz, self.traffic = cell, cfg, sz, traffic
        self.device, self.seed, self.seconds = device, seed, seconds
        self.trace, self.control = trace, control
        self.setup_s = None

    def setup_done(self, check_s: float = 0.0):
        """The window starts: set-up is the time since the process began,
        less ``check_s`` spent on the correctness check's own records
        (which no set-up of the program needs)."""
        self.setup_s = time.perf_counter() - T_START - check_s

    def memory_peak(self) -> int:
        import torch
        if self.device.type != "cuda":
            return 0
        torch.cuda.synchronize()
        return int(torch.cuda.max_memory_allocated())

    def free(self):
        import torch
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def prepare(cell_name: str, bench: dict, root: Path = common.HERE):
    """(cell entry, configuration file, traffic mix, limits) by name."""
    cell = common.workload(bench, cell_name)
    return (cell, common.config_file(cell["config"], root),
            common.traffic_file(cell["traffic"], root),
            common.limits_file(cell["name"], root))


def make_context(cell, conf, traffic, device, seed, seconds, trace,
                 control=False) -> Context:
    from epbench.reference.model import sizes
    return Context(cell=cell, cfg=common.model_config(conf, traffic),
                   sz=sizes(conf["port"], traffic), traffic=traffic,
                   device=device, seed=seed, seconds=seconds, trace=trace,
                   control=control)


def judge(checks: dict, limits: dict) -> tuple[bool, dict]:
    """Each number beside its limit; correct when every number is finite
    and at or under its limit."""
    out, ok = {}, True
    for name, value in checks.items():
        lim = limits[name]["limit"]
        out[name] = {"value": value, "limit": lim}
        ok = ok and math.isfinite(value) and value <= lim
    return ok, out


def metrics_line(bench, cell, rec, ctx, trace: bool, root=common.HERE):
    out = {}
    if not trace:
        for m in common.metrics_of_cell(bench, cell["name"], "end_to_end"):
            if m["name"] == "setup_s":
                out["setup_s"] = {"value": ctx.setup_s, "unit": m["unit"]}
            elif m["name"] in rec["e2e"]:
                out[m["name"]] = {"value": rec["e2e"][m["name"]],
                                  "unit": m["unit"]}
        return out
    for m in common.metrics_of_cell(bench, cell["name"], "per_layer"):
        value = common.load_module("metrics", m["name"], root).read(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    common.set_cache_dirs()
    common.ensure_src_on_path()
    bad = common.forbidden_modules()
    if bad:
        print(f"epbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    bench = common.benchmark()
    cell, conf, traffic, limits = prepare(args.workload, bench)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"epbench: {cell['name']} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if not (common.CHECKOUT / "src" / "repro_torch").is_dir():
        print("epbench: the port (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    build.library()

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ctx = make_context(cell, conf, traffic, dev, args.seed, args.seconds,
                       bool(args.trace))
    driver = common.load_module("traffic", traffic["driver"])
    rec = driver.run(ctx)

    bad = common.forbidden_modules()
    if bad:
        print(f"epbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    correct, checks = judge(rec["checks"], limits)
    result = {"correct": correct, "attempted": rec["attempted"],
              "failed": rec["failed"],
              "metrics": metrics_line(bench, cell, rec, ctx, bool(args.trace)),
              "device": {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(0),
                         "count": cell["chips"],
                         "memory_peak_bytes": rec["memory_peak"]}}
    if args.trace:
        sl = rec["slice"]
        result["device"].update(busy_s=sl["busy_s"], window_s=sl["wall_s"])
        result["breakdown"] = {"device_ops": sl["device_ops"],
                               "idle_gaps": sl["idle_gaps"]}
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
