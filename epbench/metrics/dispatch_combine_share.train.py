"""dispatch_combine_share.train: the EP plan, dispatch and combine's
share of a training step's device time, 100 x the summed device
intervals of every program span ``ep.plan``, ``ep.dispatch`` and
``ep.combine`` under ``train.step`` (the forward's and the backward's
recompute) over those of ``train.step``, over the steps no profiler ran
in (``repro_torch.tracing``; None where the program has no such spans).
The three never nest in one another."""

PHASES = ("ep.plan", "ep.dispatch", "ep.combine")


def read(rec):
    if not rec.get("slice"):
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    spans = tracing.snapshot()["spans"]
    got = {p: b["unprofiled"]["device_ms"] for p, b in spans.items()
           if "unprofiled" in b}
    step = got.get("train.step", 0.0)
    if step <= 0:
        return None
    ep = sum(ms for p, ms in got.items() if p.startswith("train.step/")
             and p.rsplit("/", 1)[-1] in PHASES)
    return 100.0 * ep / step
