"""graph_launch_ms.decode: the median host time of the decode graph's
launch, the program's span ``serve.step/serve.graph_launch`` (around
``graph.replay()``), over the steps no profiler ran in
(``repro_torch.tracing``; None where the program has no such span)."""


def read(rec):
    if not rec.get("slice"):
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    s = tracing.snapshot()["spans"].get("serve.step/serve.graph_launch", {})
    b = s.get("unprofiled")
    return b["host_median_ms"] if b else None
