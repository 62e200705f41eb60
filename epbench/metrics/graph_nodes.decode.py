"""graph_nodes.decode: the nodes of the captured decode graph, the
program's gauge ``serve.graph_nodes`` (``repro_torch.tracing``; None
where the program sets no such gauge)."""


def read(rec):
    if not rec.get("slice"):
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing.snapshot()["gauges"].get("serve.graph_nodes")
