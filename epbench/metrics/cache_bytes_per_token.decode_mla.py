"""cache_bytes_per_token.decode_mla: the bytes the decode cache holds a
position of a sequence over every layer, the program's gauge
``serve.cache_bytes_per_token`` (``model_zoo.init_cache``;
``repro_torch.tracing``; None where the program sets no such gauge)."""


def read(rec):
    if not rec.get("slice"):
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing.snapshot()["gauges"].get("serve.cache_bytes_per_token")
