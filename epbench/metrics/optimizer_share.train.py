"""optimizer_share.train: the optimizer's share of a training step's
device time, 100 x the summed device intervals of the program's span
``train.step/train.optimizer`` over those of ``train.step``, over the
steps no profiler ran in (``repro_torch.tracing``; None where the program
has no such spans)."""


def read(rec):
    if not rec.get("slice"):
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    spans = tracing.snapshot()["spans"]

    def device_ms(path):
        b = spans.get(path, {}).get("unprofiled")
        return b["device_ms"] if b else 0.0
    step = device_ms("train.step")
    if step <= 0:
        return None
    return 100.0 * device_ms("train.step/train.optimizer") / step
