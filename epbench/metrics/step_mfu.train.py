"""step_mfu.train: the whole training step's share of the bf16 peak, 6
N_active T (frozen ``model_flops``) over a step's wall time in the window (the
traced slice runs after it: the profiler slows the host's issue)."""
from epbench import roofline


def read(rec):
    if not rec.get("step_s"):
        return None
    flops = roofline.model_flops(rec["cfg"], rec["tokens_per_step"], "train")
    return flops / rec["step_s"] / roofline.BF16_FLOP_PER_S * 100.0
