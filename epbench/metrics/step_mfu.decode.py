"""step_mfu.decode: the whole decode step's share of the card's bf16 peak,
2 N_active FLOP a sequence a step (frozen ``model_flops``) over the traced
slice's wall time a step."""
from epbench import roofline


def read(rec):
    sl = rec.get("slice")
    if not sl or not sl["steps"]:
        return None
    step_s = sl["wall_s"] / sl["steps"]
    flops = roofline.model_flops(rec["cfg"], rec["batch"], "forward")
    return flops / step_s / roofline.BF16_FLOP_PER_S * 100.0
