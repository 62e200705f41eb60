"""step_mfu.decode_mla: the whole decode step's share of the card's bf16
peak: 2 N_active FLOP a sequence and the absorbed attention's FLOPs at
each of the slice's positions (frozen ``roofline_mla.decode_step_flops``)
over the traced slice's wall time."""
from epbench import roofline, roofline_mla


def read(rec):
    sl = rec.get("slice")
    if not sl or not sl["steps"] or "positions" not in sl:
        return None
    a, b = sl["positions"]
    flops = sum(roofline_mla.decode_step_flops(rec["cfg"], rec["batch"], t)
                for t in range(a, b + 1))
    return flops / sl["wall_s"] / roofline.BF16_FLOP_PER_S * 100.0
