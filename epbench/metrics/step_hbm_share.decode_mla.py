"""step_hbm_share.decode_mla: the bytes an MLA decode step must move
(every weight once, the experts the step's routing occupies a layer as
the traced step counted them, the live latent rows at the slice's mean
position, the logits written; ``roofline_mla.decode_step_bytes``) over
the slice's wall time a step, against 3.35 TB/s."""
from epbench import roofline, roofline_mla


def read(rec):
    sl, bound = rec.get("slice"), rec.get("bound")
    if not sl or not sl["steps"] or not bound or not bound["experts"]:
        return None
    step_s = sl["wall_s"] / sl["steps"]
    a, b = sl["positions"]
    experts = sum(bound["experts"]) / len(bound["experts"])
    nbytes = roofline_mla.decode_step_bytes(rec["cfg"], rec["batch"],
                                            (a + b) / 2, experts)
    return nbytes / step_s / roofline.HBM_BYTES_PER_S * 100.0
