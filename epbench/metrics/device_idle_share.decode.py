"""device_idle_share.decode: the share of the traced slice's wall time in
which no operation ran on the card (one minus the union of the device
activities' intervals over the wall time)."""


def read(rec):
    sl = rec.get("slice")
    if not sl or sl["wall_s"] <= 0 or not sl["busy_s"]:
        return None
    return (1.0 - sl["busy_s"] / sl["wall_s"]) * 100.0
