"""mla_kernel_roofline.decode_mla: the absorbed-MLA decode kernel's frozen
least time over the traced slice (``roofline_mla.mla_kernel_bound`` of
each layer's call at each of the slice's positions, from the cell's
shapes) over its device time there, the kernel found by name in every
device record of the slice (``traffic/decode_mla.py``)."""


def read(rec):
    sl, bound = rec.get("slice"), rec.get("mla_bound_s")
    if not sl or not bound or not sl.get("mla_kernel_s"):
        return None
    return bound / sl["mla_kernel_s"] * 100.0
