"""wire_share.decode_mla: the fp8 wire's share of the traced slice's
device time: its kernels' device time (``gather_quantize`` and
``dequantize``, by name: ``trace.py``'s kind "wire") over the summed
device time of every kernel in the slice."""


def read(rec):
    sl = rec.get("slice")
    if not sl or not sl.get("device_sum_s"):
        return None
    return sl["kind_s"].get("wire", 0.0) / sl["device_sum_s"] * 100.0
