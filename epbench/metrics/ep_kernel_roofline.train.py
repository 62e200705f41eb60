"""ep_kernel_roofline.train: the EP kernels' summed least time (frozen
``roofline.kernel_bound`` of every call of a step, from the call's own
shapes and counts, in one instrumented step after the slice) over their
summed device time a step in the traced slice (the kernels by name)."""


def read(rec):
    sl, bound = rec.get("slice"), rec.get("bound")
    if not sl or not bound or not bound["per_step_s"]:
        return None
    dev = sum(sl["kind_s"].values())
    if dev <= 0:
        return None
    return bound["per_step_s"] * sl["steps"] / dev * 100.0
