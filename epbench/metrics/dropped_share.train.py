"""dropped_share.train: the share of routed choices the program dropped
at capacity, as it returns it (``aux["dropped"]``, the mean over its
MoE layers and ranks), averaged over the window's steps."""


def read(rec):
    return rec.get("dropped_share")
