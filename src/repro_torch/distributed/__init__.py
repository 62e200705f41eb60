"""The EP world on one card (sharding), elastic re-meshing, fault policy,
compression and collectives: the port of ``repro.distributed``; exports
what the reference exports."""
from repro_torch.distributed.sharding import DistCtx, make_dist_ctx

__all__ = ["DistCtx", "make_dist_ctx"]
