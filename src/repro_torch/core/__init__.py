"""UCCL-EP core: routing, dispatch planning, dispatch/combine (LL/HT),
pluggable transport backends, transport substrate.  The port of
``repro.core``; exports what the reference exports."""
from repro_torch.core.backend import (EPBackend, available_backends,
                                      get_backend, register_backend)
from repro_torch.core.ep import (EPSpec, DispatchResult, dispatch_combine_ht,
                                 dispatch_combine_ll, moe_ref)
from repro_torch.core.moe import moe_apply, moe_init, padded_experts_static
from repro_torch.core.plan import (DispatchPlan, WorldPlan, dedup_entry_table,
                                   dedup_first, flat_slots, group_counts,
                                   make_plan, make_world_plan, rank_in_group)
from repro_torch.core.routing import (RouterOut, RouterParams, route,
                                      router_init)

__all__ = ["EPSpec", "DispatchResult", "dispatch_combine_ht",
           "dispatch_combine_ll", "moe_ref", "moe_apply", "moe_init",
           "padded_experts_static", "RouterOut", "RouterParams", "route",
           "router_init", "EPBackend", "available_backends", "get_backend",
           "register_backend", "DispatchPlan", "WorldPlan",
           "dedup_entry_table", "dedup_first", "flat_slots", "group_counts",
           "make_plan", "make_world_plan", "rank_in_group"]
