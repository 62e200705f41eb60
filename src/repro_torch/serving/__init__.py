"""EP-native continuous-batching serving engine (DESIGN.md §18): the port
of ``repro.serving``.

The inference-side counterpart of the training-step pipeline: a request
queue with seeded arrival-process simulation (Poisson / bursty offered-load
curves standing in for production traffic), a block-allocated paged KV cache
(:class:`KVBlockPool`), a continuous-batching scheduler with prefill/decode
disaggregation (chunked prefill interleaved with decode steps under a token
budget and cache pressure), and a model step whose MoE layers dispatch
through a persistent EP session (``SimulatedRDMABackend(session_layers=)``)
per microbatch on the deterministic event clock.

Everything but the expert compute is host-side and seeded: two engines
with the same config and workload produce bit-identical counters and
latencies, whatever device their experts compute on, and on one device the
same outputs.
"""
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.kv_cache import KVBlockPool
from repro_torch.serving.scheduler import (Microbatch, SchedulerConfig,
                                           Scheduler, SeqState, Slice)
from repro_torch.serving.workload import (Request, bursty_arrivals,
                                          load_curve_arrivals,
                                          poisson_arrivals)

__all__ = [
    "EngineConfig", "ServingEngine", "KVBlockPool", "Microbatch",
    "SchedulerConfig", "Scheduler", "SeqState", "Slice", "Request",
    "bursty_arrivals", "load_curve_arrivals", "poisson_arrivals",
]
