"""Pluggable EP transport backends behind one dispatch/combine seam (the
port of ``repro.core.backend``'s registry).

Every backend implements

    ``dispatch_combine(spec, x, top_idx, top_w, expert_fn) -> DispatchResult``

Registered here:

- ``torch_collectives``: LL or HT per ``spec.mode`` over the rank-stacked
  EP world of :mod:`repro_torch.core.ep` (the counterpart of the JAX
  package's ``jax_collectives``).

The host-side ``simulated_rdma`` transport substrate is not ported yet.
"""
from __future__ import annotations

from typing import Callable, Dict, Protocol, runtime_checkable


@runtime_checkable
class EPBackend(Protocol):
    """One EP transport implementation behind the dispatch/combine seam."""

    name: str

    def dispatch_combine(self, spec, x, top_idx, top_w, expert_fn):
        """x: (R, T, D); top_idx/top_w: (R, T, K) -> DispatchResult."""
        ...


_REGISTRY: Dict[str, Callable[..., EPBackend]] = {}


def register_backend(name: str):
    """Class/factory decorator: ``@register_backend("my_transport")``."""
    def deco(factory):
        _REGISTRY[name] = factory
        return factory
    return deco


def get_backend(name: str, **kwargs) -> EPBackend:
    if name not in _REGISTRY:
        raise KeyError(f"unknown EP backend {name!r}; "
                       f"available: {available_backends()}")
    return _REGISTRY[name](**kwargs)


def available_backends() -> list[str]:
    return sorted(_REGISTRY)


@register_backend("torch_collectives")
class TorchCollectivesBackend:
    """One-shot LL or chunked/dedup'd HT dispatch over the rank-stacked
    world, selected by ``spec.mode``."""

    name = "torch_collectives"

    def dispatch_combine(self, spec, x, top_idx, top_w, expert_fn):
        from repro_torch.core.ep import dispatch_combine_ht, dispatch_combine_ll
        fn = dispatch_combine_ll if spec.mode == "ll" else dispatch_combine_ht
        return fn(spec, x, top_idx, top_w, expert_fn)
