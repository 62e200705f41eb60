"""Static and dynamic analysis of the EP transport (DESIGN.md §17), the
port of ``repro.analysis``:

- :mod:`repro_torch.analysis.verify` — the protocol verifier: proves the
  wire contract's invariant catalog (:mod:`repro_torch.analysis.invariants`)
  over command streams / guard tables / net configs before any traffic
  moves.
- :mod:`repro_torch.analysis.racecheck` — an Eraser-style lockset race
  detector that instruments ``FifoChannel``/``Network``/``Proxy`` in
  threaded runs.
- :mod:`repro_torch.analysis.lint` — repo-specific AST/token lint rules
  and the CUDA sources' occupancy rule (``python -m
  repro_torch.analysis.lint src/repro_torch``).

This package may import ``core.transport`` leaf modules (wire_format,
fifo, simulator, proxy) but never ``ep_executor`` — the executor imports
the verifier, and the verifier duck-types its ``CommandStreams``.
"""
from repro_torch.analysis.invariants import CATALOG, Finding, Rule
from repro_torch.analysis.verify import verify, verify_or_raise

__all__ = ["CATALOG", "Finding", "Rule", "lint_paths", "lint_source",
           "verify", "verify_or_raise"]


def __getattr__(name: str):
    # the lint loads on first use, so that ``python -m
    # repro_torch.analysis.lint`` does not find its module imported already
    if name in ("lint_paths", "lint_source"):
        from repro_torch.analysis import lint
        return getattr(lint, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
