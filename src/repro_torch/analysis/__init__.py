"""Static and dynamic analysis of the EP transport (DESIGN.md §17), the
port of ``repro.analysis`` without its repo lint:

- :mod:`repro_torch.analysis.verify` — the protocol verifier: proves the
  wire contract's invariant catalog (:mod:`repro_torch.analysis.invariants`)
  over command streams / guard tables / net configs before any traffic
  moves.
- :mod:`repro_torch.analysis.racecheck` — an Eraser-style lockset race
  detector that instruments ``FifoChannel``/``Network``/``Proxy`` in
  threaded runs.

This package may import ``core.transport`` leaf modules (wire_format,
fifo, simulator, proxy) but never ``ep_executor`` — the executor imports
the verifier, and the verifier duck-types its ``CommandStreams``.
"""
from repro_torch.analysis.invariants import CATALOG, Finding, Rule
from repro_torch.analysis.verify import verify, verify_or_raise

__all__ = ["CATALOG", "Finding", "Rule", "verify", "verify_or_raise"]
