"""Failure injection for the train loop's checkpoint-restore path: the port
of ``repro.distributed.fault.FailureInjector``.  Real deployments get
failure signals from the platform; a deterministic injector stands in so
the recovery path runs end to end."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class FailureInjector:
    """Fails exactly once at each step listed in ``at_steps``."""
    at_steps: tuple = ()
    fired: set = field(default_factory=set)

    def __call__(self, step: int) -> bool:
        if step in self.at_steps and step not in self.fired:
            self.fired.add(step)
            return True
        return False
