"""AdamW (and its factored form) and the learning-rate schedule: the port
of ``repro.optim``; exports what the reference exports."""
from repro_torch.optim.adamw import (AdamWState, apply_updates, global_norm,
                                     init_state)
from repro_torch.optim.schedule import cosine_with_warmup

__all__ = ["AdamWState", "apply_updates", "global_norm", "init_state",
           "cosine_with_warmup"]
