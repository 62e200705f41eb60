"""The training step and the fault-tolerant loop: the port of
``repro.training``; exports what the reference imports into its package."""
from repro_torch.training.train_loop import (HParams, TrainState, Watchdog,
                                             init_state, make_train_step,
                                             train_loop, train_step)

__all__ = ["HParams", "TrainState", "Watchdog", "init_state",
           "make_train_step", "train_loop", "train_step"]
