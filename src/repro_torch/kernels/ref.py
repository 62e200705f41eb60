"""Torch oracles for the ported kernels, under the names of
``repro.kernels.ref``.  They are the plain versions that sit beside each
kernel (``grouped_matmul.py``), so the tests, the CPU path and the card's
kernel checks all hold the kernels against one definition."""
from __future__ import annotations

import torch

from repro_torch.core import plan as _plan
from repro_torch.kernels.grouped_matmul import (gather_swiglu_scatter_plain,
                                                grouped_swiglu_plain)


def occupancy_mask(counts, n_groups: int, width: int) -> torch.Tensor:
    return _plan.occupancy_mask(torch.as_tensor(counts, dtype=torch.int32),
                                n_groups, width)


grouped_swiglu_ref = grouped_swiglu_plain
gather_swiglu_scatter_ref = gather_swiglu_scatter_plain
