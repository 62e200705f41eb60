"""Torch oracles for the ported kernels, under the names of
``repro.kernels.ref`` (and ``decode_attention_paged_ref`` of
``repro.kernels.decode_attention``).  They are the plain versions that
sit beside each kernel (``grouped_matmul.py``, ``combine_reduce.py``,
``norm_attention.py``), so the tests, the CPU path and the card's kernel
checks all hold the kernels against one definition.
``flash_attention_ref`` computes the reference's softmax attention as the
flash kernels do (unnormalised P rounded to v's dtype, one division at the
end); in fp32 the two agree to rounding."""
from __future__ import annotations

import torch

from repro_torch.core import plan as _plan
from repro_torch.kernels.combine_reduce import combine_reduce_plain
from repro_torch.kernels.grouped_matmul import (gather_swiglu_scatter_plain,
                                                grouped_matmul_plain,
                                                grouped_swiglu_plain)
from repro_torch.kernels.norm_attention import (decode_attention_paged_plain,
                                                decode_attention_plain,
                                                flash_attention_plain,
                                                rmsnorm_plain)


def occupancy_mask(counts, n_groups: int, width: int) -> torch.Tensor:
    return _plan.occupancy_mask(torch.as_tensor(counts, dtype=torch.int32),
                                n_groups, width)


grouped_matmul_ref = grouped_matmul_plain
grouped_swiglu_ref = grouped_swiglu_plain
gather_swiglu_scatter_ref = gather_swiglu_scatter_plain
combine_reduce_ref = combine_reduce_plain
flash_attention_ref = flash_attention_plain
rmsnorm_ref = rmsnorm_plain
# the normalised decode of the reference's ``ops.decode_attention`` ref
# branch (``decode_attention_local``, then the divide with l == 0 -> 1)
decode_attention_ref = decode_attention_plain
# skips unallocated (-1) blocks, as the reference's paged kernel does; its
# oracle instead reads them as block 0 (decode_attention.py:213)
decode_attention_paged_ref = decode_attention_paged_plain
