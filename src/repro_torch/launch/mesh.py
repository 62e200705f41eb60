"""Hardware constants of the port's card, an NVIDIA H100 SXM (80 GB HBM3,
at its 700 W limit): the counterpart of ``repro.launch.mesh``, whose TPU
v5e constants (``repro/launch/mesh.py:29-32``) the roofline read.  The
figures are NVIDIA's data-sheet peaks.

The reference's ``make_production_mesh`` and ``make_bench_mesh`` build
device meshes (256 or 512 chips; a small CPU mesh).  They have no
counterpart: the one card's world is the rank-stacked EP world of
:func:`repro_torch.distributed.sharding.make_dist_ctx`.
"""
from __future__ import annotations

# dense bf16 on the tensor cores (no sparsity), one card
PEAK_FLOPS_BF16 = 989e12
# HBM3, bytes/s, one card
HBM_BW = 3.35e12
# NVLink 4, bytes/s in each direction, one card (18 links): the rate a
# collective between cards of one host would move at, in place of the
# reference's ICI_BW.  On one card the rank-stacked all-to-all and psum
# are device copies and sums in memory, which HBM_BW bounds
NVLINK_BW = 450e9
