"""Hand-written Hopper kernels (``csrc/``) and their wrappers: the port of
``repro.kernels``.

Names follow the reference's with its TPU words replaced: a Pallas kernel
``*_pallas`` is ``*_cuda`` here (``decode_attention_paged``, the paged
Pallas kernel, is ``decode_attention_paged_cuda``), and a plain version
``*_ref`` is ``*_plain`` (``kernels/ref.py`` keeps the ``*_ref`` aliases;
``mamba_scan_ref`` is ``mamba_scan.mamba_scan_plain``).  The reference's
``flash_attention.py``, ``decode_attention.py`` and ``rmsnorm.py`` are one
module here, ``norm_attention.py``.  ``ops.KERNEL_MODE`` (the
``REPRO_KERNEL_MODE`` switch between Pallas, interpret mode and the plain
version) has no counterpart: a wrapper takes its kernel on a CUDA tensor
and its plain version on a CPU tensor.  ``ops.GSS_VMEM_BYTES`` (the TPU's
VMEM gate of the fused HT kernel) has none either: the CUDA kernel streams
its weights and needs no such gate.
"""
# The kernel modules import ``repro_torch.core`` (plan, wire codec), whose
# package imports the EP layers, which import ``kernels.ops`` and through it
# every kernel module.  Loading ``core`` first, before any kernel module
# starts, keeps that cycle from meeting a half-loaded kernel module.
import repro_torch.core  # noqa: F401
