"""PyTorch/CUDA port of the UCCL-EP reproduction (the ``repro`` JAX package).

The module layout mirrors ``repro`` so each counterpart is easy to find.
The package imports ``torch`` and numpy only; the four kernels on the
serving path (``kernels/``) are CUDA C++ written for Hopper (``csrc/``),
built with ``nvcc`` at first use.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``, where every kernel wrapper takes its plain
PyTorch version.
"""
