"""PyTorch/CUDA port of the UCCL-EP reproduction (the ``repro`` JAX package).

The module layout mirrors ``repro`` so each counterpart is easy to find.
The package imports ``torch`` and numpy only; the kernels (``kernels/``:
the four EP kernels of the serving path, and the Mamba selective scan,
forward and backward, of the training path) are CUDA C++ written for
Hopper (``csrc/``), built with ``nvcc`` at first use.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``, where every kernel
wrapper takes its plain PyTorch version.

Names of the reference that name JAX are renamed or left out; each such
decision, with its reason and the module that records it, is listed in
``tests/test_torch_surface.py``, which holds the two packages' names
together.  One of them spans many modules: the reference's ``Array =
jax.Array`` type aliases are ``Tensor = torch.Tensor`` here.
"""
