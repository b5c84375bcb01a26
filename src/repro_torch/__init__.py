"""PyTorch/CUDA port of the ``repro`` package's accelerator layers.

Laid out like ``repro`` (``configs``, ``models``, ``kernels``,
``serving``, ``observability``) and held against it by the
``tests/test_torch_*.py`` parity tests. It imports ``torch`` and numpy,
never JAX and never ``repro``: what it needs from a JAX-free module there
it keeps as its own copy. Entry points run on the CUDA card unless the
caller passes ``device="cpu"``.
"""
