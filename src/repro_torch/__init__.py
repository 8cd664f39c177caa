"""PyTorch/CUDA port of the ``repro`` serving stack.

A second package beside the JAX reference (``src/repro``): it imports
``torch`` and never ``jax`` nor anything of ``repro``. Plain tensor code is
PyTorch; every Pallas kernel on the ported path is a hand-written CUDA
kernel for Hopper (``kernels/csrc``), built with ``nvcc`` at first use.
"""
