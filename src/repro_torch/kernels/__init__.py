"""Hand-written CUDA kernels for Hopper (``csrc/``) and their plain
PyTorch versions, one module per kernel:

- flash_attention   — replaces ``flash_attention_pallas`` (prefill)
- decode_attention  — replaces ``decode_attention_pallas`` (every decode step)
- rmsnorm           — replaces ``rmsnorm_pallas`` (three norms per layer)

``ops`` dispatches between them, ``ref`` holds the naive oracles and
``_build`` compiles the sources with ``nvcc`` at first use. Importing this
package builds nothing.
"""
