"""Hand-written CUDA kernels for Hopper (``csrc/``) and their plain
PyTorch versions, one module per kernel:

- flash_attention   — replaces ``flash_attention_pallas`` (prefill)
- decode_attention  — replaces ``decode_attention_pallas`` (every contiguous
                      decode step)
- paged_decode_attention — replaces the XLA ``paged_decode_attention`` (every
                      paged decode step; its kernel lives in
                      ``csrc/decode_attention.cu``)
- rmsnorm           — replaces ``rmsnorm_pallas`` (three norms per layer)
- int8_matmul       — replaces ``int8_matmul_pallas`` (weight-only) and
                      ``int8_matmul_dynamic_pallas`` (AutoQuant's linears)
- hstu_attention    — replaces ``hstu_attention_pallas`` (every HSTU layer)
- ssd_scan          — replaces ``ssd_scan_pallas`` (every Mamba-2 prefill)

``ops`` dispatches between them, ``ref`` holds the naive oracles and
``_build`` compiles the sources with ``nvcc`` at first use. Importing this
package builds nothing.
"""
