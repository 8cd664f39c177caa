"""Llama-3.2-1B [hf:meta-llama/Llama-3.2-1B] — small llama3, tied embeddings.

16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256. A copy of
``repro/configs/llama3_2_1b.py`` (``CONFIG``, ``CONFIG_SWA`` and ``SMOKE``).

``CONFIG_SWA`` is the sliding-window variant (a ring-buffer KV cache of
8192 rows a layer), reached through no ``--arch`` of its own, as in the
reference.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128_256,
    rope_theta=500_000.0,
    tie_embeddings=True,
)

CONFIG_SWA = CONFIG.replace(name="llama3.2-1b-swa", sliding_window=8192)

SMOKE = CONFIG.replace(
    name="llama3.2-1b-smoke",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=2,
    d_ff=512,
    vocab_size=512,
)
