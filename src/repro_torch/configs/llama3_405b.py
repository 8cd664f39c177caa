"""Llama-3-405B [arXiv:2407.21783] — frontier dense GQA model. A copy of
``repro/configs/llama3_405b.py`` (``CONFIG`` and ``SMOKE``).

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.
The tensor-parallel / memory stress case of the pool.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab_size=128_256,
    rope_theta=500_000.0,
)

SMOKE = CONFIG.replace(
    name="llama3-405b-smoke",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=2,
    d_ff=512,
    vocab_size=512,
)
