"""Qwen2.5-3B [hf:Qwen/Qwen2.5 family] — dense GQA with QKV bias. A copy of
``repro/configs/qwen2_5_3b.py`` (``CONFIG`` and ``SMOKE``).

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab_size=151_936,
    rope_theta=1_000_000.0,
    qkv_bias=True,
)

SMOKE = CONFIG.replace(
    name="qwen2.5-3b-smoke",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=2,
    d_ff=512,
    vocab_size=512,
)
