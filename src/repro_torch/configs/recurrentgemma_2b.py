"""RecurrentGemma-2B [arXiv:2402.19427] — Griffin: RG-LRU + local attention.
A copy of ``repro/configs/recurrentgemma_2b.py`` (``CONFIG`` and ``SMOKE``).

26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000; block pattern
(recurrent, recurrent, attention) with window 2048. Bounded state =>
long_500k decode is native.
"""
from repro_torch.configs.base import HybridConfig, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_head=256,
    d_ff=7680,
    vocab_size=256_000,
    tie_embeddings=True,
    hybrid=HybridConfig(
        pattern=("recurrent", "recurrent", "attention"),
        window=2048,
        lru_width=2560,
        conv_width=4,
    ),
)

SMOKE = CONFIG.replace(
    name="recurrentgemma-smoke",
    n_layers=3,  # one full pattern period
    d_model=128,
    n_heads=4,
    n_kv_heads=1,
    d_head=32,
    d_ff=256,
    vocab_size=512,
    hybrid=HybridConfig(
        pattern=("recurrent", "recurrent", "attention"),
        window=32,
        lru_width=128,
        conv_width=4,
    ),
)
