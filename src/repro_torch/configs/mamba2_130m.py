"""Mamba2-130m [arXiv:2405.21060] — attention-free SSM with SSD. A copy of
``repro/configs/mamba2_130m.py`` (``CONFIG`` and ``SMOKE``).

24L d_model=768, ssm_state=128, expand=2 (d_inner=1536, 24 heads of dim 64),
vocab=50280. Constant-size recurrent state per sequence slot.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=24,  # = d_inner / head_dim
    n_kv_heads=24,
    d_ff=0,
    vocab_size=50_280,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk_size=256),
)

SMOKE = CONFIG.replace(
    name="mamba2-smoke",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    vocab_size=512,
    ssm=SSMConfig(d_state=32, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk_size=32),
)
