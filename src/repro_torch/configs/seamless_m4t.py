"""SeamlessM4T-style speech translation [Communication et al. 2023]. A copy
of ``repro/configs/seamless_m4t.py`` (``CONFIG`` and ``SMOKE``).

Backbone dims follow the whisper-base class; the config adds the 4-module
structure: encoder (stub frontend) + autoregressive T2TT decoder + NAR T2U
+ vocoder (``models/seamless.py``).
"""
from repro_torch.configs.base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t",
    family="seamless",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=32_000,  # NLLB-style multilingual text vocab (reduced)
    encdec=EncDecConfig(n_encoder_layers=6, n_frames=1500, max_target_len=448),
)

SMOKE = CONFIG.replace(
    name="seamless-smoke",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    encdec=EncDecConfig(n_encoder_layers=2, n_frames=64, max_target_len=64),
)
