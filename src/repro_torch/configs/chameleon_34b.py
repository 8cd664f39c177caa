"""Chameleon-34B [arXiv:2405.09818] — early-fusion mixed-modal model. A copy
of ``repro/configs/chameleon_34b.py`` (``CONFIG`` and ``SMOKE``).

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536 (unified text+image
token vocabulary). The VQ image tokenizer is stubbed: image tokens are ids
in the tail 8192 of the vocabulary. qk-norm, and contrastive (CFG-style)
decoding for T-I.
"""
from repro_torch.configs.base import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=65_536,
    qk_norm=True,
    vlm=VLMConfig(n_image_tokens=1024, image_vocab=8192),
)

SMOKE = CONFIG.replace(
    name="chameleon-smoke",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    vlm=VLMConfig(n_image_tokens=16, image_vocab=64),
)
