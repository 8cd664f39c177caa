"""Whisper-base [arXiv:2212.04356] — encoder-decoder speech model. A copy of
``repro/configs/whisper_base.py`` (``CONFIG`` and ``SMOKE``).

6L (enc) + 6L (dec), d_model=512, 8H, d_ff=2048, vocab=51865. The
mel-spectrogram + conv frontend is stubbed: the encoder consumes
precomputed 1500-frame embeddings [batch, 1500, 512]. The decoder is
autoregressive with self- and cross-attention KV caches; beam search is the
default decoding strategy (the paper's Seamless analysis, Obs #4).
"""
from repro_torch.configs.base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,  # decoder layers
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51_865,
    encdec=EncDecConfig(n_encoder_layers=6, n_frames=1500, max_target_len=448),
)

SMOKE = CONFIG.replace(
    name="whisper-smoke",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    encdec=EncDecConfig(n_encoder_layers=2, n_frames=64, max_target_len=64),
)
