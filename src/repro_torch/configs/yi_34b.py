"""Yi-34B [arXiv:2403.04652] — llama-architecture dense model with GQA. A copy
of ``repro/configs/yi_34b.py`` (``CONFIG`` and ``SMOKE``).

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
Shape-class analogue of the paper's Code-Llama-34B workload.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64_000,
    rope_theta=5_000_000.0,
)

SMOKE = CONFIG.replace(
    name="yi-34b-smoke",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=2,
    d_ff=512,
    vocab_size=512,
)
