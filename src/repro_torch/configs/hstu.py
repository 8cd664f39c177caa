"""HSTU generative DLRM [Zhai et al., ICML'24] — the paper's fourth workload
(§2.1.4). A copy of ``repro/configs/hstu.py`` (``CONFIG`` and ``SMOKE``).

A non-autoregressive sequential transducer with pointwise-normalized
attention (SiLU, no softmax) and a relative attention bias: 14 identical
layers, layers >= 3 cap the attention context at 1024 (§3.1), user
histories of 4507-5121 items over a 6000-item space.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hstu",
    family="hstu",
    n_layers=14,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=0,  # HSTU has no FFN: pointwise projection/transformation instead
    vocab_size=6000,  # synthetic item-id space (§3.1)
    hstu_max_attn_len=1024,
)

SMOKE = CONFIG.replace(
    name="hstu-smoke",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    vocab_size=512,
    hstu_max_attn_len=64,
)
