"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B] — fine-grained MoE, 128 experts top-8.
A copy of ``repro/configs/qwen3_moe_30b_a3b.py`` (``CONFIG`` and ``SMOKE``).

48L d_model=2048 32H (GQA kv=4, head_dim=128, qk-norm) d_ff_expert=768
vocab=151936, untied LM head.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_head=128,
    d_ff=768,  # = expert width; no dense layers
    vocab_size=151_936,
    rope_theta=1_000_000.0,
    qk_norm=True,
    moe=MoEConfig(
        n_experts=128,
        top_k=8,
        d_ff_expert=768,
        n_shared_experts=0,
        router_aux_weight=0.001,
    ),
)

SMOKE = CONFIG.replace(
    name="qwen3-moe-smoke",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    d_head=64,
    d_ff=128,
    vocab_size=512,
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128, n_shared_experts=0),
)
