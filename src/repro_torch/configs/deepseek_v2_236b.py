"""DeepSeek-V2 236B [arXiv:2405.04434] — MoE with Multi-head Latent Attention.
A copy of ``repro/configs/deepseek_v2_236b.py`` (``CONFIG`` and ``SMOKE``).

60L d_model=5120 128H d_ff_expert=1536 vocab=102400; MLA q_lora=1536,
kv_lora=512, rope 64; 2 shared + 160 routed experts, top-6; first layer
dense FFN (12288); untied LM head.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="mla_moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,  # MLA: latent cache is shared; per-head K/V up-projected
    d_head=128,
    d_ff=12288,  # dense-FFN width (first layer)
    vocab_size=102_400,
    rope_theta=10_000.0,
    moe=MoEConfig(
        n_experts=160,
        top_k=6,
        d_ff_expert=1536,
        n_shared_experts=2,
        first_dense_layers=1,
        d_ff_dense=12288,
        router_aux_weight=0.003,
    ),
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
    ),
)

SMOKE = CONFIG.replace(
    name="deepseek-v2-smoke",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    d_head=64,
    d_ff=512,
    vocab_size=512,
    moe=MoEConfig(
        n_experts=4,
        top_k=2,
        d_ff_expert=128,
        n_shared_experts=1,
        first_dense_layers=1,
        d_ff_dense=512,
    ),
    mla=MLAConfig(
        q_lora_rank=128,
        kv_lora_rank=64,
        qk_nope_dim=64,
        qk_rope_dim=32,
        v_head_dim=64,
    ),
)
