"""Config dataclasses for the PyTorch port: a copy of
``repro/configs/base.py`` (the port imports nothing of the JAX package).

Every architecture is a single frozen ``ModelConfig``; family-specific
blocks (MoE, MLA, SSM, hybrid, enc-dec, VLM) are optional sub-configs.
Only the dense family runs in the port so far; the other sub-configs are
kept so a config copied from the reference reads the same here.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block config (DeepSeek-V2 / Qwen3-MoE style)."""

    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    # layers [0, first_dense_layers) use a dense FFN of width d_ff_dense
    first_dense_layers: int = 0
    d_ff_dense: int = 0
    router_aux_weight: float = 0.001
    normalize_router_weights: bool = True  # softmax-then-renorm over top-k
    # expert-capacity factor (Switch-style token dropping). Set to
    # n_experts/top_k for a dropless (worst-case) capacity.
    capacity_factor: float = 1.25
    # position-in-expert ranking: "cumsum" (baseline; lowers to a
    # quadratic reduce-window on XLA — measured 1.4x the cost of ALL
    # expert GEMMs at 32k-prefill scale, see EXPERIMENTS.md §Perf) or
    # "sort" (argsort-based, O(N log N) — the optimized path).
    dispatch_rank: str = "cumsum"


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention config.

    The KV cache stores only the compressed latent ``c_kv`` (kv_lora_rank)
    plus the decoupled RoPE key (qk_rope_dim) per token — the paper's
    static-KV-cache lever applied to an architecture that *also* compresses
    the cache itself.
    """

    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD config."""

    d_state: int
    d_conv: int
    expand: int
    head_dim: int
    n_groups: int = 1
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class HybridConfig:
    """Griffin / RecurrentGemma config: RG-LRU recurrent blocks mixed with
    local (sliding-window) attention, repeating ``pattern``."""

    pattern: Tuple[str, ...]  # e.g. ("recurrent", "recurrent", "attention")
    window: int
    lru_width: int
    conv_width: int = 4

    def block_kind(self, layer: int) -> str:
        return self.pattern[layer % len(self.pattern)]


@dataclass(frozen=True)
class EncDecConfig:
    """Whisper/Seamless-style encoder-decoder config. The modality frontend
    (mel + conv) is stubbed: the encoder consumes precomputed frame
    embeddings of shape [batch, n_frames, d_model]."""

    n_encoder_layers: int
    n_frames: int  # post-conv frames fed to the encoder (whisper-base: 1500)
    max_target_len: int = 448


@dataclass(frozen=True)
class VLMConfig:
    """Chameleon-style early-fusion config. The VQ image tokenizer is
    stubbed: image regions arrive as token ids in [0, image_vocab) that are
    offset into the tail of the unified vocabulary."""

    n_image_tokens: int  # tokens per image (chameleon: 1024)
    image_vocab: int


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | mla_moe | ssm | hybrid | encdec | vlm | hstu
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None  # defaults to d_model // n_heads
    rope_theta: float = 10_000.0
    rmsnorm_eps: float = 1e-5
    qkv_bias: bool = False
    qk_norm: bool = False
    tie_embeddings: bool = False
    # sliding-window attention (ring-buffer KV cache); None = full attention
    sliding_window: Optional[int] = None
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    # HSTU-specific (generative DLRM, non-autoregressive)
    hstu_max_attn_len: Optional[int] = None
    dtype: str = "bfloat16"
    # compile-scale controls (transformer family): stack the homogeneous
    # layer block and lax.scan over it (params/caches gain a leading [L]
    # axis), optionally remat'ing each layer (activation checkpointing).
    scan_layers: bool = False
    remat: bool = False
    # Megatron-style sequence parallelism (beyond-paper §Perf lever):
    # constrain the residual stream's sequence axis onto the 'model' mesh
    # axis at layer boundaries, so norms/residuals run sharded and TP
    # all-reduces become reduce-scatter + all-gather pairs.
    seq_parallel: bool = False

    # ---- derived ----
    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def is_autoregressive(self) -> bool:
        return self.family != "hstu"

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context_decode(self) -> bool:
        """True if decode memory is sub-linear in context (constant-state
        recurrence or bounded ring-buffer window)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    def n_params(self) -> int:
        """Analytic total parameter count (used for 6*N*D model-FLOPs)."""
        return _count_params(self)

    def n_active_params(self) -> int:
        """Parameters touched per token (MoE: shared + top_k routed)."""
        return _count_params(self, active_only=True)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def _attn_params(cfg: ModelConfig) -> int:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.mla is not None:
        m = cfg.mla
        q_in = m.q_lora_rank if m.q_lora_rank > 0 else d
        p = 0
        if m.q_lora_rank > 0:
            p += d * m.q_lora_rank
        p += q_in * h * (m.qk_nope_dim + m.qk_rope_dim)  # q up-proj
        p += d * (m.kv_lora_rank + m.qk_rope_dim)  # kv down-proj (+rope key)
        p += m.kv_lora_rank * h * (m.qk_nope_dim + m.v_head_dim)  # kv up-proj
        p += h * m.v_head_dim * d  # output proj
        return p
    p = d * h * dh + 2 * d * kv * dh + h * dh * d
    if cfg.qkv_bias:
        p += (h + 2 * kv) * dh
    return p


def _ffn_params_dense(d_model: int, d_ff: int) -> int:
    return 3 * d_model * d_ff  # SwiGLU: w1, w3, w2


def _count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    d = cfg.d_model
    total = cfg.vocab_size * d  # embeddings
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * d  # lm head

    if cfg.family == "ssm":
        s = cfg.ssm
        d_in = s.d_inner(d)
        nh = s.n_heads(d)
        conv_dim = d_in + 2 * s.n_groups * s.d_state
        per_layer = (
            d * (2 * d_in + 2 * s.n_groups * s.d_state + nh)  # in_proj
            + conv_dim * s.d_conv  # conv1d
            + nh  # A_log
            + nh  # D
            + d_in  # norm
            + d_in * d  # out_proj
            + d  # pre-norm
        )
        return total + cfg.n_layers * per_layer

    if cfg.family == "hybrid":
        hy = cfg.hybrid
        w = hy.lru_width
        attn = _attn_params(cfg) + 2 * d  # + norms
        rec = (
            d * 2 * w  # input+gate branch proj
            + w * hy.conv_width  # temporal conv
            + 2 * w * w  # recurrence input/ gates (a, x gates)
            + w  # Lambda param
            + w * d  # out proj
            + 2 * d
        )
        ffn = _ffn_params_dense(d, cfg.d_ff) + d
        per = []
        for layer in range(cfg.n_layers):
            kind = hy.block_kind(layer)
            per.append((attn if kind == "attention" else rec) + ffn)
        return total + sum(per)

    if cfg.family == "encdec":
        ed = cfg.encdec
        enc_layer = _attn_params(cfg) + _ffn_params_dense(d, cfg.d_ff) + 3 * d
        dec_layer = 2 * _attn_params(cfg) + _ffn_params_dense(d, cfg.d_ff) + 4 * d
        return total + ed.n_encoder_layers * enc_layer + cfg.n_layers * dec_layer

    # dense / moe / mla_moe / vlm / hstu share the decoder-block accounting
    attn = _attn_params(cfg)
    total += cfg.n_layers * (attn + 2 * d)  # attn + norms
    if cfg.moe is None:
        total += cfg.n_layers * _ffn_params_dense(d, cfg.d_ff)
        return total
    m = cfg.moe
    for layer in range(cfg.n_layers):
        if layer < m.first_dense_layers:
            total += _ffn_params_dense(d, m.d_ff_dense or cfg.d_ff)
            continue
        total += d * m.n_experts  # router
        shared = m.n_shared_experts * _ffn_params_dense(d, m.d_ff_expert)
        n_routed = m.top_k if active_only else m.n_experts
        total += shared + n_routed * _ffn_params_dense(d, m.d_ff_expert)
    return total
