"""Operator-class characterization (paper Fig 4 / Fig 10 methodology) — the
analytic side, a copy of ``repro/core/characterization.py``.

The paper instruments CUDA kernels per operator class (Linear, Attention
(SDPA/BMM/Softmax), Norm, Idle, Misc) with NSight. The port derives the
same breakdown two ways:

1. **Analytic** (this module): per-operator-class FLOPs and HBM bytes from
   the model config and mode (prefill@N / decode@context), converted to a
   time model via the H100 SXM roofline ``t_op = max(flops/peak, bytes/bw)``
   (989 TFLOP/s dense bf16, 3.35 TB/s HBM3). The arithmetic is the
   reference's, in the same order, so the costs agree bit for bit on the
   same config; only ``roofline_times``' default constants are the card's.
2. **Measured** (``launch/op_breakdown.py``): the device kernels of a
   profiled window on the card, each put into one class, and the window's
   idle time.

Definitions follow the paper: Linear = all GEMMs outside attention
score/context products (QKV/O projections count as Linear, as in Fig 4's
"Linear" vs "SDPA/BMM"); Attention = score GEMM + softmax + context GEMM +
KV-cache read/write traffic; Norm = RMSNorm; Embed = gather + LM head GEMM
is counted under Linear (it is a GEMM).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import HBM_BW, PEAK_FLOPS_BF16

BYTES = {"bfloat16": 2, "float32": 4, "int8": 1}


@dataclass
class OpCost:
    flops: float = 0.0
    bytes: float = 0.0

    def __iadd__(self, other):
        self.flops += other.flops
        self.bytes += other.bytes
        return self


def _gemm(m: int, k: int, n: int, dtype_bytes: int = 2) -> OpCost:
    return OpCost(
        flops=2.0 * m * k * n,
        bytes=dtype_bytes * (m * k + k * n + m * n),
    )


def op_breakdown(
    cfg: ModelConfig,
    *,
    mode: str,  # "prefill" | "decode"
    batch: int,
    seq: int,  # prompt length (prefill) or cache context (decode)
) -> Dict[str, OpCost]:
    """Per-op-class costs for ONE forward step of the whole model."""
    t = seq if mode == "prefill" else 1  # tokens processed this step
    n_tok = batch * t
    d, dh = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    dt_b = BYTES.get(cfg.dtype, 2)

    out: Dict[str, OpCost] = {
        "linear": OpCost(), "attention": OpCost(), "norm": OpCost(),
        "embed": OpCost(), "other": OpCost(),
    }

    out["embed"] += OpCost(flops=0, bytes=n_tok * d * dt_b * 2)

    for layer in range(cfg.n_layers):
        _layer_costs(cfg, out, layer, mode, batch, seq, n_tok)

    # final norm + LM head
    out["norm"] += OpCost(flops=5.0 * n_tok * d, bytes=2.0 * n_tok * d * dt_b)
    out["linear"] += _gemm(n_tok, d, cfg.vocab_size, dt_b)
    return out


def _layer_costs(cfg, out, layer, mode, batch, seq, n_tok):
    d, dh = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    dt_b = BYTES.get(cfg.dtype, 2)
    t = seq if mode == "prefill" else 1
    ctx = seq  # attended context length

    # ---- norms (2 per layer) ----
    out["norm"] += OpCost(flops=10.0 * n_tok * d, bytes=4.0 * n_tok * d * dt_b)

    # ---- attention path ----
    if cfg.family == "ssm":
        s = cfg.ssm
        d_in, n = s.d_inner(d), s.d_state
        nh = s.n_heads(d)
        out["linear"] += _gemm(n_tok, d, 2 * d_in + 2 * s.n_groups * n + nh, dt_b)
        out["linear"] += _gemm(n_tok, d_in, d, dt_b)
        if mode == "prefill":
            q = s.chunk_size
            nchunks = max(seq // q, 1)
            intra = OpCost(
                flops=2.0 * batch * nchunks * nh * q * q * (n + s.head_dim),
                bytes=dt_b * batch * seq * (d_in + 2 * s.n_groups * n) * 2,
            )
            inter = OpCost(
                flops=4.0 * batch * nchunks * nh * s.head_dim * n,
                bytes=4.0 * batch * nchunks * nh * s.head_dim * n,
            )
            out["attention"] += intra
            out["attention"] += inter
        else:
            state_bytes = 4.0 * batch * nh * s.head_dim * n
            out["attention"] += OpCost(
                flops=6.0 * batch * nh * s.head_dim * n, bytes=2 * state_bytes
            )
        return

    window = None
    if cfg.family == "hybrid":
        hy = cfg.hybrid
        if hy.block_kind(layer) != "attention":
            w = hy.lru_width
            out["linear"] += _gemm(n_tok, d, 2 * w, dt_b)
            out["linear"] += _gemm(n_tok, w, d, dt_b)
            out["other"] += OpCost(  # gates + scan
                flops=2.0 * n_tok * w * w * 2 + 10.0 * n_tok * w,
                bytes=6.0 * n_tok * w * dt_b,
            )
            _ffn_costs(cfg, out, n_tok, dt_b)
            return
        window = hy.window
        ctx = min(ctx, window)
    if cfg.sliding_window is not None:
        window = cfg.sliding_window
        ctx = min(ctx, window)

    if cfg.mla is not None:
        m = cfg.mla
        r = m.kv_lora_rank
        qk = m.qk_nope_dim + m.qk_rope_dim
        q_in = m.q_lora_rank if m.q_lora_rank > 0 else d
        if m.q_lora_rank > 0:
            out["linear"] += _gemm(n_tok, d, m.q_lora_rank, dt_b)
        out["linear"] += _gemm(n_tok, q_in, cfg.n_heads * qk, dt_b)
        out["linear"] += _gemm(n_tok, d, r + m.qk_rope_dim, dt_b)
        if mode == "prefill":
            out["linear"] += _gemm(n_tok, r, cfg.n_heads * (m.qk_nope_dim + m.v_head_dim), dt_b)
            att = OpCost(
                flops=2.0 * batch * cfg.n_heads * t * ctx * (qk + m.v_head_dim) / 2,
                bytes=dt_b * batch * ctx * (r + m.qk_rope_dim),
            )
        else:
            # absorbed decode: q·W_uk, scores vs latent, ctx·W_uv
            out["linear"] += OpCost(
                flops=2.0 * batch * cfg.n_heads * (m.qk_nope_dim * r + r * m.v_head_dim),
                bytes=dt_b * r * cfg.n_heads * (m.qk_nope_dim + m.v_head_dim),
            )
            att = OpCost(
                flops=2.0 * batch * cfg.n_heads * ctx * (r + m.qk_rope_dim + r),
                bytes=dt_b * batch * ctx * (r + m.qk_rope_dim),
            )
        out["attention"] += att
        out["linear"] += _gemm(n_tok, cfg.n_heads * m.v_head_dim, d, dt_b)
    else:
        out["linear"] += _gemm(n_tok, d, hq * dh, dt_b)
        out["linear"] += _gemm(n_tok, d, hkv * dh, dt_b)
        out["linear"] += _gemm(n_tok, d, hkv * dh, dt_b)
        out["linear"] += _gemm(n_tok, hq * dh, d, dt_b)
        causal_frac = 0.5 if (mode == "prefill" and window is None) else 1.0
        kv_bytes = dt_b * batch * ctx * hkv * dh * 2
        att_flops = 2.0 * batch * hq * t * ctx * dh * 2 * causal_frac
        out["attention"] += OpCost(
            flops=att_flops,
            bytes=kv_bytes + dt_b * n_tok * hq * dh * 2,
        )

    _ffn_costs(cfg, out, n_tok, dt_b, layer=layer)


def _ffn_costs(cfg, out, n_tok, dt_b, layer: int = 10 ** 9):
    d = cfg.d_model
    if cfg.moe is not None and layer >= cfg.moe.first_dense_layers:
        m = cfg.moe
        f = m.d_ff_expert
        active = m.top_k + m.n_shared_experts
        out["linear"] += OpCost(
            flops=2.0 * n_tok * d * f * 3 * active,
            # weight traffic: experts touched at least once — bounded by
            # min(n_experts, n_tok*top_k) experts' weights + activations
            bytes=dt_b * (min(m.n_experts, n_tok * m.top_k) + m.n_shared_experts)
            * 3 * d * f
            + dt_b * n_tok * d * 2 * active,
        )
        out["other"] += OpCost(  # router + dispatch/combine gathers
            flops=2.0 * n_tok * d * m.n_experts,
            bytes=dt_b * n_tok * d * 2,
        )
    else:
        ff = cfg.d_ff
        if cfg.moe is not None:
            ff = cfg.moe.d_ff_dense or cfg.d_ff
        out["linear"] += _gemm(n_tok, d, ff, dt_b)
        out["linear"] += _gemm(n_tok, d, ff, dt_b)
        out["linear"] += _gemm(n_tok, ff, d, dt_b)


def roofline_times(
    costs: Dict[str, OpCost],
    *,
    peak_flops: float = PEAK_FLOPS_BF16,
    hbm_bw: float = HBM_BW,
) -> Dict[str, float]:
    """Convert op-class costs to a per-class roofline time model (seconds,
    single chip). ``t = max(compute, memory)`` per class."""
    return {
        k: max(c.flops / peak_flops, c.bytes / hbm_bw) for k, c in costs.items()
    }
