"""Shared model primitives: inits, RMSNorm, RoPE, SwiGLU, embeddings —
counterparts of ``repro/models/layers.py``.

Params are nested dicts of tensors with the JAX tree paths as names, and
the JAX layout: ``dense`` weights are ``[d_in, d_out]`` applied as
``x @ w``. Param dtype follows ``cfg.dtype``; norms and RoPE run in f32,
the tied unembed in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"unsupported param dtype {cfg.dtype!r}")
    return _DTYPES[cfg.dtype]


def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)


def dense_init(gen, d_in: int, d_out: int, dtype, device):
    return {"w": (_normal(gen, (d_in, d_out), device) * d_in ** -0.5).to(dtype)}


def dense(p, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"]


def embedding_init(gen, vocab: int, d: int, dtype, device):
    return {"table": _normal(gen, (vocab, d), device).to(dtype)}


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def add_f32_table(p) -> None:
    """Keep an f32 copy of a non-f32 tied table beside it (``table_f32``),
    so the f32 unembed reads it instead of converting the table on every
    step; an f32 table needs no copy."""
    if p["table"].dtype != torch.float32:
        p["table_f32"] = p["table"].float()


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    """Tied LM head: logits = x @ table^T in f32 (stable softmax/argmax)."""
    table = p.get("table_f32", p["table"])
    return x.float() @ table.float().T


def rmsnorm_init(d: int, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5, impl: str = "auto") -> torch.Tensor:
    return ops.rmsnorm(x, p["scale"], eps=eps, impl=impl)


# ---- RoPE -----------------------------------------------------------------

def rope_frequencies(dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, T, H, D]; positions: [B, T]. Llama-style rotate-half (not
    interleaved), angles in f32."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, device=x.device)  # [D/2]
    angles = positions[..., None].float() * freqs  # [B, T, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---- SwiGLU FFN -----------------------------------------------------------

def ffn_init(gen, d: int, d_ff: int, dtype, device):
    return {
        "w1": dense_init(gen, d, d_ff, dtype, device),
        "w3": dense_init(gen, d, d_ff, dtype, device),
        "w2": dense_init(gen, d_ff, d, dtype, device),
    }


def ffn(p, x: torch.Tensor) -> torch.Tensor:
    return dense(p["w2"], F.silu(dense(p["w1"], x)) * dense(p["w3"], x))
