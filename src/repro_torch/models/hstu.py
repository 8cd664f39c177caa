"""HSTU generative DLRM (the paper's fourth workload, §2.1.4) — the
counterpart of ``repro/models/hstu.py``.

Hierarchical Sequential Transduction Unit: a stack of identical layers with
(1) pointwise projection U,V,Q,K, (2) spatial aggregation via
pointwise-normalized SiLU attention with a learned relative position bias
(NO softmax; ``ops.hstu_attention``, the hand-written kernel on the card),
(3) pointwise transformation with elementwise gating.

Non-autoregressive: one forward scores every position (paper Obs #1 — no
decode loop, so ``init_cache`` raises). Layers >= ``FULL_ATTN_LAYERS`` cap
the attention context at ``hstu_max_attn_len`` (paper §3.1).

Heads: retrieval (next item over the item vocabulary, weight-tied) and
ranking (engagement-type logits per position, in ``aux``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L

N_ENGAGEMENT_TYPES = 8
MAX_REL_POS = 2048
FULL_ATTN_LAYERS = 3  # layers below this attend over the full sequence


def init_layer(gen, cfg: ModelConfig, device):
    dt = L.param_dtype(cfg)
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {
        "norm": L.rmsnorm_init(d, dt, device),
        "uvqk": L.dense_init(gen, d, 4 * h * dh, dt, device),
        "rel_bias": torch.randn((2 * MAX_REL_POS - 1,), generator=gen, device=device,
                                dtype=torch.float32) * 0.02,  # f32 in every config
        "out_norm": L.rmsnorm_init(h * dh, dt, device),
        "out": L.dense_init(gen, h * dh, d, dt, device),
    }


def _layer_delta(cfg: ModelConfig, p, hx: torch.Tensor, *, layer: int, lengths,
                 impl: str) -> torch.Tensor:
    """One layer's residual delta from ``hx = norm(x)``. The gate product
    ``attn * u`` runs in the out_norm's kernel, which reads ``u`` in place
    (a slice of the U,V,Q,K projection)."""
    b, t, _ = hx.shape
    h, dh = cfg.n_heads, cfg.head_dim
    uvqk = F.silu(L.dense(p["uvqk"], hx, impl)).reshape(b, t, 4, h, dh)
    u, v, q, k = (uvqk[:, :, i] for i in range(4))  # this order, as the reference
    max_len = cfg.hstu_max_attn_len if layer >= FULL_ATTN_LAYERS else None
    attn = ops.hstu_attention(q, k, v, p["rel_bias"], max_attn_len=max_len,
                              lengths=lengths, impl=impl)
    gated = L.mul_rmsnorm(p["out_norm"], attn.reshape(b, t, h * dh),
                          u.reshape(b, t, h * dh), cfg.rmsnorm_eps, impl=impl)
    return L.dense(p["out"], gated, impl)


def layer_forward(cfg: ModelConfig, p, x: torch.Tensor, *, layer: int, lengths=None,
                  impl: str = "auto") -> torch.Tensor:
    hx = L.rmsnorm(p["norm"], x, cfg.rmsnorm_eps, impl=impl)
    return x + _layer_delta(cfg, p, hx, layer=layer, lengths=lengths, impl=impl)


def init(cfg: ModelConfig, gen: torch.Generator, device):
    """Random params from ``gen`` (N(0, 1) item embeddings, fan-in-scaled
    dense weights, unit norm scales, an f32 N(0, 0.02) bias table per
    layer) on ``device``."""
    dt = L.param_dtype(cfg)
    return {
        "embed": L.embedding_init(gen, cfg.vocab_size, cfg.d_model, dt, device),
        "final_norm": L.rmsnorm_init(cfg.d_model, dt, device),
        "ranking_head": L.dense_init(gen, cfg.d_model, N_ENGAGEMENT_TYPES, dt, device),
        "layers": [init_layer(gen, cfg, device) for _ in range(cfg.n_layers)],
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    raise NotImplementedError(
        "HSTU is non-autoregressive (paper Obs #1): no decode loop, no cache."
    )


def forward(cfg: ModelConfig, params, batch: dict, *, cache=None, mode: str = "train",
            impl: str = "auto"):
    """batch: {"tokens": [B, T] item-id history, "lengths": optional [B]}.

    Returns retrieval logits [B, T, vocab] f32 (next-item prediction); the
    ranking logits [B, T, N_ENGAGEMENT_TYPES] f32 are in aux."""
    if cache is not None or mode not in ("train", "prefill"):
        raise ValueError("HSTU is non-autoregressive: train/prefill without a cache only")
    tokens = batch["tokens"]
    lengths = batch.get("lengths")
    x = L.embed(params["embed"], tokens)
    # each layer's residual add runs in the next norm's kernel: the next
    # layer's norm, or the final norm after the last layer
    norms = [lp["norm"] for lp in params["layers"]] + [params["final_norm"]]
    h = L.rmsnorm(norms[0], x, cfg.rmsnorm_eps, impl=impl)
    for i, lp in enumerate(params["layers"]):
        delta = _layer_delta(cfg, lp, h, layer=i, lengths=lengths, impl=impl)
        x, h = L.add_rmsnorm(norms[i + 1], x, delta, cfg.rmsnorm_eps, impl=impl)
    retrieval = L.unembed(params["embed"], h)
    ranking = L.dense(params["ranking_head"], h, impl).float()
    return retrieval, None, {"aux_loss": torch.zeros((), device=h.device),
                             "ranking_logits": ranking}
