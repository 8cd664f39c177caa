"""Decoder-only transformer stack, dense family — the counterpart of
``repro/models/transformer.py`` for llama-style models.

MoE, MLA and the stacked ``scan_layers`` layout are not ported
(``NotImplementedError``); a JAX ``scanned`` param block is unstacked by
``repro_torch.bridge`` instead.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L


def check_supported(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r}: the port serves dense models only")
    if cfg.moe is not None or cfg.mla is not None:
        raise NotImplementedError("MoE / MLA blocks wait for a later slice of the port")
    if cfg.qkv_bias or cfg.qk_norm:
        raise NotImplementedError("qkv bias / qk-norm attention waits for a later slice")
    if cfg.scan_layers:
        raise NotImplementedError(
            "scan_layers: the port runs unrolled layers (bridge unstacks 'scanned')"
        )


def init_layer(gen, cfg: ModelConfig, device):
    dt = L.param_dtype(cfg)
    return {
        "attn_norm": L.rmsnorm_init(cfg.d_model, dt, device),
        "ffn_norm": L.rmsnorm_init(cfg.d_model, dt, device),
        "attn": A.init_attention(gen, cfg, device),
        "ffn": L.ffn_init(gen, cfg.d_model, cfg.d_ff, dt, device),
    }


def layer_forward(
    cfg: ModelConfig,
    p,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    lengths: Optional[torch.Tensor],
    cache: Optional[dict],
    mode: str,
    impl: str = "auto",
) -> Tuple[torch.Tensor, Optional[dict]]:
    h = L.rmsnorm(p["attn_norm"], x, cfg.rmsnorm_eps, impl=impl)
    attn_out, new_cache = A.attention(
        cfg, p["attn"], h, positions=positions, lengths=lengths, cache=cache,
        mode=mode, window=cfg.sliding_window, impl=impl,
    )
    x = x + attn_out
    h = L.rmsnorm(p["ffn_norm"], x, cfg.rmsnorm_eps, impl=impl)
    return x + L.ffn(p["ffn"], h), new_cache


def init(cfg: ModelConfig, gen: torch.Generator, device):
    """Random params from ``gen`` (N(0,1) embeddings, fan-in-scaled dense
    weights, unit norm scales) on ``device``; tied non-f32 tables also get
    their f32 unembed copy (``layers.add_f32_table``)."""
    check_supported(cfg)
    dt = L.param_dtype(cfg)
    p = {
        "embed": L.embedding_init(gen, cfg.vocab_size, cfg.d_model, dt, device),
        "final_norm": L.rmsnorm_init(cfg.d_model, dt, device),
        "layers": [init_layer(gen, cfg, device) for _ in range(cfg.n_layers)],
    }
    if cfg.tie_embeddings:
        L.add_f32_table(p["embed"])
    else:
        p["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size, dt, device)
    return p


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    check_supported(cfg)
    return {
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
        "layers": [
            A.init_attention_cache(cfg, batch, max_len, device, window=cfg.sliding_window)
            for _ in range(cfg.n_layers)
        ],
    }


def forward(
    cfg: ModelConfig,
    params,
    batch: dict,
    *,
    cache: Optional[dict] = None,
    mode: str = "train",
    impl: str = "auto",
) -> Tuple[torch.Tensor, Optional[dict], dict]:
    """Returns (logits [B,T,V] f32, new_cache, aux dict). Cache buffers are
    updated in place; ``new_cache`` carries the same layer tensors and a
    new ``lengths``."""
    check_supported(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise NotImplementedError(
            f"mode {mode!r} waits for a later slice of the port (train/prefill/decode only)"
        )
    tokens = batch["tokens"]
    b, t = tokens.shape
    dev = tokens.device
    steps = torch.arange(t, device=dev, dtype=torch.int32)[None]
    if mode == "train":
        positions = steps.expand(b, t)
        lengths = None
    else:
        lengths = cache["lengths"]
        positions = lengths[:, None] + steps

    x = L.embed(params["embed"], tokens)
    new_layers = []
    for i, lp in enumerate(params["layers"]):
        lc = cache["layers"][i] if cache is not None else None
        x, nlc = layer_forward(cfg, lp, x, positions=positions, lengths=lengths,
                               cache=lc, mode=mode, impl=impl)
        new_layers.append(nlc)

    x = L.rmsnorm(params["final_norm"], x, cfg.rmsnorm_eps, impl=impl)
    if cfg.tie_embeddings:
        logits = L.unembed(params["embed"], x)
    else:
        logits = L.dense(params["lm_head"], x).float()

    new_cache = None
    if cache is not None:
        if mode == "prefill":
            new_len = batch.get("prompt_lengths")
            if new_len is None:
                new_len = torch.full((b,), t, dtype=torch.int32, device=dev)
            new_len = new_len.to(torch.int32)
        else:  # decode
            new_len = cache["lengths"] + t
        new_cache = {"lengths": new_len, "layers": new_layers}
    return logits, new_cache, {"aux_loss": torch.zeros((), device=dev)}
