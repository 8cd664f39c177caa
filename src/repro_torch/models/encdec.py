"""Whisper-style encoder-decoder (the paper's Seamless analogue, §2.1.3) —
the counterpart of ``repro/models/encdec.py``.

The mel-spectrogram + conv frontend is stubbed: the encoder consumes
precomputed frame embeddings [B, n_frames, d_model]. Downstream is real: a
bidirectional encoder (sinusoid positions, no RoPE), an autoregressive
decoder with a self-attention KV cache and a cross-attention K/V cache, the
latter computed once at prefill and written into the preallocated cache in
place (Seamless's "only the text decoder is autoregressive" profile, paper
Obs #2). Cross-attention is the flash kernel against the cached K/V with
zero positions, ``causal=False`` and ``k_valid = arange(F) <
frame_lengths``, at every step (Tq = 1 in decode), as the reference runs it.

Every residual add runs in the next norm's kernel (``layers.add_rmsnorm``),
as in the dense stack: a forward launches RMSNorm once with no prologue
and 2 (encoder) or 3 (decoder) times a layer with ``add``. The logits are
``dense(lm_head)`` then f32 (no tied unembed).

Under tensor parallelism (``distributed/tp_pool.py``) a rank's config
carries its heads and FFN columns and its params the matching shard: the
encoder, the decoder's self- and cross-attention (its cross K/V heads,
computed and written once at prefill) and the FFNs run at the rank's
widths and reduce after ``wo`` and ``w2``: 2 reduces an encoder layer and
3 a decoder layer. A vocabulary that does not split (whisper's 51865)
leaves ``embed`` and ``lm_head`` whole on every rank, as the reference's
specs do: no reduce for the lookup and no gather of the logits.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import layers as L

MODES = ("train", "prefill", "decode")


def init_encoder_layer(gen, cfg: ModelConfig, device):
    dt = L.param_dtype(cfg)
    return {
        "attn_norm": L.rmsnorm_init(cfg.d_model, dt, device),
        "attn": A.init_attention(gen, cfg, device),
        "ffn_norm": L.rmsnorm_init(cfg.d_model, dt, device),
        "ffn": L.ffn_init(gen, cfg.d_model, cfg.d_ff, dt, device),
    }


def init_decoder_layer(gen, cfg: ModelConfig, device):
    dt = L.param_dtype(cfg)
    return {
        "self_norm": L.rmsnorm_init(cfg.d_model, dt, device),
        "self_attn": A.init_attention(gen, cfg, device),
        "cross_norm": L.rmsnorm_init(cfg.d_model, dt, device),
        "cross_attn": A.init_attention(gen, cfg, device),
        "ffn_norm": L.rmsnorm_init(cfg.d_model, dt, device),
        "ffn": L.ffn_init(gen, cfg.d_model, cfg.d_ff, dt, device),
    }


def init(cfg: ModelConfig, gen: torch.Generator, device):
    """Random params from ``gen`` on ``device``, in the reference's tree."""
    ed = cfg.encdec
    dt = L.param_dtype(cfg)
    return {
        "embed": L.embedding_init(gen, cfg.vocab_size, cfg.d_model, dt, device),
        "lm_head": L.dense_init(gen, cfg.d_model, cfg.vocab_size, dt, device),
        "enc_norm": L.rmsnorm_init(cfg.d_model, dt, device),
        "dec_norm": L.rmsnorm_init(cfg.d_model, dt, device),
        "encoder": [init_encoder_layer(gen, cfg, device) for _ in range(ed.n_encoder_layers)],
        "decoder": [init_decoder_layer(gen, cfg, device) for _ in range(cfg.n_layers)],
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    """Self K/V of at most ``max_target_len`` rows, and the cross K/V over
    the encoder frames [B, n_frames, Hkv, D], written once at prefill."""
    ed = cfg.encdec
    dt = L.param_dtype(cfg)
    max_len = min(max_len, ed.max_target_len)
    shape = (batch, ed.n_frames, cfg.n_kv_heads, cfg.head_dim)
    return {
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
        "frame_lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
        "layers": [
            {"self": A.init_attention_cache(cfg, batch, max_len, device),
             "cross_k": torch.zeros(shape, dtype=dt, device=device),
             "cross_v": torch.zeros(shape, dtype=dt, device=device)}
            for _ in range(cfg.n_layers)
        ],
    }


def bidirectional_stack(cfg: ModelConfig, layers, x: torch.Tensor, final_norm,
                        impl: str = "auto", tp=None) -> torch.Tensor:
    """Pre-norm bidirectional layers (attention, then SwiGLU) over ``x`` [B,
    T, d] and the final norm; every residual add fused into the next norm.
    The encoder and Seamless's T2U share it. Under ``tp`` the layers are a
    rank's shard, and the attention and the FFN reduce their outputs."""
    b, t, _ = x.shape
    positions = torch.arange(t, device=x.device, dtype=torch.int32)[None].expand(b, t)
    norms = [lp["attn_norm"] for lp in layers] + [final_norm]
    h = L.rmsnorm(norms[0], x, cfg.rmsnorm_eps, impl=impl)
    for i, lp in enumerate(layers):
        out, _ = A.attention(cfg, lp["attn"], h, positions=positions, lengths=None,
                             cache=None, mode="train", impl=impl, bidirectional=True, tp=tp)
        x, h = L.add_rmsnorm(lp["ffn_norm"], x, out, cfg.rmsnorm_eps, impl=impl)
        x, h = L.add_rmsnorm(norms[i + 1], x, L.ffn(lp["ffn"], h, impl, tp), cfg.rmsnorm_eps,
                             impl=impl)
    return h


def encode(cfg: ModelConfig, params, frames: torch.Tensor, impl: str = "auto",
           tp=None) -> torch.Tensor:
    """frames: [B, F, d] stubbed frontend output -> encoder states [B, F, d]
    (whole on every rank under ``tp``)."""
    _, f, d = frames.shape
    x = frames + L.sinusoid_positions(f, d, frames.device).to(frames.dtype)[None]
    return bidirectional_stack(cfg, params["encoder"], x, params["enc_norm"], impl, tp)


def _cross_kv(cfg: ModelConfig, p, enc: torch.Tensor,
              impl: str) -> Tuple[torch.Tensor, torch.Tensor]:
    b, f, _ = enc.shape
    k = L.dense(p["wk"], enc, impl).reshape(b, f, cfg.n_kv_heads, cfg.head_dim)
    v = L.dense(p["wv"], enc, impl).reshape(b, f, cfg.n_kv_heads, cfg.head_dim)
    return k, v


def _cross_inputs(b: int, t: int, frame_lengths: torch.Tensor, f: int) -> dict:
    """What every layer's cross-attention shares in one forward, made once:
    zero query and key positions and ``k_valid`` [B, F]."""
    dev = frame_lengths.device
    return {"q_positions": torch.zeros((b, t), dtype=torch.int32, device=dev),
            "k_positions": torch.zeros((b, f), dtype=torch.int32, device=dev),
            "k_valid": torch.arange(f, device=dev)[None] < frame_lengths[:, None]}


def _cross_attention(cfg: ModelConfig, p, x: torch.Tensor, cross_k: torch.Tensor,
                     cross_v: torch.Tensor, masks: dict, impl: str, tp=None) -> torch.Tensor:
    """Decoder -> encoder attention against the cross K/V: flash attention,
    non-causal, the frames past each row's ``frame_lengths`` masked; under
    ``tp`` at the rank's heads, ``wo``'s output reduced."""
    b, t, _ = x.shape
    hq, dh = cfg.n_heads, cfg.head_dim
    q = L.dense(p["wq"], x, impl).reshape(b, t, hq, dh)
    out = ops.flash_attention(q, cross_k, cross_v, causal=False, impl=impl, **masks)
    return L.row_parallel(p["wo"], out.reshape(b, t, hq * dh), impl, tp)


def forward(
    cfg: ModelConfig,
    params,
    batch: dict,
    *,
    cache: Optional[dict] = None,
    mode: str = "train",
    impl: str = "auto",
    tp=None,
):
    """batch: {"frames": [B, F, d] (train/prefill), "frame_lengths": [B]
    (optional, default F), "tokens": [B, T]}.

    train:   teacher-forced decoder over the full target (encoder inline).
    prefill: runs the encoder once, writes the cross K/V and frame lengths
             into the cache in place, prefills the decoder's self K/V.
    decode:  one decoder token against both caches (the encoder is not run).

    ``tp`` (a rank's group) runs the rank's shard: the encoder, the self and
    cross attention at its heads (its cross K/V heads written at prefill)
    and the FFN at its columns, each reducing its output; the embedding and
    the LM head vocab-parallel when the vocabulary splits (the logits then
    the rank's slice), else whole.

    Returns (logits [B, T, V] f32, new_cache, aux)."""
    if mode not in MODES:
        raise NotImplementedError(f"mode {mode!r}: the encoder-decoder runs {MODES}")
    tokens = batch["tokens"]
    b, t = tokens.shape
    dev = tokens.device

    if mode in ("train", "prefill"):
        enc = encode(cfg, params, batch["frames"], impl=impl, tp=tp)
        f = enc.shape[1]
        frame_lengths = batch.get("frame_lengths")
        if frame_lengths is None:
            frame_lengths = torch.full((b,), f, dtype=torch.int32, device=dev)
        frame_lengths = frame_lengths.to(device=dev, dtype=torch.int32)
        if cache is not None:
            cache["frame_lengths"].copy_(frame_lengths)
            frame_lengths = cache["frame_lengths"]
            f = cache["layers"][0]["cross_k"].shape[1]  # the rows written below
    else:
        enc = None
        frame_lengths = cache["frame_lengths"]
        f = cache["layers"][0]["cross_k"].shape[1]
    masks = _cross_inputs(b, t, frame_lengths, f)

    steps = torch.arange(t, device=dev, dtype=torch.int32)[None]
    if cache is None:
        positions, lengths = steps.expand(b, t), None
    else:
        lengths = cache["lengths"]
        positions = lengths[:, None] + steps

    layers = params["decoder"]
    norms = [lp["self_norm"] for lp in layers] + [params["dec_norm"]]
    x = L.embed(params["embed"], tokens, tp, cfg.vocab_size)
    h = L.rmsnorm(norms[0], x, cfg.rmsnorm_eps, impl=impl)
    new_layers = []
    for i, lp in enumerate(layers):
        lc = cache["layers"][i] if cache is not None else None
        out, new_self = A.attention(
            cfg, lp["self_attn"], h, positions=positions, lengths=lengths,
            cache=None if lc is None else lc["self"], mode=mode, impl=impl, tp=tp,
        )
        x, h = L.add_rmsnorm(lp["cross_norm"], x, out, cfg.rmsnorm_eps, impl=impl)
        if mode == "decode":
            ck, cv = lc["cross_k"], lc["cross_v"]
        else:
            ck, cv = _cross_kv(cfg, lp["cross_attn"], enc, impl)
            if lc is not None:  # written once, in place
                ck = A.write_prefill(lc["cross_k"], ck)
                cv = A.write_prefill(lc["cross_v"], cv)
        x, h = L.add_rmsnorm(lp["ffn_norm"], x,
                             _cross_attention(cfg, lp["cross_attn"], h, ck, cv, masks, impl,
                                              tp),
                             cfg.rmsnorm_eps, impl=impl)
        x, h = L.add_rmsnorm(norms[i + 1], x, L.ffn(lp["ffn"], h, impl, tp), cfg.rmsnorm_eps,
                             impl=impl)
        if lc is not None:
            new_layers.append({"self": new_self, "cross_k": ck, "cross_v": cv})
    logits = L.dense(params["lm_head"], h, impl).float()

    new_cache = None
    if cache is not None:
        if mode == "prefill":
            new_len = batch.get("prompt_lengths")
            if new_len is None:
                new_len = torch.full((b,), t, dtype=torch.int32, device=dev)
            new_len = new_len.to(torch.int32)
        else:
            new_len = cache["lengths"] + t
        new_cache = {"lengths": new_len, "frame_lengths": frame_lengths,
                     "layers": new_layers}
    return logits, new_cache, {"aux_loss": torch.zeros((), device=dev)}
