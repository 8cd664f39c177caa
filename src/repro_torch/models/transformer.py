"""Decoder-only transformer stack: dense (llama), early-fusion VLM
(chameleon, with qk-norm), MoE (qwen3-moe) and MLA + MoE (deepseek-v2) —
the counterpart of ``repro/models/transformer.py``. The family only changes
the blocks plugged into each layer: MLA (``attention.mla_attention``) for
GQA attention, and an MoE FFN (``moe.moe_ffn``, with shared experts) from
layer ``first_dense_layers`` on, the layers before it dense at
``d_ff_dense``.

Under tensor parallelism (``tp``, a rank's group; every family of this
stack, ``distributed/tp_pool.py``) the config carries the rank's widths and
the params its shard: each sublayer reduces its own row-parallel output
before the residual add its norm fuses — the attention (GQA or MLA: a
rank's heads over the whole latent) and the FFN after ``wo`` / ``w2``
(``layers.row_parallel``; deepseek's dense first layer at ``d_ff_dense /
tp``), a MoE layer its routed and shared partials in one reduce
(``moe.moe_ffn``) — the embedding is vocab-parallel, and the logits are
the rank's vocab slice (the engine's ``tp_*`` steps gather them). An
AutoQuant'd ``dyn`` row-parallel linear takes one max-reduce more for its
activation scale (``layers.dense``'s ``row_group``).

``qkv_bias`` (qwen2.5) adds a bias to the q/k/v projections. ``remat``
checkpoints each layer in a train forward (``torch.utils.checkpoint``). The
stacked ``scan_layers`` layout is not ported (``NotImplementedError``); a
JAX ``scanned`` param block is unstacked by ``repro_torch.bridge`` instead.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M

FAMILIES = ("dense", "vlm", "moe", "mla_moe")
MODES = ("train", "prefill", "decode", "extend", "mixed", "verify")


def check_supported(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r}: this stack serves {', '.join(FAMILIES)} models only")
    if cfg.scan_layers:
        raise NotImplementedError(
            "scan_layers: the port runs unrolled layers (bridge unstacks 'scanned')"
        )


def layer_uses_moe(cfg: ModelConfig, layer: int) -> bool:
    return cfg.moe is not None and layer >= cfg.moe.first_dense_layers


def dense_ff_width(cfg: ModelConfig) -> int:
    if cfg.moe is not None and cfg.moe.first_dense_layers > 0:
        return cfg.moe.d_ff_dense or cfg.d_ff
    return cfg.d_ff


def init_layer(gen, cfg: ModelConfig, layer: int, device):
    dt = L.param_dtype(cfg)
    p = {
        "attn_norm": L.rmsnorm_init(cfg.d_model, dt, device),
        "ffn_norm": L.rmsnorm_init(cfg.d_model, dt, device),
        "attn": (A.init_mla(gen, cfg, device) if cfg.mla is not None
                 else A.init_attention(gen, cfg, device)),
    }
    if layer_uses_moe(cfg, layer):
        p["moe"] = M.init_moe(gen, cfg, device)
    else:
        p["ffn"] = L.ffn_init(gen, cfg.d_model, dense_ff_width(cfg), dt, device)
    return p


def _layer_body(cfg: ModelConfig, p, x: torch.Tensor, h: torch.Tensor, *,
                positions: torch.Tensor, lengths: Optional[torch.Tensor],
                cache: Optional[dict], mode: str, impl: str,
                t_new: Optional[torch.Tensor] = None, tp=None, ep=None):
    """One layer from ``x`` and ``h = attn_norm(x)``: returns (x plus the
    attention's output, the FFN's residual delta, the new cache, the MoE
    aux loss or None). The attention's residual add runs in the ffn_norm's
    kernel; under ``tp`` each sublayer returns its output reduced over the
    ranks; under ``ep`` a MoE layer exchanges its tokens with the group's
    ranks (``moe.moe_ffn_ep``)."""
    kw = dict(positions=positions, lengths=lengths, cache=cache, mode=mode, impl=impl,
              t_new=t_new, tp=tp)
    if cfg.mla is not None:
        attn_out, new_cache = A.mla_attention(cfg, p["attn"], h, **kw)
    else:
        attn_out, new_cache = A.attention(cfg, p["attn"], h, window=cfg.sliding_window, **kw)
    x, h = L.add_rmsnorm(p["ffn_norm"], x, attn_out, cfg.rmsnorm_eps, impl=impl)
    if "moe" in p:
        delta, aux = M.moe_ffn(cfg, p["moe"], h, impl, tp, ep)
        return x, delta, new_cache, aux
    return x, L.ffn(p["ffn"], h, impl, tp), new_cache, None


def _layer_body_remat(cfg: ModelConfig, p, x: torch.Tensor, h: torch.Tensor, **kw):
    """``_layer_body`` activation-checkpointed (``cfg.remat``, the
    reference's ``_layer_forward_remat``): the layer's internals are
    recomputed in the backward pass instead of kept. Train mode only (no
    cache)."""
    def body(x_, h_):
        x_, delta, _, aux = _layer_body(cfg, p, x_, h_, **kw)
        return x_, delta, torch.zeros((), device=x_.device) if aux is None else aux

    x, delta, aux = torch.utils.checkpoint.checkpoint(body, x, h, use_reentrant=False)
    return x, delta, None, aux


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
    x, delta, new_cache, _ = _layer_body(cfg, p, x, h, positions=positions, lengths=lengths,
                                         cache=cache, mode=mode, impl=impl)
    return x + delta, new_cache


def init(cfg: ModelConfig, gen: torch.Generator, device):
    """Random params from ``gen`` (N(0,1) embeddings, fan-in-scaled dense
    weights, unit norm scales) on ``device``; tied non-f32 tables also get
    their f32 unembed copy (``layers.add_f32_table``)."""
    check_supported(cfg)
    dt = L.param_dtype(cfg)
    p = {
        "embed": L.embedding_init(gen, cfg.vocab_size, cfg.d_model, dt, device),
        "final_norm": L.rmsnorm_init(cfg.d_model, dt, device),
        "layers": [init_layer(gen, cfg, i, device) for i in range(cfg.n_layers)],
    }
    if cfg.tie_embeddings:
        L.add_f32_table(p["embed"])
    else:
        p["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size, dt, device)
    return p


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    """Per layer K/V [B, S, Hkv, D], or MLA's one latent [B, S, r + rope]."""
    check_supported(cfg)
    if cfg.mla is not None:
        mk = lambda: A.init_mla_cache(cfg, batch, max_len, device)  # noqa: E731
    else:
        mk = lambda: A.init_attention_cache(  # noqa: E731
            cfg, batch, max_len, device, window=cfg.sliding_window)
    return {"lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
            "layers": [mk() for _ in range(cfg.n_layers)]}


def forward(
    cfg: ModelConfig,
    params,
    batch: dict,
    *,
    cache: Optional[dict] = None,
    mode: str = "train",
    impl: str = "auto",
    n_layers: Optional[int] = None,
    advance: Optional[torch.Tensor] = None,
    tp=None,
    ep=None,
) -> Tuple[torch.Tensor, Optional[dict], dict]:
    """Returns (logits [B,T,V] f32, new_cache, aux dict). Cache buffers are
    updated in place; ``new_cache`` carries the same layer tensors and a
    new ``lengths``.

    A paged cache keeps ONE block table at its top level
    (``block_tables``); each layer sees it as ``bt`` in its own cache view,
    with the step's write rows and key validity computed once here
    (``attention.paged_addresses``), stripped again on return. ``mixed`` mode
    (paged only) advances each slot by its own ``batch["t_new"]`` tokens and
    returns logits [B, 1, V] at each slot's last valid lane, gathered before
    the final norm. ``verify`` mode (either cache) advances each slot by its
    ``t_new`` too and returns every lane's logits [B, C, V].

    ``n_layers`` runs only the first that many layers (LayerSkip's early
    exit, ``core/layerskip.py``): the last run layer's residual add goes into
    the final norm's kernel and the shared unembed follows; the other layers'
    caches are returned untouched. ``advance`` [B] replaces each slot's
    length bump in decode mode (a frozen draft slot advances 0). ``extend``
    mode (contiguous caches only) writes a window of T tokens per slot at
    ``lengths`` and advances each slot by T. ``tp`` (a rank's group) runs
    the rank's shard and returns its vocab slice of the logits. ``ep`` (a
    rank's expert-parallel group, ``tp_pool.ep_group``) runs every MoE layer
    through ``moe.moe_ffn_ep`` on the rank's tokens and its block of experts
    (``sharding.ep_param_specs``), as the reference's ``EP_MESH`` reaches
    every ``moe_ffn``; in a remat'd train forward the recomputed layers
    exchange again, in the same order on every rank."""
    check_supported(cfg)
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; the stack runs {MODES}")
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
    # lanes past t_new[b] are padding: their writes are dropped (contiguous)
    # or hit the sink block (paged), and their outputs are never read
    t_new = batch["t_new"].to(torch.int32) if mode in ("mixed", "verify") else None
    bt = cache.get("block_tables") if cache is not None else None
    if bt is not None and mode == "extend":
        raise NotImplementedError("extend unsupported on paged caches")
    # a paged step's table, write rows and key validity, and a contiguous
    # verify window's live lanes, are the same in every layer
    if bt is not None:
        block_size = next(iter(cache["layers"][0].values())).shape[1]  # K or the latent
        shared = dict(bt=bt, **A.paged_addresses(bt, lengths, block_size, mode, t_new, t))
    elif mode == "verify":
        first = cache["layers"][0]
        shared = A.window_addresses(lengths, t_new, t,
                                    (first["latent"] if "latent" in first else first["k"]).shape[1])
    else:
        shared = {}

    layers = params["layers"] if n_layers is None else params["layers"][:n_layers]
    x = L.embed(params["embed"], tokens, tp, cfg.vocab_size)
    # each layer's FFN residual add runs in the next norm's kernel: the next
    # layer's attn_norm, or the final norm after the last layer run
    norms = [lp["attn_norm"] for lp in layers] + [params["final_norm"]]
    h = L.rmsnorm(norms[0], x, cfg.rmsnorm_eps, impl=impl)
    new_layers = []
    aux_total = torch.zeros((), device=dev)
    for i, lp in enumerate(layers):
        lc = cache["layers"][i] if cache is not None else None
        if lc is not None and shared:
            lc = dict(lc, **shared)
        body = _layer_body_remat if cfg.remat and mode == "train" else _layer_body
        x, delta, nlc, aux = body(cfg, lp, x, h, positions=positions, lengths=lengths,
                                  cache=lc, mode=mode, impl=impl, t_new=t_new, tp=tp, ep=ep)
        if aux is not None:
            aux_total = aux_total + aux
        if bt is not None and nlc is not None:
            nlc = {k: v for k, v in nlc.items() if k != "bt"}
        if mode == "mixed" and i == len(layers) - 1:
            # only each slot's last valid lane is read (a decode slot's next
            # token, a finishing prefill's first): take it from both halves
            # of the pending residual before the final norm, so the norm and
            # the unembed run on one lane per slot
            lane = torch.clamp(t_new.long() - 1, min=0)
            rows = torch.arange(b, device=dev)
            x, delta = x[rows, lane][:, None], delta[rows, lane][:, None]
        x, h = L.add_rmsnorm(norms[i + 1], x, delta, cfg.rmsnorm_eps, impl=impl)
        new_layers.append(nlc)
    if cache is not None:  # the layers an early exit skipped keep their caches
        new_layers += cache["layers"][len(layers):]

    if cfg.tie_embeddings:
        logits = L.unembed(params["embed"], h)
    else:
        logits = L.dense(params["lm_head"], h, impl).float()

    new_cache = None
    if cache is not None:
        if mode == "prefill":
            new_len = batch.get("prompt_lengths")
            if new_len is None:
                new_len = torch.full((b,), t, dtype=torch.int32, device=dev)
            new_len = new_len.to(torch.int32)
        elif mode in ("mixed", "verify"):  # per-slot widths (0 = idle row)
            new_len = cache["lengths"] + t_new
        elif advance is not None:  # a draft step: frozen slots advance 0
            new_len = cache["lengths"] + advance.to(torch.int32)
        else:  # decode, extend
            new_len = cache["lengths"] + t
        new_cache = {"lengths": new_len, "layers": new_layers}
        if bt is not None:
            new_cache["block_tables"] = bt
    return logits, new_cache, {"aux_loss": aux_total}
