"""Griffin / RecurrentGemma: RG-LRU recurrent blocks and local (sliding
window) attention, interleaved by a fixed pattern (2 recurrent : 1
attention) — the counterpart of ``repro/models/hybrid.py``.

Decode state is bounded: a [B, lru_width] f32 recurrent state and a
[B, conv_width - 1, lru_width] conv tail a recurrent block, and a ring of
``min(max_len, window)`` K/V rows an attention block
(``attention.init_attention_cache(window=...)``). Every cache leaf's axis 0
is the slot axis, so the contiguous slot pool holds the tree as it is; the
paged pool refuses the family, and speculative decoding too (a recurrent
state cannot be rewound).

The RG-LRU recurrence is h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t) with
a_t = exp(-c softplus(Λ) r_t), gates and state in f32. Train and prefill
evaluate it with a log-depth (Hillis-Steele) scan in plain torch, the
counterpart of the reference's ``jax.lax.associative_scan`` (XLA, not a
Pallas kernel): ceil(log2 T) rounds of a few elementwise launches, where a
loop over time would launch T times a layer; decode is the T = 1 case of
the same code, the carried state folded into step 0. Prefill scans the
whole right-padded prompt into the state and the conv tail, as the
reference does.

Each residual add runs in the next norm's kernel (``layers.add_rmsnorm``),
as in ``transformer.py``: a forward launches RMSNorm once without a
prologue and 2 x n_layers times with the add.

Under tensor parallelism (``tp``, a rank's group; ``distributed/tp_pool.py``)
a rank's config holds its ``lru_width / tp`` channels and its q heads, and
its params the matching shard: a recurrent block's ``proj_x`` /
``proj_gate`` columns, conv, decay and gate columns (with their biases) at
its channels, ``proj_out``'s rows; an attention block's ``wq`` columns and
``wo`` rows, with ``wk`` / ``wv`` whole (one KV head). A recurrent block
gathers the post-conv input whole for the gates (one exact reduce of the
zero-padded [B, T, lru_width]) and reduces ``proj_out``'s output; an
attention block reduces ``wo``'s, the FFN ``w2``'s, and the embedding and
the logits are vocab-split. A ring splits along its rows where ``S =
min(max_len, window)`` divides ``tp`` (the layer cache ``{"seq_shard":
{"k", "v"}}`` holds the rank's rows, ``attention(seq_split=True)``), else it
is whole on every rank. A forward reduces 3 a recurrent layer, 2 an
attention layer (4 in a decode step over a split ring: the q heads'
gather and the partials' exchange) and 2 for the vocabulary.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.ssm import _causal_conv

RG_LRU_C = 8.0
MODES = ("train", "prefill", "decode")


def lam_init(width: int, device) -> torch.Tensor:
    """Λ such that a = 0.9 .. 0.999 at r = 1 (stable long memory): the
    reference's deterministic f32 ``log(expm1(-log(linspace(0.9, 0.999, w))
    / c))``, not a random draw."""
    a = torch.linspace(0.9, 0.999, width, dtype=torch.float32, device=device)
    return torch.log(torch.expm1(-torch.log(a) / RG_LRU_C))


def init_recurrent_block(gen, cfg: ModelConfig, device):
    hy = cfg.hybrid
    dt = L.param_dtype(cfg)
    d, w = cfg.d_model, hy.lru_width
    return {
        "proj_x": L.dense_init(gen, d, w, dt, device),
        "proj_gate": L.dense_init(gen, d, w, dt, device),
        "conv_w": (torch.randn((w, hy.conv_width), generator=gen, device=device) * 0.2).to(dt),
        "conv_b": torch.zeros((w,), dtype=dt, device=device),
        "gate_a": L.dense_init(gen, w, w, dt, device, bias=True),
        "gate_x": L.dense_init(gen, w, w, dt, device, bias=True),
        "lam": lam_init(w, device),
        "proj_out": L.dense_init(gen, w, d, dt, device),
    }


def init_recurrent_cache(cfg: ModelConfig, batch: int, device):
    hy = cfg.hybrid
    return {
        "state": torch.zeros((batch, hy.lru_width), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, hy.conv_width - 1, hy.lru_width),
                            dtype=L.param_dtype(cfg), device=device),
    }


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along axis 1, as an inclusive
    Hillis-Steele scan of the reference's combine ``(a1, b1), (a2, b2) ->
    (a1 a2, a2 b1 + b2)``: round s folds each step's pair into the pair s
    steps back. ceil(log2 T) rounds, each building new tensors (autograd
    can differentiate it); ``a`` and ``b`` are not modified."""
    s = 1
    while s < a.shape[1]:
        b = torch.cat([b[:, :s], b[:, s:] + a[:, s:] * b[:, :-s]], dim=1)
        a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return b


def _rg_lru(p, x: torch.Tensor, h0: Optional[torch.Tensor],
            impl: str = "auto", tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, T, W] (post-conv). Returns (h [B, T, W] f32, h_final [B, W]).
    Under ``tp`` W is the rank's channels: the gates read x gathered whole
    and give the rank's columns."""
    xf = x.float()
    xg = L.gather_last(x, tp)
    r = torch.sigmoid(L.dense(p["gate_a"], xg, impl).float())
    i = torch.sigmoid(L.dense(p["gate_x"], xg, impl).float())
    log_a = -RG_LRU_C * F.softplus(p["lam"])[None, None] * r  # [B, T, W] <= 0
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    if h0 is not None:
        # fold the carried state into the first step: b_0' = a_0 h0 + b_0
        gated[:, 0] += a[:, 0] * h0
    h = linear_scan(a, gated)
    return h, h[:, -1]


def recurrent_block_forward(cfg: ModelConfig, p, x: torch.Tensor, *, cache: Optional[dict],
                            mode: str, impl: str = "auto", tp=None):
    """The recurrent block: a GELU (tanh) gate branch beside the conv and
    RG-LRU branch, their product projected back to d_model. The conv tail
    continues from the cache in decode only; train and prefill start from
    zeros. ``tp``: the rank's channels, ``proj_out``'s output reduced.
    Returns (out, new cache of new tensors, or None)."""
    gate = F.gelu(L.dense(p["proj_gate"], x, impl), approximate="tanh")
    xb = L.dense(p["proj_x"], x, impl)
    tail = cache["conv"] if (cache is not None and mode == "decode") else None
    xc, new_tail = _causal_conv(xb, p["conv_w"], p["conv_b"], tail)
    h, h_final = _rg_lru(p, xc, cache["state"] if mode == "decode" else None, impl, tp)
    out = L.row_parallel(p["proj_out"], h.to(x.dtype) * gate, impl, tp)
    new_cache = None
    if cache is not None:
        new_cache = {"state": h_final, "conv": new_tail.to(cache["conv"].dtype)}
    return out, new_cache


def init(cfg: ModelConfig, gen: torch.Generator, device):
    """Random params from ``gen`` on ``device``: per layer ``norm``,
    ``ffn_norm``, a SwiGLU ``ffn`` and ``attn`` (MQA projections) or ``rec``
    (the recurrent block) by the pattern; the tied non-f32 table also gets
    its f32 unembed copy (``layers.add_f32_table``)."""
    hy = cfg.hybrid
    dt = L.param_dtype(cfg)
    layers = []
    for i in range(cfg.n_layers):
        lp = {"norm": L.rmsnorm_init(cfg.d_model, dt, device),
              "ffn_norm": L.rmsnorm_init(cfg.d_model, dt, device)}
        if hy.block_kind(i) == "attention":
            lp["attn"] = A.init_attention(gen, cfg, device)
        else:
            lp["rec"] = init_recurrent_block(gen, cfg, device)
        lp["ffn"] = L.ffn_init(gen, cfg.d_model, cfg.d_ff, dt, device)
        layers.append(lp)
    p = {"embed": L.embedding_init(gen, cfg.vocab_size, cfg.d_model, dt, device),
         "final_norm": L.rmsnorm_init(cfg.d_model, dt, device),
         "layers": layers}
    L.add_f32_table(p["embed"])
    return p


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device, tp=None):
    """Per layer a K/V ring (attention) or the state and conv tail
    (recurrent), beside ``lengths``. Under ``tp`` (a rank's group) a ring of
    ``S = min(max_len, window)`` rows that divide ``tp.size`` is split along
    them: ``{"seq_shard": {"k", "v"}}`` of the rank's ``S / tp.size`` rows
    (``sharding.cache_specs_tp``'s sequence fallback); any other ring is
    whole on every rank (without a window: a cache of ``max_len`` rows, the
    same way)."""
    hy = cfg.hybrid
    s = min(max_len, hy.window) if hy.window else max_len
    split = tp is not None and tp.size > 1 and s % tp.size == 0
    layers = []
    for i in range(cfg.n_layers):
        if hy.block_kind(i) == "attention" and split:
            layers.append({"seq_shard": A.init_attention_cache(cfg, batch, s // tp.size,
                                                               device)})
        elif hy.block_kind(i) == "attention":
            layers.append(A.init_attention_cache(cfg, batch, max_len, device,
                                                 window=hy.window))
        else:
            layers.append(init_recurrent_cache(cfg, batch, device))
    return {"lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
            "layers": layers}


def forward(cfg: ModelConfig, params, batch: dict, *, cache: Optional[dict] = None,
            mode: str = "train", impl: str = "auto", tp=None):
    """Returns (logits [B, T, V] f32, new_cache, aux dict). The rings are
    written in place; the recurrent layers' entries of ``new_cache`` are new
    tensors. Prefill takes ``prompt_lengths`` as the new lengths. ``tp`` (a
    rank's group) runs the rank's shard; the logits are then its vocab
    slice (the engine's ``tp_*`` steps gather them)."""
    if mode not in MODES:
        raise NotImplementedError(f"mode {mode!r}: the hybrid runs {MODES}")
    hy = cfg.hybrid
    tokens = batch["tokens"]
    b, t = tokens.shape
    dev = tokens.device
    steps = torch.arange(t, device=dev, dtype=torch.int32)[None]
    if mode == "train" or cache is None:
        positions, lengths = steps.expand(b, t), None
    else:
        lengths = cache["lengths"]
        positions = lengths[:, None] + steps

    x = L.embed(params["embed"], tokens, tp, cfg.vocab_size)
    # each residual add runs in the next norm's kernel: the block's output
    # in the ffn_norm's, the FFN's in the next layer's norm (or the final)
    norms = [lp["norm"] for lp in params["layers"]] + [params["final_norm"]]
    h = L.rmsnorm(norms[0], x, cfg.rmsnorm_eps, impl=impl)
    new_layers = []
    for i, lp in enumerate(params["layers"]):
        lc = cache["layers"][i] if cache is not None else None
        if hy.block_kind(i) == "attention":
            split = lc is not None and "seq_shard" in lc
            out, nlc = A.attention(cfg, lp["attn"], h, positions=positions, lengths=lengths,
                                   cache=lc["seq_shard"] if split else lc, mode=mode,
                                   window=hy.window, impl=impl, tp=tp, seq_split=split)
            if split:
                nlc = {"seq_shard": nlc}
        else:
            out, nlc = recurrent_block_forward(cfg, lp["rec"], h, cache=lc, mode=mode,
                                               impl=impl, tp=tp)
        x, h = L.add_rmsnorm(lp["ffn_norm"], x, out, cfg.rmsnorm_eps, impl=impl)
        x, h = L.add_rmsnorm(norms[i + 1], x, L.ffn(lp["ffn"], h, impl, tp), cfg.rmsnorm_eps,
                             impl=impl)
        new_layers.append(nlc)
    logits = L.unembed(params["embed"], h)
    new_cache = None
    if cache is not None:
        if mode == "prefill":
            new_len = batch.get("prompt_lengths")
            if new_len is None:
                new_len = torch.full((b,), t, dtype=torch.int32, device=dev)
            new_len = new_len.to(torch.int32)
        else:
            new_len = cache["lengths"] + t
        new_cache = {"lengths": new_len, "layers": new_layers}
    return logits, new_cache, {"aux_loss": torch.zeros((), device=dev)}
