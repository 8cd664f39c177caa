"""Mamba-2 (SSD) model: attention-free, constant-size recurrent state — the
counterpart of ``repro/models/ssm.py``.

The "KV cache" of an SSM is a fixed [B, H, P, N] f32 state plus a
[B, d_conv - 1, conv_dim] convolution tail per layer, so the contiguous
slot pool holds it as it is: every leaf's axis 0 is the slot axis.

Under tensor parallelism (``distributed/tp_pool.py``) a rank holds its
share of the heads: its ``in_proj`` columns are ``z`` and ``x`` of its
heads, ``B`` and ``C`` whole (one group) and ``dt`` of its heads, its conv
channels ``x`` of its heads beside ``B`` and ``C`` whole, and ``out_proj``'s
rows of its channels; the scan and the decode step run at its heads, the
state and the conv tail hold them.

Train, prefill and extend run the chunked SSD scan (``ops.ssd_scan``: the
hand-written kernel on the card, its plain version on the CPU); decode is
the O(H.P.N) recurrence step ``ops.ssd_decode_step`` in plain torch, as
the reference computes it in XLA. Prefill scans the whole (right-padded)
prompt into the state and the conv tail, exactly as the reference does.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L

MODES = ("train", "prefill", "decode", "extend")


def _dims(cfg: ModelConfig):
    """(ssm config, d_inner, heads, conv channels) of the mixer this config
    runs: a tensor-parallel rank's (``ssm.shards`` > 1) holds its share of
    d_inner and of the heads, and the B and C groups whole."""
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model) // s.shards
    nh = s.n_heads(cfg.d_model) // s.shards
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return s, d_in, nh, conv_dim


def init_block(gen, cfg: ModelConfig, device):
    """One mixer's params from ``gen``, with the reference's distributions:
    ``A_log = log(linspace(1, 16))``, ``D = 1``, and ``dt_bias`` the
    softplus inverse of dt drawn log-uniform in [1e-3, 0.1]; those three stay
    f32 in every config."""
    s, d_in, nh, conv_dim = _dims(cfg)
    dt = L.param_dtype(cfg)
    d = cfg.d_model
    # in_proj -> [z (d_in), x (d_in), B (G*N), C (G*N), dt (nh)]
    out_w = 2 * d_in + 2 * s.n_groups * s.d_state + nh
    in_proj = L.dense_init(gen, d, out_w, dt, device)
    conv_w = (torch.randn((conv_dim, s.d_conv), generator=gen, device=device) * 0.2).to(dt)
    u = torch.rand((nh,), generator=gen, device=device)
    log_dt = math.log(1e-3) + u * (math.log(0.1) - math.log(1e-3))
    out_proj = L.dense_init(gen, d_in, d, dt, device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "D": torch.ones((nh,), **f32),
        "dt_bias": torch.log(torch.expm1(torch.exp(log_dt))),
        "gate_norm": L.rmsnorm_init(d_in, dt, device),
        "out_proj": out_proj,
    }


def init_block_cache(cfg: ModelConfig, batch: int, device):
    s, d_in, nh, conv_dim = _dims(cfg)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=L.param_dtype(cfg),
                            device=device),
        "state": torch.zeros((batch, nh, s.head_dim, s.d_state), dtype=torch.float32,
                             device=device),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d. xbc [B,T,C], w [C,W]. Returns (y, new_tail)."""
    width = w.shape[1]
    if tail is None:
        tail = torch.zeros((xbc.shape[0], width - 1, xbc.shape[2]), dtype=xbc.dtype,
                           device=xbc.device)
    xp = torch.cat([tail, xbc], dim=1)  # [B, T+W-1, C]
    t = xbc.shape[1]
    y = sum(xp[:, i : i + t] * w[:, i][None, None, :] for i in range(width))
    new_tail = xp[:, xp.shape[1] - (width - 1):]
    return y + b[None, None, :], new_tail


def block_forward(
    cfg: ModelConfig,
    p,
    x: torch.Tensor,  # [B, T, d]
    *,
    cache: Optional[dict],
    mode: str,
    impl: str = "auto",
    tp=None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """One mixer; under ``tp`` (a rank's group, its config ``ssm.shards``)
    at the rank's heads: the gate norm's sum of squares is reduced over the
    ranks (``ops.mul_silu_rmsnorm_split``) and ``out_proj``'s output too."""
    s, d_in, nh, conv_dim = _dims(cfg)
    b, t, _ = x.shape
    g, n, hp = s.n_groups, s.d_state, s.head_dim

    zxbcdt = L.dense(p["in_proj"], x, impl)  # [z | xBC (conv'd together) | dt]
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in : d_in + conv_dim]
    dt_raw = zxbcdt[..., d_in + conv_dim :]

    # decode/extend continue the conv from the cached tail; train/prefill
    # start from a zero conv state
    tail = cache["conv"] if cache is not None and mode in ("decode", "extend") else None
    xbc_conv, new_tail = _causal_conv(xbc, p["conv_w"], p["conv_b"], tail)
    xbc_conv = F.silu(xbc_conv)

    xs = xbc_conv[..., :d_in].reshape(b, t, nh, hp)
    B_ = xbc_conv[..., d_in : d_in + g * n].reshape(b, t, g, n)
    C = xbc_conv[..., d_in + g * n :].reshape(b, t, g, n)
    dt = F.softplus(dt_raw.float() + p["dt_bias"][None, None])
    A = -torch.exp(p["A_log"])

    if mode == "decode":
        y, new_state = ops.ssd_decode_step(
            xs[:, 0], dt[:, 0], A, B_[:, 0], C[:, 0], p["D"], cache["state"]
        )
        y = y[:, None]
    else:
        init_state = cache["state"] if mode == "extend" else None
        y, new_state = ops.ssd_scan(xs, dt, A, B_, C, p["D"], chunk=s.chunk_size,
                                    initial_state=init_state, impl=impl)
    # the gate y * silu(z) runs in the gate_norm's kernel, which reads z in
    # place (a slice of the input projection)
    if tp is None:
        y = L.mul_silu_rmsnorm(p["gate_norm"], y.reshape(b, t, d_in), z, cfg.rmsnorm_eps,
                               impl=impl)
    else:  # the norm is over all d_inner channels, the rank holds d_in of them
        y = ops.mul_silu_rmsnorm_split(y.reshape(b, t, d_in), z, p["gate_norm"]["scale"],
                                       d_in * s.shards, tp.all_reduce, cfg.rmsnorm_eps,
                                       impl=impl)
    out = L.row_parallel(p["out_proj"], y, impl, tp)

    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_tail.to(cache["conv"].dtype), "state": new_state}
    return out, new_cache


def init(cfg: ModelConfig, gen: torch.Generator, device):
    """Random params from ``gen`` on ``device``; the tied non-f32 table also
    gets its f32 unembed copy (``layers.add_f32_table``)."""
    dt = L.param_dtype(cfg)
    p = {
        "embed": L.embedding_init(gen, cfg.vocab_size, cfg.d_model, dt, device),
        "final_norm": L.rmsnorm_init(cfg.d_model, dt, device),
        "layers": [
            {"norm": L.rmsnorm_init(cfg.d_model, dt, device),
             "mixer": init_block(gen, cfg, device)}
            for _ in range(cfg.n_layers)
        ],
    }
    if cfg.tie_embeddings:
        L.add_f32_table(p["embed"])
    return p


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    del max_len  # constant-size state: the whole point
    return {
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
        "layers": [init_block_cache(cfg, batch, device) for _ in range(cfg.n_layers)],
    }


def forward(cfg: ModelConfig, params, batch: dict, *, cache: Optional[dict] = None,
            mode: str = "train", impl: str = "auto", tp=None):
    """Returns (logits [B,T,V] f32, new_cache, aux dict). ``new_cache``
    holds new conv-tail and state tensors and the new ``lengths``. ``tp``
    (a rank's group) runs the rank's shard: the embedding vocab-parallel
    when its table is split, each mixer at the rank's heads, and the
    logits the rank's vocab slice (the engine's ``tp_*`` steps gather
    them)."""
    if mode not in MODES:
        raise NotImplementedError(f"mode {mode!r}: the SSM runs {MODES}")
    tokens = batch["tokens"]
    b, t = tokens.shape
    x = L.embed(params["embed"], tokens, tp, cfg.vocab_size)
    # each block's residual add runs in the next norm's kernel: the next
    # layer's norm, or the final norm after the last layer
    norms = [lp["norm"] for lp in params["layers"]] + [params["final_norm"]]
    h = L.rmsnorm(norms[0], x, cfg.rmsnorm_eps, impl=impl)
    new_layers = []
    for i, lp in enumerate(params["layers"]):
        lc = cache["layers"][i] if cache is not None else None
        out, nlc = block_forward(cfg, lp["mixer"], h, cache=lc, mode=mode, impl=impl, tp=tp)
        x, h = L.add_rmsnorm(norms[i + 1], x, out, cfg.rmsnorm_eps, impl=impl)
        new_layers.append(nlc)
    logits = L.unembed(params["embed"], h)
    new_cache = None
    if cache is not None:
        if mode == "prefill":
            new_len = batch.get("prompt_lengths")
            if new_len is None:
                new_len = torch.full((b,), t, dtype=torch.int32, device=tokens.device)
            new_len = new_len.to(torch.int32)
        else:
            new_len = cache["lengths"] + t
        new_cache = {"lengths": new_len, "layers": new_layers}
    return logits, new_cache, {"aux_loss": torch.zeros((), device=h.device)}
