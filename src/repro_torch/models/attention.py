"""GQA attention block with static-KV-cache integration — the dense,
contiguous part of ``repro/models/attention.py``.

Cache discipline: buffers are allocated once at a static max length;
per-slot ``lengths`` counters select the write position; decode attends
under a validity mask. Every cache write here goes IN PLACE into the
preallocated buffers — the port's counterpart of the reference's donated
jitted updates — so the returned cache dict holds the same tensors it was
given.

Modes:
- ``train``:   no cache; full causal flash attention.
- ``prefill``: writes the prompt's K/V into the cache (slot-aligned, the
               rest of the row zeroed) and attends causally over the
               in-flight K/V.
- ``decode``:  one token per slot; write at ``lengths % cache_len``, then
               flash-decode over the cache with ``n_valid = min(lengths + 1,
               cache_len)``.

Not ported yet (each raises ``NotImplementedError``): the paged block-table
cache with the ``mixed``/``verify`` modes (next slice: paged + chunked
serving), ``extend``, ring/sliding-window caches, the sequence-parallel
decode (``SP_MESH``) and MLA.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L

_NEXT_SLICE = "the paged + chunked serving slice of the port"


# --------------------------------------------------------------------------
# cache write helpers (in place)
# --------------------------------------------------------------------------

def write_prefill(buf: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Write [B, T, ...] into [B, S, ...] at offset 0 and zero the rest of
    each row (the reference pads ``new`` to S). Ring caches (T > S) are not
    ported."""
    s, t = buf.shape[1], new.shape[1]
    if t > s:
        raise NotImplementedError(
            f"ring-buffer prefill (T={t} > cache {s}) waits for the port's window caches"
        )
    buf[:, :t].copy_(new)
    buf[:, t:].zero_()
    return buf


def write_decode(buf: torch.Tensor, new: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Write one entry per batch row: buf [B,S,...], new [B,...], idx [B]."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    buf[rows, idx.long()] = new.to(buf.dtype)
    return buf


def write_slot_row(buf: torch.Tensor, row: torch.Tensor, slot: int) -> torch.Tensor:
    """Replace one sequence slot of a pooled buffer: buf [B, ...] gets
    row [1, ...] at batch index ``slot`` (the continuous-batching refill
    write)."""
    buf[slot].copy_(row[0].to(buf.dtype))
    return buf


def valid_counts(lengths: torch.Tensor, cache_len: int) -> torch.Tensor:
    return torch.clamp(lengths, max=cache_len)


# --------------------------------------------------------------------------
# standard GQA attention
# --------------------------------------------------------------------------

def init_attention(gen, cfg: ModelConfig, device):
    dt = L.param_dtype(cfg)
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": L.dense_init(gen, d, hq * dh, dt, device),
        "wk": L.dense_init(gen, d, hkv * dh, dt, device),
        "wv": L.dense_init(gen, d, hkv * dh, dt, device),
        "wo": L.dense_init(gen, hq * dh, d, dt, device),
    }


def init_attention_cache(cfg: ModelConfig, batch: int, max_len: int, device, window=None):
    if window:
        raise NotImplementedError("ring/window KV caches wait for a later slice of the port")
    dt = L.param_dtype(cfg)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def attention(
    cfg: ModelConfig,
    p,
    x: torch.Tensor,  # [B, T, d]
    *,
    positions: torch.Tensor,  # [B, T]
    lengths: Optional[torch.Tensor],  # [B] context size BEFORE this call
    cache: Optional[dict],
    mode: str,
    window: Optional[int] = None,
    impl: str = "auto",
) -> Tuple[torch.Tensor, Optional[dict]]:
    b, t, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if mode in ("mixed", "verify") or (cache is not None and "bt" in cache):
        raise NotImplementedError(f"{mode} mode / paged caches wait for {_NEXT_SLICE}")
    if mode == "extend":
        raise NotImplementedError("extend mode waits for the port's speculative slice")
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if cache is not None and window is not None:
        raise NotImplementedError("ring/window KV caches wait for a later slice of the port")

    q = L.dense(p["wq"], x, impl).reshape(b, t, hq, dh)
    k = L.dense(p["wk"], x, impl).reshape(b, t, hkv, dh)
    v = L.dense(p["wv"], x, impl).reshape(b, t, hkv, dh)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if mode in ("train", "prefill"):
        if cache is not None:
            new_cache = {"k": write_prefill(cache["k"], k), "v": write_prefill(cache["v"], v)}
        out = ops.flash_attention(
            q, k, v, q_positions=positions, k_positions=positions,
            causal=True, window=window, impl=impl,
        )
    else:  # decode
        s = cache["k"].shape[1]
        idx = lengths % s
        new_cache = {"k": write_decode(cache["k"], k[:, 0], idx),
                     "v": write_decode(cache["v"], v[:, 0], idx)}
        n_valid = valid_counts(lengths + 1, s)
        out = ops.decode_attention(
            q[:, 0], new_cache["k"], new_cache["v"], n_valid, impl=impl
        )[:, None]
    return L.dense(p["wo"], out.reshape(b, t, hq * dh), impl), new_cache
