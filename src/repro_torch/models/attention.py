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
- ``verify``:  each slot's speculative window of ``t_new`` tokens written at
               ``lengths`` (``write_window``: lanes past ``t_new`` dropped,
               never clamped), then flash attention over the whole cache with
               explicit key positions and ``k_valid = arange(S) < lengths +
               t_new``.

Paged caches (a layer cache holding ``bt``, the pool's block table [B, MB]
over K/V blocks [NB, bs, Hkv, D]; see ``core/kv_cache.py``):

- ``decode``:  one token per slot written through the table
               (``paged_token_rows``), then the paged flash-decode kernel,
               which reads the table itself, with ``n_valid = min(lengths +
               1, MB * bs)``;
- ``mixed``:   each slot's chunk of ``t_new`` tokens (a decode slot's one
               token, a prefilling slot's prompt chunk, 0 for idle rows)
               written through the table (``paged_chunk_rows``), then
               flash attention over the slots' gathered logical K/V
               (``paged_gather``) with explicit key positions and ``k_valid
               = arange(MB * bs) < lengths + t_new``;
- ``verify``:  the mixed step's device program over a speculative window
               (the caller keeps every lane's logits).

Not ported yet (each raises ``NotImplementedError``): ``extend`` (it comes
with the prefix cache), ring/sliding-window caches, the sequence-parallel
decode (``SP_MESH``) and MLA with its latent cache.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L



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


def window_addresses(lengths: torch.Tensor, t_new: torch.Tensor, c: int) -> dict:
    """The live lanes of a verify window, as index tensors shared by every
    layer's ``write_window``: slot ``win_b``, cache position ``win_pos`` and
    window lane ``win_lane`` of each lane ``j < t_new[b]``, at position
    ``lengths[b] + j``. Found once a forward: selecting them is the window
    write's one host sync."""
    lanes = torch.arange(c, device=lengths.device)
    live = lanes[None] < t_new.long()[:, None]  # [B, C]
    b_idx, lane = live.nonzero(as_tuple=True)
    return {"win_b": b_idx, "win_pos": lengths.long()[b_idx] + lane, "win_lane": lane}


def write_window(buf: torch.Tensor, new: torch.Tensor, lengths: torch.Tensor,
                 t_new: torch.Tensor, addr: Optional[dict] = None) -> torch.Tensor:
    """Masked multi-token write for verify windows on contiguous caches: new
    [B, C, ...] lands in buf [B, S, ...] at per-slot offsets ``lengths`` [B],
    lane ``j`` written iff ``j < t_new[b]``. Only the live lanes are indexed
    (``window_addresses``, or ``addr`` when given): a lane past ``t_new`` is
    dropped, never clamped onto a committed entry."""
    if addr is None:
        addr = window_addresses(lengths, t_new, new.shape[1])
    buf[addr["win_b"], addr["win_pos"]] = new[addr["win_b"], addr["win_lane"]].to(buf.dtype)
    return buf


def valid_counts(lengths: torch.Tensor, cache_len: int) -> torch.Tensor:
    return torch.clamp(lengths, max=cache_len)


# --------------------------------------------------------------------------
# paged (block-table) cache helpers, in place
# --------------------------------------------------------------------------

def paged_token_rows(bt: torch.Tensor, lengths: torch.Tensor, bs: int) -> torch.Tensor:
    """Flat pool row ``phys * bs + offset`` of each slot's next token, at
    logical position ``lengths[b]`` through the table bt [B, MB]: [B]."""
    lengths = lengths.long()
    blk = torch.clamp(lengths // bs, 0, bt.shape[1] - 1)
    phys = torch.gather(bt.long(), 1, blk[:, None])[:, 0]
    return phys * bs + lengths % bs


def paged_chunk_rows(bt: torch.Tensor, lengths: torch.Tensor, t_new: torch.Tensor, bs: int,
                     c: int) -> torch.Tensor:
    """Flat pool rows [B, C] of each slot's chunk: lane ``j`` of slot ``b``
    at logical position ``lengths[b] + j`` iff ``j < t_new[b]``; every other
    lane (a partial chunk's padding, decode rows past lane 0, idle rows)
    maps into the sink block 0."""
    lanes = torch.arange(c, device=bt.device)
    pos = lengths.long()[:, None] + lanes[None]  # [B, C] logical positions
    blk = torch.clamp(pos // bs, 0, bt.shape[1] - 1)
    phys = torch.gather(bt.long(), 1, blk)  # [B, C]
    valid = lanes[None] < t_new.long()[:, None]
    return torch.where(valid, phys, torch.zeros_like(phys)) * bs + pos % bs


def paged_addresses(bt: torch.Tensor, lengths: torch.Tensor, bs: int, mode: str,
                    t_new: Optional[torch.Tensor] = None, c: int = 1) -> dict:
    """What every layer of one paged step shares, computed once a forward:
    the flat pool rows its K/V writes go to (``rows``) and, for ``decode``,
    the kernel's ``n_valid = min(lengths + 1, MB * bs)``; for ``mixed`` and
    ``verify`` (one device program), the gathered keys' positions ``kpos``
    [B, MB * bs] and ``k_valid = kpos < lengths + t_new``."""
    s_log = bt.shape[1] * bs
    if mode == "decode":
        return {"rows": paged_token_rows(bt, lengths, bs),
                "n_valid": valid_counts(lengths + 1, s_log)}
    if mode not in ("mixed", "verify"):
        raise ValueError(f"a paged cache serves decode, mixed and verify steps, not {mode!r}")
    kpos = torch.arange(s_log, device=bt.device, dtype=torch.int32)[None].expand(
        bt.shape[0], s_log).contiguous()  # as the flash kernel reads it, once
    return {"rows": paged_chunk_rows(bt, lengths, t_new, bs, c), "kpos": kpos,
            "k_valid": kpos < (lengths + t_new)[:, None]}


def paged_write_rows(buf: torch.Tensor, new: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Write ``new`` [*rows.shape, ...] into a block pool buf [NB, bs, ...]
    at its flat rows. Live slots' rows never collide; freed slots' and
    padding lanes' rows lie in the sink block 0, where duplicate targets
    may land in any order."""
    buf.view((-1,) + tuple(buf.shape[2:]))[rows] = new.to(buf.dtype)
    return buf


def paged_write_token(buf: torch.Tensor, new: torch.Tensor, bt: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
    """Write one token per slot into a block pool: buf [NB, bs, ...], new
    [B, ...], at (bt[b, lengths[b] // bs], lengths[b] % bs)."""
    return paged_write_rows(buf, new, paged_token_rows(bt, lengths, buf.shape[1]))


def paged_gather(buf: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """Each slot's logical K/V view: buf [NB, bs, ...] gathered through bt
    [B, MB] into a fresh [B, MB * bs, ...] tensor (the mixed step's one
    transient per layer, amortised over a chunk of queries)."""
    b, mb = bt.shape
    g = buf[bt.long()]  # [B, MB, bs, ...]
    return g.reshape((b, mb * buf.shape[1]) + tuple(buf.shape[2:]))


def paged_write_chunk(buf: torch.Tensor, new: torch.Tensor, bt: torch.Tensor,
                      lengths: torch.Tensor, t_new: torch.Tensor) -> torch.Tensor:
    """Write one chunk per slot into a block pool (chunked prefill): buf
    [NB, bs, ...], new [B, C, ...], at ``paged_chunk_rows``."""
    rows = paged_chunk_rows(bt, lengths, t_new, buf.shape[1], new.shape[1])
    return paged_write_rows(buf, new, rows)


# --------------------------------------------------------------------------
# standard GQA attention
# --------------------------------------------------------------------------

def init_attention(gen, cfg: ModelConfig, device):
    """q/k/v/o projections, plus per-head ``q_norm`` / ``k_norm`` scales
    under ``cfg.qk_norm``. ``qkv_bias`` is refused (a later slice)."""
    if cfg.qkv_bias:
        raise NotImplementedError("qkv bias attention waits for a later slice of the port")
    dt = L.param_dtype(cfg)
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": L.dense_init(gen, d, hq * dh, dt, device),
        "wk": L.dense_init(gen, d, hkv * dh, dt, device),
        "wv": L.dense_init(gen, d, hkv * dh, dt, device),
        "wo": L.dense_init(gen, hq * dh, d, dt, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = L.rmsnorm_init(dh, dt, device)
        p["k_norm"] = L.rmsnorm_init(dh, dt, device)
    return p


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
    bidirectional: bool = False,
    t_new: Optional[torch.Tensor] = None,  # [B] chunk / window widths
) -> Tuple[torch.Tensor, Optional[dict]]:
    """``bidirectional`` (encoder stacks): no RoPE, and non-causal flash
    attention in train and prefill. Under ``cfg.qk_norm`` q and k are
    RMS-normalised per head (rows of ``head_dim``) before RoPE."""
    b, t, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if mode == "mixed" and (cache is None or "bt" not in cache):
        raise ValueError("mixed mode requires a paged (block-table) cache")
    if mode == "verify" and (cache is None or t_new is None):
        raise ValueError("verify mode requires a cache and per-slot widths t_new")
    if mode == "extend":
        raise NotImplementedError("extend mode waits for the port's prefix cache")
    if mode not in ("train", "prefill", "decode", "mixed", "verify"):
        raise ValueError(f"unknown mode {mode!r}")
    if cache is not None and window is not None:
        raise NotImplementedError("ring/window KV caches wait for a later slice of the port")

    q = L.dense(p["wq"], x, impl).reshape(b, t, hq, dh)
    k = L.dense(p["wk"], x, impl).reshape(b, t, hkv, dh)
    v = L.dense(p["wv"], x, impl).reshape(b, t, hkv, dh)
    if cfg.qk_norm:
        q = L.rmsnorm(p["q_norm"], q, cfg.rmsnorm_eps, impl=impl)
        k = L.rmsnorm(p["k_norm"], k, cfg.rmsnorm_eps, impl=impl)
    if not bidirectional:  # encoder stacks skip RoPE (whisper uses sinusoid)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if mode in ("train", "prefill"):
        if cache is not None:
            new_cache = {"k": write_prefill(cache["k"], k), "v": write_prefill(cache["v"], v)}
        out = ops.flash_attention(
            q, k, v, q_positions=positions, k_positions=positions,
            causal=not bidirectional, window=window, impl=impl,
        )
    elif "bt" in cache:
        out, new_cache = _paged_attention(q, k, v, cache, positions=positions,
                                          lengths=lengths, mode=mode, t_new=t_new,
                                          impl=impl)
    elif mode == "verify":
        # the window written at the slot offsets, then window-query flash over
        # the cache: intra-window causality by the query positions, each
        # slot's width by k_valid
        s = cache["k"].shape[1]
        addr = cache if "win_b" in cache else None
        new_cache = {"k": write_window(cache["k"], k, lengths, t_new, addr),
                     "v": write_window(cache["v"], v, lengths, t_new, addr)}
        kpos = torch.arange(s, device=x.device, dtype=torch.int32)[None].expand(b, s)
        out = ops.flash_attention(
            q, new_cache["k"], new_cache["v"], q_positions=positions, k_positions=kpos,
            causal=True, k_valid=kpos < (lengths + t_new)[:, None], impl=impl,
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


def _paged_attention(q, k, v, cache: dict, *, positions, lengths, mode: str, t_new,
                     impl: str):
    """The decode and mixed (or verify) branches over a paged layer cache
    (K/V blocks, the shared block table ``bt`` and, from
    ``transformer.forward``, the step's ``paged_addresses``); writes go into
    the pool in place."""
    if cache["k"].dim() != 4:
        raise NotImplementedError("MLA's latent paged cache waits for a later slice of the port")
    bt = cache["bt"]
    addr = cache if "rows" in cache else paged_addresses(
        bt, lengths, cache["k"].shape[1], mode, t_new, q.shape[1])
    new_cache = {"k": paged_write_rows(cache["k"], k[:, 0] if mode == "decode" else k,
                                       addr["rows"]),
                 "v": paged_write_rows(cache["v"], v[:, 0] if mode == "decode" else v,
                                       addr["rows"]),
                 "bt": bt}
    if mode == "decode":
        out = ops.paged_decode_attention(q[:, 0], new_cache["k"], new_cache["v"], bt,
                                         addr["n_valid"], impl=impl)[:, None]
        return out, new_cache
    # mixed and verify: chunk-query flash attention over each slot's gathered
    # logical view (prior blocks and the chunk just written), intra-chunk
    # causality by the query positions
    out = ops.flash_attention(
        q, paged_gather(new_cache["k"], bt), paged_gather(new_cache["v"], bt),
        q_positions=positions, k_positions=addr["kpos"], causal=True,
        k_valid=addr["k_valid"], impl=impl,
    )
    return out, new_cache
