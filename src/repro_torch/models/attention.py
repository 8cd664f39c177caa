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
- ``extend``:  a window of T tokens per slot written at ``lengths``
               (``write_extend``: the reference's ``dynamic_update_slice``,
               whose start is clamped to ``S - T``, so a window that would
               overhang the cache lands on its last T rows), then flash
               attention over the whole cache with explicit key positions and
               ``k_valid = arange(S) < lengths + T``. Contiguous caches only:
               a paged cache and a ring (``window``) raise, as in the
               reference.
- ``verify``:  each slot's speculative window of ``t_new`` tokens written at
               ``lengths`` (``write_window``: a static-shape write, lanes
               past ``t_new`` or past the cache dropped, never clamped), then flash attention over the whole cache with
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

DeepSeek-V2's Multi-head Latent Attention (``mla_attention``) serves the
same modes over one fused latent cache [B, S, kv_lora + rope] (or its block
pool [NB, bs, kv_lora + rope]): prefill expands the latents to per-head K
and V for flash attention at D = nope + rope, Dv = v_head; decode, extend,
verify and the paged steps run absorbed against the latent, a single shared KV
head whose V is the latent's leading ``kv_lora_rank`` columns (a view of
the cached K, never a copy).

A sliding ``window`` (the hybrid's local attention, a dense config's
``sliding_window``) turns a contiguous layer cache into a ring of ``S =
min(max_len, window)`` rows: a prefill longer than S keeps its last S
tokens, token t at row t % S (``write_prefill``); decode writes at
``lengths % S`` and reads ``min(lengths + 1, S)`` rows. Train, prefill and
decode take a window; extend, verify, mixed and paged caches refuse one,
as the reference does, before any write.

Under tensor parallelism a rank's config carries its heads (``n_heads /
tp``, ``n_kv_heads / tp``; ``distributed/tp_pool.py``) and its params the
matching q/k/v columns (biases included) and ``wo`` rows: every mode runs
unchanged on the rank's heads (qk-norm's per-``head_dim`` scales
replicated), and ``wo``'s partial outputs are reduced over the ranks
(``layers.row_parallel``). MLA runs at a
rank's query heads over the whole latent, as the reference's specs leave
it (replicated): the latent cache is the same on every rank.

The sequence-parallel decode (:func:`sp_decode`, the reference's
``_sp_decode``) serves a cache split along its rows over a group: each rank
writes the new token's K/V only where it owns the row, takes the
flash-decode partial ``(acc, m, l)`` of every q head over its rows (the
decode kernel's partial form), and the ranks exchange the partials in one
reduce and merge them by their log-sum-exp (the merge kernel). The hybrid's
ring takes it under tensor parallelism where ``S`` divides the ranks
(``seq_split``: the layer cache holds the rank's rows ``[rank * S / tp,
(rank + 1) * S / tp)``, a prefill writes only those, a decode step gathers
the q heads whole first); its K/V projections are whole on every rank.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.analysis.hotpath import hot_path
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import ops
from repro_torch.models import layers as L



# --------------------------------------------------------------------------
# cache write helpers (in place)
# --------------------------------------------------------------------------

def write_prefill(buf: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Write [B, T, ...] into [B, S, ...] at offset 0 and zero the rest of
    each row (the reference pads ``new`` to S). A ring (T > S) keeps the
    last S entries, token t at row t % S: every row is written."""
    return write_prefill_rows(buf, new, 0, buf.shape[1])


def write_prefill_rows(buf: torch.Tensor, new: torch.Tensor, row0: int, s: int) -> torch.Tensor:
    """Rows ``[row0, row0 + S_loc)`` of :func:`write_prefill` into a cache of
    ``s`` rows, written into buf [B, S_loc, ...] (a rank's rows of a ring
    split along the sequence): a prompt of T <= s tokens puts token t at row
    t and zeros past it; a longer one keeps its last s tokens, token t at
    row t % s, so the rank's rows hold the tokens of its residues."""
    s_loc, t = buf.shape[1], new.shape[1]
    if t > s:
        g = torch.arange(row0, row0 + s_loc, device=buf.device)
        src = (t - s) + (g - (t - s)) % s  # the last s tokens' one at each row
        buf.copy_(new[:, src].to(buf.dtype))
        return buf
    n = min(max(t - row0, 0), s_loc)
    buf[:, :n].copy_(new[:, row0:row0 + n])
    buf[:, n:].zero_()
    return buf


def write_decode(buf: torch.Tensor, new: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Write one entry per batch row: buf [B,S,...], new [B,...], idx [B]."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    buf[rows, idx.long()] = new.to(buf.dtype)
    return buf


def write_extend(buf: torch.Tensor, new: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Write a [B, T, ...] block into buf [B, S, ...] at per-slot offsets
    idx [B], each start clamped to [0, S - T] as ``dynamic_update_slice``
    clamps it: an overhanging window is written whole at ``S - T``, over
    committed rows (the reference's ``write_extend``)."""
    b, t = new.shape[:2]
    start = torch.clamp(idx.long(), 0, buf.shape[1] - t)
    pos = start[:, None] + torch.arange(t, device=buf.device)[None]
    buf[torch.arange(b, device=buf.device)[:, None], pos] = new.to(buf.dtype)
    return buf


def write_slot_row(buf: torch.Tensor, row: torch.Tensor, slot: int) -> torch.Tensor:
    """Replace one sequence slot of a pooled buffer: buf [B, ...] gets
    row [1, ...] at batch index ``slot`` (the continuous-batching refill
    write)."""
    buf[slot].copy_(row[0].to(buf.dtype))
    return buf


def window_addresses(lengths: torch.Tensor, t_new: torch.Tensor, c: int, s: int) -> dict:
    """Every lane's address in a verify window over a cache of ``s`` rows,
    as static-shape index tensors shared by every layer's ``write_window``
    (no ``nonzero``, no host sync: the step is one replayable program).
    Lane ``j`` of slot ``b`` is live iff ``j < t_new[b]`` and its position
    ``lengths[b] + j`` lies inside the cache (``win_live`` [B, C]); every lane
    is addressed at ``(lengths[b] + j) % s`` (``win_pos``), which is the
    live lanes' own position and, for ``c <= s``, a row of the slot that no
    other lane of the window addresses. A dead lane writes back what its row
    already holds: the reference's ``mode="drop"`` write, where no two lanes
    write one position and no dead lane changes a committed entry."""
    if c > s:
        raise ValueError(f"verify window of {c} lanes over a cache of {s} rows")
    lanes = torch.arange(c, device=lengths.device)
    pos = lengths.long()[:, None] + lanes[None]  # [B, C]
    live = (lanes[None] < t_new.long()[:, None]) & (pos < s)
    rows = torch.arange(lengths.shape[0], device=lengths.device)[:, None].expand_as(pos)
    return {"win_b": rows, "win_pos": pos % s, "win_live": live}


def write_window(buf: torch.Tensor, new: torch.Tensor, lengths: torch.Tensor,
                 t_new: torch.Tensor, addr: Optional[dict] = None) -> torch.Tensor:
    """Masked multi-token write for verify windows on contiguous caches: new
    [B, C, ...] lands in buf [B, S, ...] at per-slot offsets ``lengths`` [B],
    lane ``j`` written iff ``j < t_new[b]`` and its position is below S
    (``window_addresses``, or ``addr`` when given). A dead lane is dropped:
    its row gets back the value it held, never a clamped neighbour's."""
    if addr is None:
        addr = window_addresses(lengths, t_new, new.shape[1], buf.shape[1])
    b_idx, pos, live = addr["win_b"], addr["win_pos"], addr["win_live"]
    live = live.reshape(live.shape + (1,) * (new.dim() - 2))
    buf[b_idx, pos] = torch.where(live, new.to(buf.dtype), buf[b_idx, pos])
    return buf


def valid_counts(lengths: torch.Tensor, cache_len: int) -> torch.Tensor:
    return torch.clamp(lengths, max=cache_len)


# --------------------------------------------------------------------------
# sequence-parallel decode
# --------------------------------------------------------------------------

def sp_decode(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor, q: torch.Tensor,
              lengths: torch.Tensor, group, *, ring: Optional[int] = None, impl: str = "auto"):
    """Flash decode over a cache split along its rows over ``group`` (the
    reference's ``_sp_decode``): ``cache`` holds the rank's rows ``[rank *
    S_loc, (rank + 1) * S_loc)`` of K/V [B, S_loc, Hkv, D]; ``k_new`` /
    ``v_new`` [B, Hkv, D] the new token's, ``q`` [B, Hq, D] every q head.

    1. The new row is written at ``lengths`` (``ring``: at ``lengths %
       ring``, a ring of that many rows) on the rank that owns it; the
       others write back the row they hold (no full-buffer ``where``).
    2. Each rank takes the partial ``(acc, m, l)`` of every head over its
       rows below ``lengths + 1`` (``ring``: ``min(lengths + 1, ring)``), a
       valid prefix of them (``ops.decode_attention_partial``: the decode
       kernel's partial form on the card), into its slot of a zeroed
       [size, B * Hq * (Dv + 2)] f32 exchange buffer.
    3. One reduce puts every rank's triple in every slot, and
       ``ops.combine_partial_attention`` merges them by their log-sum-exp.

    Returns (out [B, Hq, Dv] f32, cache) with the cache written in place."""
    b, hq = q.shape[:2]
    s_loc, dv = cache["k"].shape[1], cache["v"].shape[-1]
    row0 = group.rank * s_loc
    pos = lengths.long() % ring if ring is not None else lengths.long()
    local = pos - row0
    own = (local >= 0) & (local < s_loc)
    at = torch.clamp(local, 0, s_loc - 1)
    rows = torch.arange(b, device=q.device)
    for name, new in (("k", k_new), ("v", v_new)):
        buf = cache[name]
        keep = own.reshape((b,) + (1,) * (new.dim() - 1))
        buf[rows, at] = torch.where(keep, new.to(buf.dtype), buf[rows, at])
    n_valid = lengths + 1 if ring is None else valid_counts(lengths + 1, ring)
    n_local = torch.clamp(n_valid - row0, 0, s_loc)
    ex = torch.zeros((group.size, _da.partial_numel(b, hq, dv)), dtype=torch.float32,
                     device=q.device)
    ops.decode_attention_partial(q, cache["k"], cache["v"], n_local, out=ex[group.rank],
                                 impl=impl)
    group.all_reduce(ex)
    n = b * hq * dv
    ml = ex[:, n:].view(group.size, b, hq, 2)
    out = ops.combine_partial_attention(ex[:, :n].view(group.size, b, hq, dv), ml[..., 0],
                                        ml[..., 1], impl=impl)
    return out, cache


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


@hot_path
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


@hot_path
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
    """q/k/v/o projections (q/k/v with a zero bias under ``cfg.qkv_bias``),
    plus per-head ``q_norm`` / ``k_norm`` scales under ``cfg.qk_norm``."""
    dt = L.param_dtype(cfg)
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": L.dense_init(gen, d, hq * dh, dt, device, bias=cfg.qkv_bias),
        "wk": L.dense_init(gen, d, hkv * dh, dt, device, bias=cfg.qkv_bias),
        "wv": L.dense_init(gen, d, hkv * dh, dt, device, bias=cfg.qkv_bias),
        "wo": L.dense_init(gen, hq * dh, d, dt, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = L.rmsnorm_init(dh, dt, device)
        p["k_norm"] = L.rmsnorm_init(dh, dt, device)
    return p


def init_attention_cache(cfg: ModelConfig, batch: int, max_len: int, device, window=None):
    """K/V [B, S, Hkv, D], S = max_len, or the ring's min(max_len, window)."""
    dt = L.param_dtype(cfg)
    s = min(max_len, window) if window else max_len
    shape = (batch, s, cfg.n_kv_heads, cfg.head_dim)
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
    tp=None,
    seq_split: bool = False,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """``bidirectional`` (encoder stacks): no RoPE, and non-causal flash
    attention in train and prefill. Under ``cfg.qk_norm`` q and k are
    RMS-normalised per head (rows of ``head_dim``) before RoPE. ``tp``: the
    group ``wo``'s rows are split over (its output is reduced over it).
    ``seq_split``: ``cache`` holds the rank's rows of a ring of ``S_loc *
    tp.size`` rows split along the sequence over ``tp`` (prefill writes only
    those rows, decode runs :func:`sp_decode` over every q head, gathered)."""
    b, t, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if mode == "mixed" and (cache is None or "bt" not in cache):
        raise ValueError("mixed mode requires a paged (block-table) cache")
    if mode == "verify" and (cache is None or t_new is None):
        raise ValueError("verify mode requires a cache and per-slot widths t_new")
    if mode not in ("train", "prefill", "decode", "extend", "mixed", "verify"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "extend" and cache is None:
        raise ValueError("extend mode requires a cache")
    if mode == "extend" and "bt" in cache:
        raise NotImplementedError("extend unsupported on paged caches")
    if window is not None and cache is not None and (mode in ("extend", "mixed", "verify")
                                                     or "bt" in cache):
        raise NotImplementedError(
            f"{mode} over a {'paged' if 'bt' in cache else 'contiguous'} cache: ring/window "
            "caches serve train, prefill and decode only")

    q = L.dense(p["wq"], x, impl).reshape(b, t, hq, dh)
    k = L.dense(p["wk"], x, impl).reshape(b, t, hkv, dh)
    v = L.dense(p["wv"], x, impl).reshape(b, t, hkv, dh)
    if cfg.qk_norm:
        q = L.rmsnorm(p["q_norm"], q, cfg.rmsnorm_eps, impl=impl)
        k = L.rmsnorm(p["k_norm"], k, cfg.rmsnorm_eps, impl=impl)
    if not bidirectional:  # encoder stacks skip RoPE (whisper uses sinusoid)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)

    if seq_split and (tp is None or cache is None or mode not in ("prefill", "decode")):
        raise ValueError("seq_split: a ring split along the sequence over a group serves "
                         "prefill and decode")
    new_cache = None
    if mode in ("train", "prefill"):
        if seq_split:
            s_loc = cache["k"].shape[1]
            ring, row0 = s_loc * tp.size, tp.rank * s_loc
            new_cache = {"k": write_prefill_rows(cache["k"], k, row0, ring),
                         "v": write_prefill_rows(cache["v"], v, row0, ring)}
        elif cache is not None:
            new_cache = {"k": write_prefill(cache["k"], k), "v": write_prefill(cache["v"], v)}
        out = ops.flash_attention(
            q, k, v, q_positions=positions, k_positions=positions,
            causal=not bidirectional, window=window, impl=impl,
        )
    elif "bt" in cache:
        out, new_cache = _paged_attention(q, k, v, cache, positions=positions,
                                          lengths=lengths, mode=mode, t_new=t_new,
                                          impl=impl)
    elif mode in ("extend", "verify"):
        # the window written at the slot offsets (extend: whole, its start
        # clamped; verify: t_new lanes), then window-query flash over the
        # cache: intra-window causality by the query positions, each slot's
        # valid keys by k_valid
        s = cache["k"].shape[1]
        if mode == "extend":
            new_cache = {"k": write_extend(cache["k"], k, lengths),
                         "v": write_extend(cache["v"], v, lengths)}
            n_valid = lengths + t
        else:
            addr = cache if "win_b" in cache else None
            new_cache = {"k": write_window(cache["k"], k, lengths, t_new, addr),
                         "v": write_window(cache["v"], v, lengths, t_new, addr)}
            n_valid = lengths + t_new
        kpos = torch.arange(s, device=x.device, dtype=torch.int32)[None].expand(b, s)
        out = ops.flash_attention(
            q, new_cache["k"], new_cache["v"], q_positions=positions, k_positions=kpos,
            causal=True, k_valid=kpos < n_valid[:, None], impl=impl,
        )
    elif seq_split:  # decode over the rank's ring rows, every q head gathered
        s_loc = cache["k"].shape[1]
        q_all = L.gather_last(q[:, 0].reshape(b, hq * dh), tp).reshape(b, hq * tp.size, dh)
        out, new_cache = sp_decode(cache, k[:, 0], v[:, 0], q_all, lengths, tp,
                                   ring=s_loc * tp.size, impl=impl)
        out = out[:, tp.rank * hq:(tp.rank + 1) * hq].to(q.dtype)[:, None]
    else:  # decode
        s = cache["k"].shape[1]
        idx = lengths % s
        new_cache = {"k": write_decode(cache["k"], k[:, 0], idx),
                     "v": write_decode(cache["v"], v[:, 0], idx)}
        n_valid = valid_counts(lengths + 1, s)
        out = ops.decode_attention(
            q[:, 0], new_cache["k"], new_cache["v"], n_valid, impl=impl
        )[:, None]
    return L.row_parallel(p["wo"], out.reshape(b, t, hq * dh), impl, tp), new_cache


def _paged_attention(q, k, v, cache: dict, *, positions, lengths, mode: str, t_new,
                     impl: str):
    """The decode and mixed (or verify) branches over a paged layer cache
    (K/V blocks, the shared block table ``bt`` and, from
    ``transformer.forward``, the step's ``paged_addresses``); writes go into
    the pool in place."""
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


# --------------------------------------------------------------------------
# DeepSeek-V2 Multi-head Latent Attention
# --------------------------------------------------------------------------

def init_mla(gen, cfg: ModelConfig, device):
    m = cfg.mla
    dt = L.param_dtype(cfg)
    d, h = cfg.d_model, cfg.n_heads
    p = {}
    if m.q_lora_rank > 0:
        p["q_down"] = L.dense_init(gen, d, m.q_lora_rank, dt, device)
        p["q_norm"] = L.rmsnorm_init(m.q_lora_rank, dt, device)
        p["q_up"] = L.dense_init(gen, m.q_lora_rank, h * (m.qk_nope_dim + m.qk_rope_dim), dt,
                                 device)
    else:
        p["q_up"] = L.dense_init(gen, d, h * (m.qk_nope_dim + m.qk_rope_dim), dt, device)
    p["kv_down"] = L.dense_init(gen, d, m.kv_lora_rank + m.qk_rope_dim, dt, device)
    p["kv_norm"] = L.rmsnorm_init(m.kv_lora_rank, dt, device)
    p["kv_up"] = L.dense_init(gen, m.kv_lora_rank, h * (m.qk_nope_dim + m.v_head_dim), dt,
                              device)
    p["wo"] = L.dense_init(gen, h * m.v_head_dim, d, dt, device)
    return p


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    """One fused latent buffer [B, S, kv_lora + rope]: the absorbed step's K
    is the whole row and its V the leading ``kv_lora_rank`` columns."""
    m = cfg.mla
    return {"latent": torch.zeros((batch, max_len, m.kv_lora_rank + m.qk_rope_dim),
                                  dtype=L.param_dtype(cfg), device=device)}


def _mla_qkv(cfg: ModelConfig, p, x: torch.Tensor, positions: torch.Tensor, impl: str):
    """The query path and the new tokens' latent: (q_nope [B,T,H,nope],
    q_rope [B,T,H,rope] with RoPE, latent [B,T,r + rope] = the normalised
    c_kv beside the rotated shared k_rope)."""
    m = cfg.mla
    b, t, _ = x.shape
    h = cfg.n_heads
    if "q_down" in p:
        cq = L.rmsnorm(p["q_norm"], L.dense(p["q_down"], x, impl), cfg.rmsnorm_eps, impl=impl)
    else:
        cq = x
    qall = L.dense(p["q_up"], cq, impl).reshape(b, t, h, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = qall[..., : m.qk_nope_dim], qall[..., m.qk_nope_dim:]
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)
    kv = L.dense(p["kv_down"], x, impl)
    c_kv = L.rmsnorm(p["kv_norm"], kv[..., : m.kv_lora_rank], cfg.rmsnorm_eps, impl=impl)
    k_rope = L.apply_rope(kv[..., m.kv_lora_rank:][:, :, None, :], positions,
                          cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, torch.cat([c_kv, k_rope], dim=-1)


def mla_attention(
    cfg: ModelConfig,
    p,
    x: torch.Tensor,  # [B, T, d]
    *,
    positions: torch.Tensor,
    lengths: Optional[torch.Tensor],
    cache: Optional[dict],
    mode: str,
    impl: str = "auto",
    t_new: Optional[torch.Tensor] = None,
    tp=None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """MLA in every mode of the reference, at ``cfg.n_heads`` heads: under
    ``tp`` a rank's, whose ``q_up`` / ``kv_up`` columns and ``wo`` rows it
    holds (both up projections are head-major, so a contiguous column split
    is a head split) over the whole latent, which every rank writes alike;
    ``wo``'s output is then reduced over the ranks. ``train`` / ``prefill``: the
    latents up-projected to per-head K (nope beside the shared rope part)
    and V, flash attention at D = nope + rope, Dv = v_head; a prefill also
    writes the latent into the cache. ``decode`` (contiguous or paged),
    ``extend`` (contiguous), ``verify`` (contiguous or paged) and ``mixed``
    (paged): the new latent
    written as K/V are, then attention absorbed against the latent (the
    query's nope part folded through kv_up's K half, Hkv = 1, V the
    latent's leading ``kv_lora_rank`` columns) and the context folded
    through kv_up's V half in f32."""
    m = cfg.mla
    b, t, _ = x.shape
    h, r = cfg.n_heads, m.kv_lora_rank
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    if mode == "mixed" and (cache is None or "bt" not in cache):
        raise ValueError("mixed mode requires a paged (block-table) cache")
    if mode == "verify" and (cache is None or t_new is None):
        raise ValueError("verify mode requires a cache and per-slot widths t_new")
    if mode not in ("train", "prefill", "decode", "extend", "mixed", "verify"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "extend" and cache is None:
        raise ValueError("extend mode requires a cache")
    if mode == "extend" and "bt" in cache:
        raise NotImplementedError("extend unsupported on paged caches")
    q_nope, q_rope, latent_new = _mla_qkv(cfg, p, x, positions, impl)

    if mode in ("train", "prefill"):
        kv = L.dense(p["kv_up"], latent_new[..., :r], impl).reshape(
            b, t, h, m.qk_nope_dim + m.v_head_dim)
        k_rope = latent_new[..., r:][:, :, None, :].expand(b, t, h, m.qk_rope_dim)
        k = torch.cat([kv[..., : m.qk_nope_dim], k_rope], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        out = ops.flash_attention(q, k, kv[..., m.qk_nope_dim:], q_positions=positions,
                                  k_positions=positions, causal=True, scale=scale, impl=impl)
        new_cache = None
        if cache is not None:
            new_cache = {"latent": write_prefill(cache["latent"], latent_new)}
        return L.row_parallel(p["wo"], out.reshape(b, t, h * m.v_head_dim), impl, tp), new_cache

    # absorbed attention (DeepSeek-V2 §2.1): scores = [q_nope W_uk ; q_rope] .
    # [c_kv ; k_rope] against the latent, a single shared KV head
    w_up = p["kv_up"]["w"].reshape(r, h, m.qk_nope_dim + m.v_head_dim)
    w_uk, w_uv = w_up[:, :, : m.qk_nope_dim], w_up[:, :, m.qk_nope_dim:]
    q_eff = torch.cat([torch.einsum("bthn,rhn->bthr", q_nope, w_uk), q_rope], dim=-1)
    buf = cache["latent"]
    if "bt" in cache:
        bt = cache["bt"]
        addr = cache if "rows" in cache else paged_addresses(bt, lengths, buf.shape[1], mode,
                                                             t_new, t)
        new_cache = {"latent": paged_write_rows(
            buf, latent_new[:, 0] if mode == "decode" else latent_new, addr["rows"]), "bt": bt}
        if mode == "decode":
            ctx = ops.paged_decode_attention(q_eff[:, 0], new_cache["latent"], None, bt,
                                             addr["n_valid"], scale=scale, v_dim=r,
                                             impl=impl)[:, None]
        else:  # mixed / verify: chunk-query flash over the gathered latent
            lat = paged_gather(new_cache["latent"], bt)[:, :, None, :]
            ctx = ops.flash_attention(q_eff, lat, lat[..., :r], q_positions=positions,
                                      k_positions=addr["kpos"], causal=True,
                                      k_valid=addr["k_valid"], scale=scale, impl=impl)
    elif mode in ("extend", "verify"):  # window-query flash over the latent
        s = buf.shape[1]
        if mode == "extend":
            new_cache = {"latent": write_extend(buf, latent_new, lengths)}
            n_valid = lengths + t
        else:
            addr = cache if "win_b" in cache else None
            new_cache = {"latent": write_window(buf, latent_new, lengths, t_new, addr)}
            n_valid = lengths + t_new
        lat = new_cache["latent"][:, :, None, :]
        kpos = torch.arange(s, device=x.device, dtype=torch.int32)[None].expand(b, s)
        ctx = ops.flash_attention(q_eff, lat, lat[..., :r], q_positions=positions,
                                  k_positions=kpos, causal=True,
                                  k_valid=kpos < n_valid[:, None], scale=scale, impl=impl)
    else:  # contiguous decode
        s = buf.shape[1]
        new_cache = {"latent": write_decode(buf, latent_new[:, 0], lengths % s)}
        lat = new_cache["latent"][:, :, None, :]
        ctx = ops.decode_attention(q_eff[:, 0], lat, lat[..., :r], valid_counts(lengths + 1, s),
                                   scale=scale, impl=impl)[:, None]
    out = torch.einsum("bthr,rhv->bthv", ctx.float(), w_uv.float()).to(x.dtype)
    return L.row_parallel(p["wo"], out.reshape(b, t, h * m.v_head_dim), impl, tp), new_cache
