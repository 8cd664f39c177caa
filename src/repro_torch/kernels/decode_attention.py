"""Flash-decode: the CUDA kernel ``csrc/decode_attention.cu`` and its plain
version.

Replaces ``repro/kernels/decode_attention.py::decode_attention_pallas``
(``_decode_kernel``): one query token per batch row against a static
``[B, S, Hkv, D]`` cache, valid below per-row ``lengths``; tiles past the
length are never read and each KV tile serves the whole q-head group. On
the H100 it is bound by bytes (about G flops per cached byte), and in
practice by latency. The kernel splits each (batch row, KV head) over
blocks along the sequence (:func:`split_plan`, from the static S alone:
``lengths`` is never read on the host) and a second small kernel merges
the splits that hold keys by their log-sum-exp, in split order, with the
maths of ``combine_partial_attention`` (see the source's note).

Widths (:func:`supports`): D == Dv in {16, 32, 64, 128} with G * D <=
2048, and D = 256 with G * D <= 2560 (recurrentgemma's MQA: 10 heads over
one KV head, over the ring of its local attention; the per-thread
accumulator is sized from D), in both types; f32 at D = 256 walks each
split in 32-key tiles (two 64-key K/V tiles of 1 KB rows would not fit in
shared memory). The paged kernel takes D in {16, 32, 64, 128}
(``PAGED_HEAD_DIMS``).

MLA's absorbed latent (one KV head whose V is the view ``k[..., :Dv]``, at
(D, Dv) = (96, 64) for the smoke config and (576, 512), any number of
heads) runs in bf16 on its own kernel (``decode_latent_kernel``): the heads
are the rows of an mma.sync tile against each 64-key latent tile, the
output columns split over min(128, Dv) column blocks, the sequence split by
the same :func:`split_plan` and merged by the same combine. In f32 it runs
the split decode above with Hkv = 1, 16 heads and min(128, Dv) output
columns a block, V read at K's row stride.

The sequence-parallel decode (``models/attention.py``'s ``sp_decode``)
runs two more launches of the same source: the partial form
(:func:`decode_attention_partial_cuda`: the split decode over one shard of
a cache's rows, valid below a per-row count, writing the shard's
unnormalised f32 triple ``(acc, m, l)`` in one flat buffer,
:func:`split_partial`), counted in ``LAUNCHES_PARTIAL``, and the merge of
stacked triples (:func:`combine_partial_attention_cuda`, strided as the
caller holds them), counted in ``LAUNCHES_MERGE``: the counterparts of the
reference's XLA ``decode_attention_partial`` and
``combine_partial_attention`` (``repro/kernels/ops.py``), whose plain
versions here are :func:`decode_attention_partial_plain` and
:func:`combine_partial_attention`.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as _fa

NEG_INF = -1e30
#: launches of the CUDA kernel in this process (chip_smoke resets and reads it)
LAUNCHES = 0
#: launches of the partial form and of the merge
LAUNCHES_PARTIAL = 0
LAUNCHES_MERGE = 0
#: head widths the kernel is instantiated for (D == Dv)
HEAD_DIMS = (16, 32, 64, 128, 256)
#: the paged kernel's (D = 256 serves only the hybrid's rings, which the
#: paged pool refuses)
PAGED_HEAD_DIMS = (16, 32, 64, 128)
#: (D, Dv) of MLA's absorbed latent (Hkv = 1, V = K[..., :Dv])
LATENT = ((96, 64), (576, 512))
#: per-thread outputs x the block's 256 threads, by D: bounds G * D (2560 at
#: D = 256: recurrentgemma's 10 heads over one KV head)
MAX_GROUP_WIDTH = {16: 8 * 256, 32: 8 * 256, 64: 8 * 256, 128: 8 * 256, 256: 10 * 256}
DTYPES = (torch.float32, torch.bfloat16)


def supports(d: int, dv: int, hq: int, hkv: int, dtype: torch.dtype, latent: bool = False,
             paged: bool = False) -> bool:
    """True when the CUDA decode kernel (``paged``: the paged one) takes q
    heads ``hq`` of width ``d`` over ``hkv`` KV heads with V of width ``dv``
    in ``dtype`` (``latent``: the absorbed form, V the leading ``dv``
    columns of the one KV head). The wrappers' gate; pure, so a CPU test
    can check coverage."""
    if dtype not in DTYPES or hkv < 1 or hq < 1 or hq % hkv:
        return False
    if latent:
        return hkv == 1 and (d, dv) in LATENT
    dims = PAGED_HEAD_DIMS if paged else HEAD_DIMS
    return d == dv and d in dims and (hq // hkv) * d <= MAX_GROUP_WIDTH[d]


#: keys per tile of the kernel; a split is a whole number of tiles
TILE_K = 64
#: blocks per SM the split plan aims for
BLOCKS_PER_SM = 2


@functools.lru_cache(maxsize=None)
def split_plan(b: int, hkv: int, s: int, n_sms: int) -> Tuple[int, int]:
    """(splits, split_len): each (row, KV head) cut into ``splits`` runs of
    ``split_len`` keys, whole 64-key tiles, from the static shape alone.
    Enough splits for ``BLOCKS_PER_SM`` blocks per SM where S has the tiles
    for it; none starts at or past S (a run past a row's length is skipped
    by the kernel, and the combine reads only the runs below it)."""
    tiles = max(1, math.ceil(s / TILE_K))
    want = math.ceil(BLOCKS_PER_SM * n_sms / max(b * hkv, 1))
    per = max(1, tiles // want)
    return math.ceil(tiles / per), per * TILE_K


def decode_attention_plain(
    q: torch.Tensor,  # [B, Hq, D]
    k: torch.Tensor,  # [B, S, Hkv, D]
    v: torch.Tensor,  # [B, S, Hkv, Dv]
    lengths: torch.Tensor,  # [B] valid cache entries per row
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The kernel's function as one materialized tile: f32 scores, the
    sentinel past each row's length, masked probabilities zeroed, and the
    clamped sum (a row of length 0 gives zeros)."""
    b, hq, d = q.shape
    s, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qf = (q.float() * scale).reshape(b, hkv, g, d)
    sc = torch.einsum("bhgd,bshd->bhgs", qf, k.float())
    ok = (torch.arange(s, device=k.device)[None, :] < lengths[:, None])[:, None, None]
    sc = torch.where(ok, sc, torch.full_like(sc, NEG_INF))
    m = sc.amax(dim=-1, keepdim=True) if s else torch.full_like(sc[..., :1], NEG_INF)
    p = torch.where(ok, torch.exp(sc - m), torch.zeros_like(sc))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return (acc / torch.clamp(l, min=1e-30)).reshape(b, hq, dv).to(q.dtype)


def decode_attention_partial(
    q: torch.Tensor,  # [B, Hq, D]
    k: torch.Tensor,  # [B, S_shard, Hkv, D]: a shard of the cache
    v: torch.Tensor,
    k_valid: torch.Tensor,  # [B, S_shard]
    *,
    scale: Optional[float] = None,
):
    """Flash-decode partial over one shard of the cache: (acc [B, Hq, Dv],
    m [B, Hq], l [B, Hq]) in f32, unnormalised, for
    :func:`combine_partial_attention` (the split the decode kernel runs per
    block)."""
    b, _, hkv, d = k.shape
    hq = q.shape[1]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qf = (q.float() * scale).reshape(b, hkv, g, d)
    scores = torch.einsum("bhgd,bshd->bhgs", qf, k.float())
    ok = k_valid[:, None, None, :]
    scores = torch.where(ok, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1)
    p = torch.where(ok, torch.exp(scores - m[..., None]), torch.zeros_like(scores))
    acc = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return acc.reshape(b, hq, v.shape[-1]), m.reshape(b, hq), p.sum(dim=-1).reshape(b, hq)


def combine_partial_attention(accs: torch.Tensor, ms: torch.Tensor,
                              ls: torch.Tensor) -> torch.Tensor:
    """LSE-combine flash-decode partials stacked on a leading shard axis:
    ``sum_s exp(m_s - m) acc_s / max(sum_s exp(m_s - m) l_s, 1e-30)``."""
    m = ms.amax(dim=0)
    alpha = torch.exp(ms - m[None])
    l = (ls * alpha).sum(dim=0)
    acc = (accs * alpha[..., None]).sum(dim=0)
    return acc / torch.clamp(l, min=1e-30)[..., None]


def partial_numel(b: int, hq: int, dv: int) -> int:
    """f32 elements of one shard's flat triple: acc [B, Hq, Dv], then (m,
    l) [B, Hq, 2]."""
    return b * hq * (dv + 2)


def split_partial(buf: torch.Tensor, b: int, hq: int, dv: int):
    """(acc [B, Hq, Dv], m [B, Hq], l [B, Hq]): views of a flat triple
    ``buf`` (:func:`partial_numel` f32 elements)."""
    acc = buf[:b * hq * dv].view(b, hq, dv)
    ml = buf[b * hq * dv:partial_numel(b, hq, dv)].view(b, hq, 2)
    return acc, ml[..., 0], ml[..., 1]


def _partial_out(out: Optional[torch.Tensor], b: int, hq: int, dv: int, device):
    n = partial_numel(b, hq, dv)
    if out is None:
        return torch.empty(n, dtype=torch.float32, device=device)
    if out.dtype != torch.float32 or out.shape != (n,) or not out.is_contiguous():
        raise ValueError(f"decode_attention_partial: out must be a contiguous f32 [{n}], got "
                         f"{out.dtype} {tuple(out.shape)}")
    return out


def decode_attention_partial_plain(
    q: torch.Tensor,  # [B, Hq, D]
    k: torch.Tensor,  # [B, S_shard, Hkv, D]
    v: torch.Tensor,  # [B, S_shard, Hkv, Dv]
    n_valid: torch.Tensor,  # [B] valid rows of the shard, a prefix
    *,
    scale: Optional[float] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The partial form's function: :func:`decode_attention_partial` over
    the shard's rows below ``n_valid``, written into the flat triple ``out``
    (allocated when None), which it returns."""
    b, hq, _ = q.shape
    s, dv = k.shape[1], v.shape[-1]
    out = _partial_out(out, b, hq, dv, q.device)
    ok = torch.arange(s, device=k.device)[None] < n_valid.to(k.device)[:, None]
    for dst, src in zip(split_partial(out, b, hq, dv),
                        decode_attention_partial(q, k, v, ok, scale=scale)):
        dst.copy_(src)
    return out


def decode_attention_partial_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    n_valid: torch.Tensor,
    *,
    scale: Optional[float] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the partial form (and, when the shard is split, the combine's
    raw form) on PyTorch's current stream: the shard's flat triple written
    into ``out`` (allocated when None), which it returns. ``n_valid`` must
    be contiguous int32 [B]; the widths are the decode kernel's
    (:func:`supports`, not the latent); raises for anything else."""
    global LAUNCHES_PARTIAL
    b, hq, d = q.shape
    s, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    _build.require_cuda("decode_attention_partial", q, k, v, n_valid)
    if k.shape != (b, s, hkv, d) or v.shape[:3] != (b, s, hkv):
        raise ValueError(f"decode_attention_partial: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if not supports(d, dv, hq, hkv, q.dtype):
        raise ValueError(f"decode_attention_partial: no kernel for D={d}, Dv={dv}, {hq} q "
                         f"heads over {hkv} KV heads in {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("decode_attention_partial: q, k and v must share one type")
    if n_valid.dtype != torch.int32 or n_valid.shape != (b,):
        raise ValueError("decode_attention_partial: n_valid must be int32 [B]")
    out = _partial_out(out, b, hq, dv, q.device)
    if out.device != q.device:
        raise ValueError(f"decode_attention_partial: out on {out.device}, q on {q.device}")
    scale = scale if scale is not None else d ** -0.5
    splits, split_len = split_plan(b, hkv, s, _build.n_sms(q.device.index))
    ws = (torch.empty(splits * partial_numel(b, hq, dv), dtype=torch.float32,
                      device=q.device) if splits > 1 else None)
    rc = _build.library().decode_attention_partial_launch(
        _build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(), n_valid.data_ptr(),
        out.data_ptr(), None if ws is None else ws.data_ptr(), b, s, hq, hkv, d, splits,
        split_len, float(scale), _build.stream_of(q))
    _build.check(rc, "decode_attention_partial")
    LAUNCHES_PARTIAL += 1
    return out


def combine_partial_attention_cuda(accs: torch.Tensor, ms: torch.Tensor,
                                   ls: torch.Tensor) -> torch.Tensor:
    """Launch the merge on PyTorch's current stream: f32 triples stacked on
    a leading part axis, ``accs`` [P, B, H, Dv] (unit column stride), ``ms``
    and ``ls`` [P, B, H], each read at its own strides (views of a flat
    exchange buffer pass as they are), into a fresh f32 [B, H, Dv]."""
    global LAUNCHES_MERGE
    p, b, h, dv = accs.shape
    for t in (accs, ms, ls):
        if not t.is_cuda or t.device != accs.device:
            raise ValueError(f"combine_partial_attention: CUDA tensors on one device, got "
                             f"{t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"combine_partial_attention: f32 partials, got {t.dtype}")
    if ms.shape != (p, b, h) or ls.shape != (p, b, h) or (dv > 1 and accs.stride(3) != 1):
        raise ValueError(f"combine_partial_attention: accs {tuple(accs.shape)} (strides "
                         f"{accs.stride()}), ms {tuple(ms.shape)}, ls {tuple(ls.shape)}")
    out = torch.empty((b, h, dv), dtype=torch.float32, device=accs.device)
    rc = _build.library().decode_attention_merge_launch(
        accs.data_ptr(), ms.data_ptr(), ls.data_ptr(), out.data_ptr(), p, b, h, dv,
        *accs.stride()[:3], *ms.stride(), *ls.stride(), _build.stream_of(accs))
    _build.check(rc, "combine_partial_attention")
    LAUNCHES_MERGE += 1
    return out


def decode_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel (and, when the sequence is split, its
    combine) on PyTorch's current stream. ``lengths`` must be contiguous
    int32 [B]; raises for anything the kernel does not take."""
    global LAUNCHES
    b, hq, d = q.shape
    s, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    if v.is_cuda and _fa.is_latent(k, v):  # V is read from K: never a copy
        _build.require_cuda("decode_attention", q, k, lengths)
        if k.shape != (b, s, 1, d) or not supports(d, dv, hq, 1, q.dtype, latent=True):
            raise ValueError(f"decode_attention: the latent kernel takes q [B, Hq, D] over k "
                             f"[B, S, 1, D] at (D, Dv) in {LATENT}; got q {tuple(q.shape)} "
                             f"{q.dtype}, k {tuple(k.shape)}, Dv {dv}")
        if k.dtype != q.dtype or lengths.dtype != torch.int32 or lengths.shape != (b,):
            raise ValueError("decode_attention: k in q's type, lengths int32 [B]")
        out = latent_decode(q, k, lengths, None, dv, scale=scale, kind="decode_attention")
        LAUNCHES += 1
        return out
    _build.require_cuda("decode_attention", q, k, v, lengths)
    if k.shape != (b, s, hkv, d) or v.shape[:3] != (b, s, hkv):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if not supports(d, dv, hq, hkv, q.dtype):
        raise ValueError(f"decode_attention: no kernel for D={d}, Dv={dv}, {hq} q heads over "
                         f"{hkv} KV heads in {q.dtype}: the kernel takes D == Dv in "
                         f"{HEAD_DIMS} with G * D <= {MAX_GROUP_WIDTH}, or the latent "
                         f"{LATENT} over one KV head whose V is the view k[..., :Dv]")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("decode_attention: q, k and v must share one type")
    if lengths.dtype != torch.int32 or lengths.shape != (b,):
        raise ValueError("decode_attention: lengths must be int32 [B]")
    scale = scale if scale is not None else d ** -0.5
    code = _build.dtype_code(q)
    out = torch.empty_like(q)
    splits, split_len = split_plan(b, hkv, s, _build.n_sms(q.device.index))
    # the splits' partials: acc [splits, B, Hq, D], then (m, l) [splits, B, Hq, 2]
    part = (torch.empty(splits * b * hq * (d + 2), dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    lib = _build.library()
    rc = lib.decode_attention_launch(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(), b, s, hq, hkv, d,
        splits, split_len, float(scale), _build.stream_of(q),
    )
    _build.check(rc, "decode_attention")
    LAUNCHES += 1
    return out


def latent_decode(q: torch.Tensor, kv: torch.Tensor, lengths: torch.Tensor,
                  bt: Optional[torch.Tensor], dv: int, *, scale: Optional[float], kind: str):
    """Launch the latent decode kernel (and the combine when the sequence
    is split): q [B, Hq, D] against the latent rows of ``kv``, [B, S, ...,
    D] contiguous when ``bt`` is None, else a block pool [NB, bs, ..., D]
    read through ``bt`` [B, MB]; V is the rows' leading ``dv`` columns.
    Returns [B, Hq, dv]; the calling wrapper (``kind``) counts the launch."""
    b, hq, d = q.shape
    if bt is None:
        nb, bs, s = 0, 0, kv.shape[1]
    else:
        nb, bs = kv.shape[:2]
        s = bt.shape[1] * bs
    if b > 65535:  # the grid's y extent
        raise ValueError(f"{kind}: B = {b} exceeds 65535")
    scale = scale if scale is not None else d ** -0.5
    out = q.new_empty((b, hq, dv))
    splits, split_len = split_plan(b, 1, s, _build.n_sms(q.device.index))
    part = (torch.empty(splits * b * hq * (dv + 2), dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    rc = _build.library().decode_attention_latent_launch(
        _build.dtype_code(q), q.data_ptr(), kv.data_ptr(), lengths.data_ptr(),
        None if bt is None else bt.data_ptr(), nb, bs, out.data_ptr(),
        None if part is None else part.data_ptr(), b, s, hq, d, dv, splits, split_len,
        float(scale), _build.stream_of(q))
    _build.check(rc, kind)
    return out
