"""Paged flash-decode: the CUDA kernel ``decode_attention_paged_kernel`` of
``csrc/decode_attention.cu`` and its plain version.

Replaces the JAX package's XLA ``repro/models/attention.py::
paged_decode_attention`` (no Pallas kernel there): one query token per
batch row against a block pool ``[NB, bs, Hkv, D]`` read through the row's
block table ``bt [B, MB]``, valid below ``n_valid``. The kernel is the
contiguous flash-decode's split over the sequence with each row's address
resolved through the table inside the tile loader, so no gathered copy of
a row's keys is made; the splits come from the static ``MB * bs``
(``decode_attention.split_plan``) and the splits' partials are merged by
the contiguous kernel's combine. Same contract: D == Dv in {16, 32, 64,
128} and G * D <= 2048 (``decode_attention.supports(..., paged=True)``),
and the latent form (``vbuf=None``: a shared-head pool whose V is K's
leading ``v_dim`` columns) at (D, Dv) in ``decode_attention.LATENT`` in
both types. Bound: bytes (the live K/V rows once).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as _da

#: launches of the CUDA kernel in this process (chip_smoke resets and reads it)
LAUNCHES = 0


def latent_kv(kbuf: torch.Tensor, vbuf: Optional[torch.Tensor], v_dim: Optional[int]):
    """(K, V) pools as [NB, bs, Hkv, D] / [NB, bs, Hkv, Dv]: a 3-D shared-head
    latent pool [NB, bs, D] gains the Hkv = 1 axis, and ``vbuf=None`` makes V
    the view ``K[..., :v_dim]`` (MLA's absorbed latent; never a copy)."""
    if kbuf.dim() == 3:
        kbuf = kbuf[:, :, None, :]
        vbuf = vbuf[:, :, None, :] if vbuf is not None else None
    if vbuf is None:
        if v_dim is None:
            raise ValueError("paged_decode_attention: vbuf=None needs v_dim")
        vbuf = kbuf[..., :v_dim]
    return kbuf, vbuf


def paged_decode_attention_plain(
    q: torch.Tensor,  # [B, Hq, D]
    kbuf: torch.Tensor,  # [NB, bs, Hkv, D] or [NB, bs, D] (shared-head latent)
    vbuf: Optional[torch.Tensor],  # like kbuf, or None: V = K[..., :v_dim]
    bt: torch.Tensor,  # [B, MB] int
    n_valid: torch.Tensor,  # [B]
    *,
    scale: Optional[float] = None,
    v_dim: Optional[int] = None,
) -> torch.Tensor:
    """The reference's algorithm: an unnormalised f32 partial per logical
    block (``decode_attention_partial`` over the block's ``bs`` keys, those
    below ``n_valid`` valid), then the LSE combine over the blocks in order.
    Table entries are clamped into the pool, as the reference's gather
    clamps them."""
    kbuf, vbuf = latent_kv(kbuf, vbuf, v_dim)
    b, mb = bt.shape
    bs = kbuf.shape[1]
    phys = bt.long().clamp(0, kbuf.shape[0] - 1)  # [B, MB]
    kj = kbuf[phys].reshape((b * mb,) + kbuf.shape[1:])  # one block per (row, j)
    vj = vbuf[phys].reshape((b * mb,) + vbuf.shape[1:])
    pos = torch.arange(mb * bs, device=kbuf.device).reshape(1, mb, bs)
    k_valid = (pos < n_valid.reshape(b, 1, 1)).reshape(b * mb, bs)
    qj = q.repeat_interleave(mb, dim=0)  # row-major (row, j) like kj
    acc, m, l = _da.decode_attention_partial(qj, kj, vj, k_valid, scale=scale)
    hq = q.shape[1]

    def blocks_first(t):  # [B * MB, ...] -> [MB, B, ...]
        return t.reshape((b, mb) + t.shape[1:]).transpose(0, 1)

    out = _da.combine_partial_attention(blocks_first(acc), blocks_first(m), blocks_first(l))
    return out.reshape(b, hq, vbuf.shape[-1]).to(q.dtype)


def paged_decode_attention_cuda(
    q: torch.Tensor,
    kbuf: torch.Tensor,
    vbuf: Optional[torch.Tensor],
    bt: torch.Tensor,
    n_valid: torch.Tensor,
    *,
    scale: Optional[float] = None,
    v_dim: Optional[int] = None,
) -> torch.Tensor:
    """Launch the paged kernel (and, when the sequence is split, the
    combine) on PyTorch's current stream. ``bt`` and ``n_valid`` must be
    contiguous int32; raises for anything the kernel does not take."""
    global LAUNCHES
    b, hq, d = q.shape
    mb = bt.shape[1] if bt.dim() == 2 else -1
    if vbuf is None:  # the latent form: V = K[..., :v_dim] of a shared-head pool
        if kbuf.shape[-1] != d or kbuf.dim() not in (3, 4) or (
                kbuf.dim() == 4 and kbuf.shape[2] != 1) or v_dim is None or not _da.supports(
                    d, v_dim, hq, 1, q.dtype, latent=True):
            raise ValueError(f"paged_decode_attention: the latent form takes q [B, Hq, D] "
                             f"over a [NB, bs, D] pool at (D, v_dim) in {_da.LATENT}; got q "
                             f"{tuple(q.shape)} {q.dtype}, kbuf {tuple(kbuf.shape)}, v_dim "
                             f"{v_dim}")
        _build.require_cuda("paged_decode_attention", q, kbuf, bt, n_valid)
        if kbuf.dtype != q.dtype:
            raise TypeError("paged_decode_attention: q and kbuf must share one type")
        if bt.dtype != torch.int32 or n_valid.dtype != torch.int32 or n_valid.shape != (b,) \
                or bt.shape != (b, mb) or mb < 1:
            raise ValueError("paged_decode_attention: bt must be int32 [B, MB] and n_valid "
                             "int32 [B]")
        out = _da.latent_decode(q, kbuf, n_valid, bt, v_dim, scale=scale,
                                kind="paged_decode_attention")
        LAUNCHES += 1
        return out
    _build.require_cuda("paged_decode_attention", q, kbuf, vbuf, bt, n_valid)
    nb, bs, hkv = kbuf.shape[:3]
    if kbuf.shape != (nb, bs, hkv, d) or vbuf.shape[:3] != (nb, bs, hkv) or bt.shape != (b, mb):
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)}, kbuf "
                         f"{tuple(kbuf.shape)}, vbuf {tuple(vbuf.shape)}, bt "
                         f"{tuple(bt.shape)} do not agree")
    if not _da.supports(d, vbuf.shape[-1], hq, hkv, q.dtype, paged=True):
        raise ValueError(f"paged_decode_attention: no kernel for D={d}, Dv={vbuf.shape[-1]}, "
                         f"{hq} q heads over {hkv} KV heads in {q.dtype}: the kernel takes "
                         f"D == Dv in {_da.PAGED_HEAD_DIMS} with G * D <= "
                         f"{_da.MAX_GROUP_WIDTH}")
    if kbuf.dtype != q.dtype or vbuf.dtype != q.dtype:
        raise TypeError("paged_decode_attention: q, kbuf and vbuf must share one type")
    if bt.dtype != torch.int32 or n_valid.dtype != torch.int32 or n_valid.shape != (b,):
        raise ValueError("paged_decode_attention: bt must be int32 [B, MB] and n_valid "
                         "int32 [B]")
    if mb < 1 or b * hkv > 65535:  # the grid's y extent
        raise ValueError(f"paged_decode_attention: MB = {mb}, B * Hkv = {b * hkv}")
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    splits, split_len = _da.split_plan(b, hkv, mb * bs, _build.n_sms(q.device.index))
    # the splits' partials: acc [splits, B, Hq, D], then (m, l) [splits, B, Hq, 2]
    part = (torch.empty(splits * b * hq * (d + 2), dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    rc = _build.library().paged_decode_attention_launch(
        _build.dtype_code(q), q.data_ptr(), kbuf.data_ptr(), vbuf.data_ptr(), bt.data_ptr(),
        n_valid.data_ptr(), out.data_ptr(), None if part is None else part.data_ptr(), b, nb,
        bs, mb, hq, hkv, d, splits, split_len, float(scale), _build.stream_of(q),
    )
    _build.check(rc, "paged_decode_attention")
    LAUNCHES += 1
    return out
