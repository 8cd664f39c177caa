"""HSTU pointwise attention: the CUDA kernels ``csrc/hstu_attention.cu`` and
their plain version.

Replaces ``repro/kernels/hstu_attention.py::hstu_attention_pallas``
(``_hstu_kernel``): ``SiLU(q.k^T * D^-1/2 + rel_bias[clip(i - j)]) / T``
times V, causal, within ``max_attn_len`` when given, keys below
``lengths[b]``; no softmax, so tiles accumulate additively. At the served
shapes (T = 4507..5121, 8 heads, D = 64) the H100 bound is operations.
bf16 runs both products on the tensor cores (``mma.sync``) with the SiLU in
registers (``tanh.approx``) and P in bf16; f32 runs the first design's f32
FMA loops, whose exact SiLU and f32 P its tolerance needs (see the source's
note). Both walk only the key tiles :func:`key_tiles` lists for a query
tile and predicate ragged edges instead of padding; the bf16 kernel
evaluates the masks only on the tiles it does not call interior.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

#: launches of the CUDA kernels in this process (chip_smoke resets and reads it)
LAUNCHES = 0
#: head widths the kernel is instantiated for
HEAD_DIMS = (32, 64)
#: query rows and keys of one tile of both kernels
TILE = 64


def key_tiles(q0: int, t: int, band: Optional[int], length: int) -> List[Tuple[int, bool]]:
    """The key tiles the kernels walk for the query tile at row ``q0``, as
    (first key, interior): from the first tile the band reaches to the last
    one that is causal and below ``min(length, t)``; interior when every
    (query, key) pair of the 64 x 64 tile is causal, in the band and below
    the length, so the bf16 kernel evaluates no mask there."""
    length = min(length, t)
    k_end = min(q0 + TILE, length)
    k_start = 0 if band is None else max(0, q0 - band + 1) // TILE * TILE
    return [(k0, k0 + TILE <= length and k0 + TILE - 1 <= q0
             and (band is None or q0 + TILE - 1 - k0 < band))
            for k0 in range(k_start, k_end, TILE)]


def hstu_attention_plain(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, T, H, D]
    v: torch.Tensor,  # [B, T, H, D]
    rel_bias: torch.Tensor,  # [2 * max_rel - 1] f32
    *,
    max_attn_len: Optional[int],
    lengths: torch.Tensor,  # [B] int32
) -> torch.Tensor:
    """The kernel's function, one batch row at a time: f32 scores, the
    clipped bias, SiLU over the static length ``T``, the causal / band /
    key-length mask, then the product with V in f32, cast to ``q``'s type.
    One row's [H, T, T] tile is materialized (0.84 GB at T = 5121, H = 8)."""
    b, t, h, d = q.shape
    max_rel = (rel_bias.shape[0] + 1) // 2
    pos = torch.arange(t, device=q.device)
    delta = pos[:, None] - pos[None, :]
    rab = rel_bias.float()[torch.clamp(delta, -(max_rel - 1), max_rel - 1) + (max_rel - 1)]
    band = delta >= 0
    if max_attn_len is not None:
        band = band & (delta < max_attn_len)
    out = torch.empty_like(q)
    for i in range(b):
        s = torch.einsum("thd,shd->hts", q[i].float(), k[i].float()) * d ** -0.5 + rab
        ok = band & (pos[None, :] < lengths[i])
        a = torch.where(ok, F.silu(s) / t, torch.zeros_like(s))
        out[i] = torch.einsum("hts,shd->thd", a, v[i].float()).to(q.dtype)
    return out


def hstu_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_bias: torch.Tensor,
    *,
    max_attn_len: Optional[int],
    lengths: torch.Tensor,
) -> torch.Tensor:
    """Launch the CUDA kernel of ``q``'s type (bf16: tensor cores; f32: CUDA
    cores) on PyTorch's current stream. ``rel_bias`` must be contiguous f32
    and ``lengths`` contiguous int32 [B]; raises for anything the kernels do
    not take."""
    global LAUNCHES
    _build.require_cuda("hstu_attention", q, k, v, rel_bias, lengths)
    b, t, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"hstu_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} must agree")
    if d not in HEAD_DIMS:
        raise ValueError(f"hstu_attention: the kernel takes D in {HEAD_DIMS}, got {d}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("hstu_attention: q, k and v must share one type")
    if rel_bias.dtype != torch.float32 or rel_bias.ndim != 1 or rel_bias.shape[0] % 2 != 1:
        raise ValueError("hstu_attention: rel_bias must be an f32 table of 2 * max_rel - 1")
    if lengths.dtype != torch.int32 or lengths.shape != (b,):
        raise ValueError("hstu_attention: lengths must be int32 [B]")
    if h > 65535 or b > 65535:  # the grid's y and z extents
        raise ValueError(f"hstu_attention: B={b}, H={h} exceed the grid")
    code = _build.dtype_code(q)
    out = torch.empty_like(q)
    lib = _build.library()
    rc = lib.hstu_attention_launch(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_bias.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), b, t, h, d, rel_bias.shape[0],
        -1 if max_attn_len is None else int(max_attn_len), float(d ** -0.5),
        _build.stream_of(q),
    )
    _build.check(rc, "hstu_attention")
    LAUNCHES += 1
    return out
