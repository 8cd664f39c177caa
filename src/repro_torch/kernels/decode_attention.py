"""Flash-decode: the CUDA kernel ``csrc/decode_attention.cu`` and its plain
version.

Replaces ``repro/kernels/decode_attention.py::decode_attention_pallas``
(``_decode_kernel``): one query token per batch row against a static
``[B, S, Hkv, D]`` cache, valid below per-row ``lengths``; tiles past the
length are never read and each KV tile serves the whole q-head group. On
the H100 it is bound by bytes (about G flops per cached byte); the kernel
runs one block per (batch row, KV head) without a split of the sequence
(see the source's note).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
#: launches of the CUDA kernel in this process (chip_smoke resets and reads it)
LAUNCHES = 0
#: head widths the kernel is instantiated for (D == Dv)
HEAD_DIMS = (64, 128)
#: per-thread output registers x threads of one block: bounds G * D
MAX_GROUP_WIDTH = 8 * 256


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


def decode_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream. ``lengths`` must
    be contiguous int32 [B]; raises for anything the kernel does not take."""
    global LAUNCHES
    _build.require_cuda("decode_attention", q, k, v, lengths)
    b, hq, d = q.shape
    s, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    if k.shape != (b, s, hkv, d) or v.shape[:3] != (b, s, hkv):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if dv != d or d not in HEAD_DIMS:
        raise ValueError(f"decode_attention: the kernel takes D == Dv in {HEAD_DIMS}, "
                         f"got D={d}, Dv={dv}")
    if hq % hkv or (hq // hkv) * d > MAX_GROUP_WIDTH:
        raise ValueError(f"decode_attention: {hq} q heads over {hkv} KV heads at D={d}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("decode_attention: q, k and v must share one type")
    if lengths.dtype != torch.int32 or lengths.shape != (b,):
        raise ValueError("decode_attention: lengths must be int32 [B]")
    scale = scale if scale is not None else d ** -0.5
    code = _build.dtype_code(q)
    out = torch.empty_like(q)
    lib = _build.library()
    rc = lib.decode_attention_launch(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), b, s, hq, hkv, d, float(scale), _build.stream_of(q),
    )
    _build.check(rc, "decode_attention")
    LAUNCHES += 1
    return out
