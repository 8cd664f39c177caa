"""Flash attention forward: the CUDA kernel ``csrc/flash_attention.cu`` and
its plain version.

Replaces ``repro/kernels/flash_attention.py::flash_attention_pallas``
(``_flash_kernel``): FlashAttention-2 forward, GQA-native (one block holds
the whole q-head group of one KV head), masks built from explicit query/key
positions (causal, sliding ``window``) and ``k_valid``, f32 online softmax
with the ``-1e30`` sentinel and the ``max(l, 1e-30)`` clamp, fully masked
key tiles skipped. At the served prefill shapes (B=1, T<=256, 32/8 heads,
D=64) the H100 bound is bytes; the first version's f32 FMA loops and
launch latency dominate (see the source's note).
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
#: most query heads per KV head one block holds
MAX_GROUP = 64


def _mask(q_positions, k_positions, causal, window, k_valid):
    qp = q_positions[:, :, None]
    kp = k_positions[:, None, :]
    ok = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape), dtype=torch.bool,
                    device=qp.device)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    if k_valid is not None:
        ok &= k_valid[:, None, :]
    return ok  # [B, Tq, Tk]


def flash_attention_plain(
    q: torch.Tensor,  # [B, Tq, Hq, D]
    k: torch.Tensor,  # [B, Tk, Hkv, D]
    v: torch.Tensor,  # [B, Tk, Hkv, Dv]
    *,
    q_positions: torch.Tensor,  # [B, Tq] int
    k_positions: torch.Tensor,  # [B, Tk] int
    causal: bool = True,
    window: Optional[int] = None,
    k_valid: Optional[torch.Tensor] = None,  # [B, Tk] bool
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The kernel's function as one materialized tile: f32 scores of the
    q-head group against its KV head, the sentinel where masked, exp
    against the row max with masked entries zeroed, and the clamped sum."""
    b, tq, hq, d = q.shape
    tk, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qf = (q.float() * scale).reshape(b, tq, hkv, g, d)
    s = torch.einsum("bthgd,bshd->bhgts", qf, k.float())  # [B,Hkv,G,Tq,Tk]
    ok = _mask(q_positions, k_positions, causal, window, k_valid)[:, None, None]
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True) if tk else torch.full_like(s[..., :1], NEG_INF)
    p = torch.where(ok, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgts,bshd->bthgd", p, v.float())
    out = acc / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, tq, hq, dv).to(q.dtype)


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_positions: torch.Tensor,
    k_positions: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    k_valid: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream. Positions must be
    contiguous int32 [B, T] and ``k_valid`` contiguous bool [B, Tk] (or
    None); raises for anything the kernel does not take."""
    global LAUNCHES
    tensors = [q, k, v, q_positions, k_positions]
    if k_valid is not None:
        tensors.append(k_valid)
    _build.require_cuda("flash_attention", *tensors)
    b, tq, hq, d = q.shape
    tk, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    if k.shape != (b, tk, hkv, d) or v.shape[:3] != (b, tk, hkv):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if dv != d or d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes D == Dv in {HEAD_DIMS}, "
                         f"got D={d}, Dv={dv}")
    if hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"flash_attention: {hq} q heads over {hkv} KV heads")
    if b * hkv > 65535:  # the grid's y extent
        raise ValueError(f"flash_attention: B * Hkv = {b * hkv} exceeds 65535")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must share one type")
    if q_positions.shape != (b, tq) or k_positions.shape != (b, tk):
        raise ValueError("flash_attention: positions must be [B, Tq] and [B, Tk]")
    if q_positions.dtype != torch.int32 or k_positions.dtype != torch.int32:
        raise TypeError("flash_attention: positions must be int32")
    if k_valid is not None and (k_valid.dtype != torch.bool or k_valid.shape != (b, tk)):
        raise ValueError("flash_attention: k_valid must be bool [B, Tk]")
    scale = scale if scale is not None else d ** -0.5
    code = _build.dtype_code(q)
    out = torch.empty_like(q)
    lib = _build.library()
    rc = lib.flash_attention_launch(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(),
        k_positions.data_ptr(), None if k_valid is None else k_valid.data_ptr(),
        out.data_ptr(), b, tq, tk, hq, hkv, d, int(causal),
        -1 if window is None else int(window), float(scale), _build.stream_of(q),
    )
    _build.check(rc, "flash_attention")
    LAUNCHES += 1
    return out
