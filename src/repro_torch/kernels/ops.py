"""Dispatch for the port's kernels, with the signatures of
``repro/kernels/ops.py``.

``impl``:

- ``cuda``  — the hand-written CUDA kernel (``csrc/``); raises for CPU
              tensors or anything else the kernel does not take;
- ``torch`` — the kernel's plain PyTorch version;
- ``auto``  — ``cuda`` for CUDA tensors, ``torch`` for CPU tensors. Never a
              silent fallback: a CUDA tensor launches the kernel or raises.

Inputs are made contiguous here (a no-op for the served path's tensors),
so the kernel wrappers only ever see the layout they take.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rmsnorm as _rn

NEG_INF = -1e30  # finite sentinel: keeps online softmax NaN-free
IMPLS = ("auto", "torch", "cuda")


def _resolve(impl: str, x: torch.Tensor) -> str:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; choose from {IMPLS}")
    if impl == "auto":
        return "cuda" if x.is_cuda else "torch"
    return impl


def flash_attention(
    q: torch.Tensor,  # [B, Tq, Hq, D]
    k: torch.Tensor,  # [B, Tk, Hkv, D]
    v: torch.Tensor,  # [B, Tk, Hkv, Dv]
    *,
    q_positions: Optional[torch.Tensor] = None,
    k_positions: Optional[torch.Tensor] = None,
    causal: bool = True,
    window: Optional[int] = None,
    k_valid: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    impl = _resolve(impl, q)
    b, tq = q.shape[:2]
    tk = k.shape[1]
    dev = q.device
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q_positions is None:
        q_positions = torch.arange(tq, device=dev)[None] + (tk - tq)
    if k_positions is None:
        k_positions = torch.arange(tk, device=dev)[None]
    q_positions = q_positions.to(torch.int32).expand(b, tq).contiguous()
    k_positions = k_positions.to(torch.int32).expand(b, tk).contiguous()
    if k_valid is not None:
        k_valid = k_valid.to(torch.bool).expand(b, tk).contiguous()
    fn = _fa.flash_attention_cuda if impl == "cuda" else _fa.flash_attention_plain
    return fn(q.contiguous(), k.contiguous(), v.contiguous(), q_positions=q_positions,
              k_positions=k_positions, causal=causal, window=window, k_valid=k_valid,
              scale=scale)


def decode_attention(
    q: torch.Tensor,  # [B, Hq, D]
    k: torch.Tensor,  # [B, S, Hkv, D]
    v: torch.Tensor,  # [B, S, Hkv, Dv]
    lengths: torch.Tensor,  # [B]
    *,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    impl = _resolve(impl, q)
    lengths = lengths.to(torch.int32).contiguous()
    fn = _da.decode_attention_cuda if impl == "cuda" else _da.decode_attention_plain
    return fn(q.contiguous(), k.contiguous(), v.contiguous(), lengths, scale=scale)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
            impl: str = "auto") -> torch.Tensor:
    impl = _resolve(impl, x)
    fn = _rn.rmsnorm_cuda if impl == "cuda" else _rn.rmsnorm_plain
    return fn(x.contiguous(), weight.contiguous(), eps)
