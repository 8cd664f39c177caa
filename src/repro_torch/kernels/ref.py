"""Plain torch oracles, copies of ``repro/kernels/ref.py``: naive, fully
materialized, numerically straightforward. The tests hold the port's
kernels' plain versions and the JAX oracles against these."""
from __future__ import annotations

from typing import Optional

import torch


def _broadcast_kv(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Repeat KV heads to match Q heads (GQA): q-head ``h`` reads kv-head
    ``h // G``, i.e. ``repeat_interleave`` (``jnp.repeat``), not ``repeat``."""
    hkv = k.shape[2]
    hq = q.shape[2]
    if hq == hkv:
        return k
    return torch.repeat_interleave(k, hq // hkv, dim=2)


def attention_mask(
    q_positions: torch.Tensor,  # [B, Tq] absolute positions of queries
    k_positions: torch.Tensor,  # [B, Tk] absolute positions of keys
    *,
    causal: bool = True,
    window: Optional[int] = None,
    k_valid: Optional[torch.Tensor] = None,  # [B, Tk] bool
) -> torch.Tensor:
    """[B, Tq, Tk] boolean mask; True = attend."""
    qp = q_positions[:, :, None]
    kp = k_positions[:, None, :]
    mask = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape), dtype=torch.bool,
                      device=qp.device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    if k_valid is not None:
        mask &= k_valid[:, None, :]
    return mask


def attention_ref(
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
) -> torch.Tensor:
    """Naive attention oracle: materializes the full [B,H,Tq,Tk] scores."""
    b, tq, hq, d = q.shape
    tk = k.shape[1]
    dev = q.device
    if q_positions is None:
        q_positions = (torch.arange(tq, device=dev)[None, :] + (tk - tq)).expand(b, tq)
    if k_positions is None:
        k_positions = torch.arange(tk, device=dev)[None, :].expand(b, tk)
    scale = scale if scale is not None else d ** -0.5
    k = _broadcast_kv(q, k)
    v = _broadcast_kv(q, v)
    scores = torch.einsum("btHd,bsHd->bHts", q.float(), k.float()) * scale
    mask = attention_mask(
        q_positions, k_positions, causal=causal, window=window, k_valid=k_valid
    )
    scores = scores.masked_fill(~mask[:, None, :, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    # rows that attend to nothing (fully masked) produce NaN from softmax of
    # -inf; zero them (convention: empty context -> zero output)
    probs = torch.nan_to_num(probs, nan=0.0)
    out = torch.einsum("bHts,bsHd->btHd", probs, v.float())
    return out.to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,  # [B, Hq, D] — one new token per sequence
    k: torch.Tensor,  # [B, S, Hkv, D]
    v: torch.Tensor,  # [B, S, Hkv, Dv]
    lengths: torch.Tensor,  # [B] number of valid cache entries
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token decode oracle. The new token's K/V must already be in
    the cache (lengths includes it); masking is purely by validity."""
    s = k.shape[1]
    k_valid = torch.arange(s, device=k.device)[None, :] < lengths[:, None]
    out = attention_ref(q[:, None], k, v, causal=False, k_valid=k_valid, scale=scale)
    return out[:, 0]


def rmsnorm_ref(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)
