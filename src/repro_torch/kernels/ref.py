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


def int_matmul_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of int8 operands with an exact int32 result. The CPU has
    integer matmuls; CUDA has none in torch, so there the product runs in
    float64, which is exact: |int8 * int8| <= 16129 and a sum of up to
    2**37 such terms stays below 2**53."""
    if a.is_cuda:
        return (a.double() @ b.double()).to(torch.int32)
    return a.to(torch.int32) @ b.to(torch.int32)


def int8_matmul_ref(
    x: torch.Tensor,  # [..., K] activations (bf16/f32), or int8 when x_scale is given
    w_q: torch.Tensor,  # [K, N] int8 weights
    w_scale: torch.Tensor,  # [N] per-output-channel scales (f32)
    x_scale: Optional[torch.Tensor] = None,  # [..., 1] per-row scales (dynamic quant)
) -> torch.Tensor:
    """Weight-only (x_scale=None: dequantize first in f32, out ``x.dtype``)
    or dynamic (x pre-quantized int8: int32 accumulator, then
    ``acc * x_scale * w_scale`` in f32) oracle."""
    if x_scale is None:
        w = w_q.float() * w_scale[None, :].float()
        return (x.float() @ w).to(x.dtype)
    acc = int_matmul_exact(x, w_q)
    return acc.float() * x_scale.float() * w_scale[None, :].float()


def ssd_ref(
    x: torch.Tensor,  # [B, T, H, P] inputs (P = head_dim)
    dt: torch.Tensor,  # [B, T, H] softplus'd step sizes
    A: torch.Tensor,  # [H] negative reals
    B_: torch.Tensor,  # [B, T, G, N] input matrices (G groups, N = d_state)
    C: torch.Tensor,  # [B, T, G, N] output matrices
    D: torch.Tensor,  # [H] skip connection
    *,
    initial_state: Optional[torch.Tensor] = None,  # [B, H, P, N]
):
    """Sequential Mamba-2 SSD recurrence oracle.

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t B_t^T ;  y_t = C_t h_t + D x_t
    Returns (y [B,T,H,P], final_state [B,H,P,N])."""
    b, t, h, p = x.shape
    g, n = B_.shape[2], B_.shape[3]
    rep = h // g
    xf = x.float()
    dtf = dt.float()
    Bf = torch.repeat_interleave(B_.float(), rep, dim=2)  # [B,T,H,N]
    Cf = torch.repeat_interleave(C.float(), rep, dim=2)
    Af = A.float()
    state = (initial_state.float() if initial_state is not None
             else torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device))
    ys = []
    for i in range(t):
        decay = torch.exp(dtf[:, i] * Af[None, :])  # [B, H]
        upd = torch.einsum("bh,bhp,bhn->bhpn", dtf[:, i], xf[:, i], Bf[:, i])
        state = decay[:, :, None, None] * state + upd
        ys.append(torch.einsum("bhn,bhpn->bhp", Cf[:, i], state))
    y = torch.stack(ys, dim=1) + D.float()[None, None, :, None] * xf
    return y.to(x.dtype), state


def hstu_attention_ref(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, T, H, D]
    v: torch.Tensor,  # [B, T, H, D]
    rel_bias: torch.Tensor,  # [2*max_rel-1] learned relative position bias table
    *,
    max_attn_len: Optional[int] = None,
    lengths: Optional[torch.Tensor] = None,  # [B]
) -> torch.Tensor:
    """HSTU pointwise-normalized attention oracle (§4.1.1 of the paper):
    A = silu(QK^T + rab) / T ; out = A @ V   (no softmax)."""
    b, t, h, d = q.shape
    max_rel = (rel_bias.shape[0] + 1) // 2
    qp = torch.arange(t, device=q.device)
    delta = torch.clamp(qp[:, None] - qp[None, :], -(max_rel - 1), max_rel - 1)
    rab = rel_bias.float()[delta + (max_rel - 1)]  # [T, T]
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    scores = scores * (d ** -0.5) + rab[None, None]
    mask = qp[None, :, None] >= qp[None, None, :]  # causal
    if max_attn_len is not None:
        mask = mask & (qp[None, :, None] - qp[None, None, :] < max_attn_len)
    if lengths is not None:
        mask = mask & (qp[None, None, :] < lengths.to(q.device)[:, None, None])
    a = torch.nn.functional.silu(scores) / t
    a = torch.where(mask[:, None, :, :], a, torch.zeros_like(a))
    out = torch.einsum("bhts,bshd->bthd", a, v.float())
    return out.to(q.dtype)
