"""Flash attention forward: the CUDA kernel ``csrc/flash_attention.cu`` and
its plain version.

Replaces ``repro/kernels/flash_attention.py::flash_attention_pallas``
(``_flash_kernel``): FlashAttention-2 forward, GQA-native (one block holds
the whole q-head group of one KV head), masks built from explicit query/key
positions (causal, sliding ``window``) and ``k_valid``, f32 online softmax
with the ``-1e30`` sentinel and the ``max(l, 1e-30)`` clamp, fully masked
key tiles skipped. bf16 runs on the tensor cores (mma.sync, P rounded to
bf16 for P.V, the one rounding the f32 reference lacks); f32 keeps exact
f32 FMAs on the CUDA cores, since TF32 could not meet the f32 tolerance. At
the served prefill shapes (B=1, T<=256, 32/8 heads, D=64) the H100 bound
is bytes, and latency dominates (see the source's note).

Widths (:func:`supports`): D == Dv in {16, 32, 64, 128, 256} in both
types (16 and 32: the smoke configs' heads; 256: recurrentgemma's local
attention, G = 10 over one KV head, window 2048; the bf16 kernel reloads
Q's fragments from shared memory at each k-step there, since Q and a 16 x
256 f32 output tile a warp would not fit in registers together); MLA's
prefill (D = nope + rope against Dv = v_head: (96, 64) for the smoke config,
(192, 128)) in both types; MLA's absorbed latent (one KV head whose V is the
view ``k[..., :Dv]``: (96, 64) and (576, 512)) in both types, bf16 on its
own kernel (``flash_latent_kernel``: 64 (token, head) rows a block, the
output columns over min(128, Dv) column blocks, V read from the key tile),
f32 on the CUDA-core kernel with V read at K's row stride. Anything else
raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
#: launches of the CUDA kernel in this process (chip_smoke resets and reads it)
LAUNCHES = 0
#: head widths the kernels are instantiated for (D == Dv)
HEAD_DIMS = (16, 32, 64, 128, 256)
#: (D, Dv) of MLA's prefill: the smoke config's and deepseek-v2-236b's
PREFILL_MLA = ((96, 64), (192, 128))
#: (D, Dv) of MLA's absorbed latent (Hkv = 1, V = K[..., :Dv])
LATENT = ((96, 64), (576, 512))
#: most query heads per KV head one block holds (the bf16 GQA kernel)
MAX_GROUP = 64
DTYPES = (torch.float32, torch.bfloat16)


def is_latent(k: torch.Tensor, v: torch.Tensor) -> bool:
    """MLA's absorbed latent form: one KV head whose V is the view
    ``k[..., :Dv]`` of a contiguous K, narrower than K."""
    return k.dim() == 4 and k.shape[2] == 1 and v.shape[-1] < k.shape[-1] and \
        _build.leading_slice(v, k)


def supports(d: int, dv: int, hq: int, hkv: int, dtype: torch.dtype,
             latent: bool = False) -> bool:
    """True when the CUDA kernels take q heads ``hq`` of width ``d`` over
    ``hkv`` KV heads with V of width ``dv`` in ``dtype`` (``latent``: the
    absorbed form, V the leading ``dv`` columns of the one KV head). The
    wrapper's gate; pure, so a CPU test can check coverage."""
    if dtype not in DTYPES or hkv < 1 or hq < 1 or hq % hkv:
        return False
    if latent:
        return hkv == 1 and (d, dv) in LATENT
    return hq // hkv <= MAX_GROUP and ((d == dv and d in HEAD_DIMS) or (d, dv) in PREFILL_MLA)


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
    """Launch the CUDA kernel on PyTorch's current stream: the tensor-core
    kernel for bf16, the CUDA-core kernel for f32 (a dispatch by type; see
    the source's note). Positions must be contiguous int32 [B, T] and
    ``k_valid`` contiguous bool [B, Tk] (or None); bf16 q, k and v must be
    16-byte aligned (cp.async). Raises for anything the kernels do not
    take."""
    global LAUNCHES
    b, tq, hq, d = q.shape
    tk, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    latent = v.is_cuda and is_latent(k, v)  # V is read from K: never a copy
    v_gate = () if latent else (v,)
    extra = () if k_valid is None else (k_valid,)
    _build.require_cuda("flash_attention", q, k, *v_gate, q_positions, k_positions, *extra)
    if k.shape != (b, tk, hkv, d) or v.shape != (b, tk, hkv, dv):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not agree")
    if not supports(d, dv, hq, hkv, q.dtype, latent):
        raise ValueError(f"flash_attention: no kernel for D={d}, Dv={dv}, {hq} q heads over "
                         f"{hkv} KV heads in {q.dtype}{' (latent)' if latent else ''}: the "
                         f"kernels take D == Dv in {HEAD_DIMS} and G <= {MAX_GROUP}, MLA's "
                         f"prefill {PREFILL_MLA}, and the latent {LATENT} over one KV head "
                         f"whose V is the view k[..., :Dv]")
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
    code = _build.dtype_code(q)
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    if code == _build.BF16 and (qp | kp | vp) % 16:
        raise ValueError("flash_attention: the bf16 kernel needs 16-byte aligned q, k and v")
    scale = scale if scale is not None else d ** -0.5
    out = q.new_empty((b, tq, hq, dv))
    kv_ptr = None if k_valid is None else k_valid.data_ptr()
    win = -1 if window is None else int(window)
    if latent:
        rc = _build.library().flash_attention_latent_launch(
            code, qp, kp, q_positions.data_ptr(), k_positions.data_ptr(), kv_ptr,
            out.data_ptr(), b, tq, tk, hq, d, dv, int(causal), win, float(scale),
            _build.stream_of(q))
    else:
        rc = _build.library().flash_attention_launch(
            code, qp, kp, vp, q_positions.data_ptr(), k_positions.data_ptr(), kv_ptr,
            out.data_ptr(), b, tq, tk, hq, hkv, d, dv, int(causal), win, float(scale),
            _build.stream_of(q))
    _build.check(rc, "flash_attention")
    LAUNCHES += 1
    return out
