"""Dispatch for the port's kernels, with the signatures of
``repro/kernels/ops.py``.

``impl``:

- ``cuda``  — the hand-written CUDA kernel (``csrc/``); raises for CPU
              tensors or anything else the kernel does not take;
- ``torch`` — the kernel's plain PyTorch version;
- ``auto``  — ``cuda`` for CUDA tensors, ``torch`` for CPU tensors. Never a
              silent fallback: a CUDA tensor launches the kernel or raises.

The kernels have no backward: each writes its output into a fresh tensor
through ``ctypes``, which autograd would take for a constant. So a ``cuda``
dispatch raises when grad mode is on and an input requires a gradient
(``_check_no_grad``); training runs ``impl="torch"``.

Inputs are made contiguous here (a no-op for the served path's tensors),
so the kernel wrappers only ever see the layout they take. Two operands
are the exceptions: the fused RMSNorms' second operand, a view whose rows
share one stride (a slice of a wider projection), and an attention V that
is the leading slice of its K (MLA's absorbed latent, ``_v_of``) reach the
kernel as they are.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.analysis.hotpath import hot_path
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import hstu_attention as _ha
from repro_torch.kernels import int8_matmul as _im
from repro_torch.kernels import paged_decode_attention as _pda
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssd_scan as _ss

NEG_INF = -1e30  # finite sentinel: keeps online softmax NaN-free
IMPLS = ("auto", "torch", "cuda")


def _resolve(impl: str, x: torch.Tensor) -> str:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; choose from {IMPLS}")
    if impl == "auto":
        return "cuda" if x.is_cuda else "torch"
    return impl


def _check_no_grad(impl: str, *inputs: Optional[torch.Tensor]) -> None:
    """Refuse a kernel launch that autograd would need to differentiate."""
    if impl == "cuda" and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        raise RuntimeError(
            "a CUDA kernel wrapper got an input that requires a gradient: the port's "
            "kernels have no backward; train with impl='torch'")


def _v_of(v: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``v`` as the kernels take it: kept as a view when it is ``k``'s
    leading slice (``_build.leading_slice``), else contiguous."""
    return v if _build.leading_slice(v, k) else v.contiguous()


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
    _check_no_grad(impl, q, k, v)
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
    k = k.contiguous()
    return fn(q.contiguous(), k, _v_of(v, k), q_positions=q_positions,
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
    _check_no_grad(impl, q, k, v)
    lengths = lengths.to(torch.int32).contiguous()
    fn = _da.decode_attention_cuda if impl == "cuda" else _da.decode_attention_plain
    k = k.contiguous()
    return fn(q.contiguous(), k, _v_of(v, k), lengths, scale=scale)


def decode_attention_partial(
    q: torch.Tensor,  # [B, Hq, D]
    k: torch.Tensor,  # [B, S_shard, Hkv, D]: a shard of the cache
    v: torch.Tensor,  # [B, S_shard, Hkv, Dv]
    valid: torch.Tensor,  # [B] counts of a valid prefix, or a [B, S_shard] mask
    *,
    scale: Optional[float] = None,
    out: Optional[torch.Tensor] = None,
    impl: str = "auto",
):
    """Flash-decode partial over one shard of the cache: (acc [B, Hq, Dv],
    m [B, Hq], l [B, Hq]) in f32, unnormalised, for
    :func:`combine_partial_attention` (the reference's
    ``decode_attention_partial``). ``valid`` counts each row's valid prefix
    (int, [B]: the partial-form kernel on the card, its plain version on the
    CPU; the triple lands in the flat f32 buffer ``out`` when given, see
    ``decode_attention.split_partial``), or masks any rows (bool [B,
    S_shard]: the plain version only, which a CUDA dispatch refuses)."""
    impl = _resolve(impl, q)
    _check_no_grad(impl, q, k, v)
    if valid.dtype == torch.bool:
        if impl == "cuda":
            raise ValueError("decode_attention_partial: the kernel takes counts of a valid "
                             "prefix, not a mask")
        if out is not None:
            raise ValueError("decode_attention_partial: out= takes counts, not a mask")
        return _da.decode_attention_partial(q, k, v, valid, scale=scale)
    b, hq = q.shape[:2]
    fn = (_da.decode_attention_partial_cuda if impl == "cuda"
          else _da.decode_attention_partial_plain)
    k = k.contiguous()
    buf = fn(q.contiguous(), k, v.contiguous(), valid.to(torch.int32).contiguous(),
             scale=scale, out=out)
    return _da.split_partial(buf, b, hq, v.shape[-1])


def combine_partial_attention(accs: torch.Tensor, ms: torch.Tensor, ls: torch.Tensor, *,
                              impl: str = "auto") -> torch.Tensor:
    """LSE-combine f32 flash-decode partials stacked on a leading shard axis
    (accs [P, B, H, Dv], ms and ls [P, B, H]) into f32 [B, H, Dv]: the merge
    kernel on the card (strided views as they are), its plain version on
    the CPU."""
    impl = _resolve(impl, accs)
    if impl == "cuda":
        return _da.combine_partial_attention_cuda(accs, ms, ls)
    return _da.combine_partial_attention(accs, ms, ls)


@hot_path
def paged_decode_attention(
    q: torch.Tensor,  # [B, Hq, D]
    kbuf: torch.Tensor,  # [NB, bs, Hkv, D] block pool, or [NB, bs, D] (latent)
    vbuf: Optional[torch.Tensor],  # like kbuf, or None: V = K[..., :v_dim]
    bt: torch.Tensor,  # [B, MB] block table
    n_valid: torch.Tensor,  # [B] valid cached tokens per row
    *,
    scale: Optional[float] = None,
    v_dim: Optional[int] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Flash-decode straight off a block pool through the block table (the
    reference's XLA ``paged_decode_attention``); out in q's type.
    ``vbuf=None`` with ``v_dim`` serves MLA's absorbed latent: a shared-head
    pool [NB, bs, D] whose V is the leading ``v_dim`` columns of K."""
    impl = _resolve(impl, q)
    _check_no_grad(impl, q, kbuf, vbuf)
    bt = bt.to(torch.int32).contiguous()
    n_valid = n_valid.to(torch.int32).contiguous()
    fn = (_pda.paged_decode_attention_cuda if impl == "cuda"
          else _pda.paged_decode_attention_plain)
    return fn(q.contiguous(), kbuf.contiguous(), None if vbuf is None else vbuf.contiguous(),
              bt, n_valid, scale=scale, v_dim=v_dim)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
            impl: str = "auto") -> torch.Tensor:
    impl = _resolve(impl, x)
    _check_no_grad(impl, x, weight)
    fn = _rn.rmsnorm_cuda if impl == "cuda" else _rn.rmsnorm_plain
    return fn(x.contiguous(), weight.contiguous(), eps)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the fused RMSNorms' second operand: itself when its rows
    share one stride with a unit last stride (the kernel reads it in place),
    else a contiguous copy."""
    if t.numel() and t.stride(-1) == 1:
        try:
            t.view(-1, t.shape[-1])
            return t
        except RuntimeError:
            pass
    return t.contiguous()


def _fused(kernel, plain, impl: str, x: torch.Tensor, other: torch.Tensor,
           weight: torch.Tensor, eps: float):
    impl = _resolve(impl, x)
    _check_no_grad(impl, x, other, weight)
    if other.shape != x.shape or other.dtype != x.dtype:
        raise ValueError(f"fused rmsnorm: operands {tuple(x.shape)} {x.dtype} and "
                         f"{tuple(other.shape)} {other.dtype} differ")
    fn = kernel if impl == "cuda" else plain
    return fn(x.contiguous(), _rows(other), weight.contiguous(), eps)


def add_rmsnorm(x: torch.Tensor, r: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
                impl: str = "auto"):
    """``(s, rmsnorm(s))`` with ``s = x + r`` (a residual add and the norm
    after it, one kernel on the card); ``s`` equals ``x + r`` bit for bit."""
    return _fused(_rn.add_rmsnorm_cuda, _rn.add_rmsnorm_plain, impl, x, r, weight, eps)


def mul_rmsnorm(a: torch.Tensor, u: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
                impl: str = "auto") -> torch.Tensor:
    """``rmsnorm(a * u)`` (HSTU's gate and output norm, one kernel on the
    card)."""
    return _fused(_rn.mul_rmsnorm_cuda, _rn.mul_rmsnorm_plain, impl, a, u, weight, eps)


def mul_silu_rmsnorm(y: torch.Tensor, z: torch.Tensor, weight: torch.Tensor,
                     eps: float = 1e-5, impl: str = "auto") -> torch.Tensor:
    """``rmsnorm(y * silu(z))`` (Mamba-2's gated norm, one kernel on the
    card)."""
    return _fused(_rn.mul_silu_rmsnorm_cuda, _rn.mul_silu_rmsnorm_plain, impl, y, z, weight,
                  eps)


def mul_silu_rmsnorm_split(y: torch.Tensor, z: torch.Tensor, weight: torch.Tensor,
                           d_total: int, reduce: Callable[[torch.Tensor], torch.Tensor],
                           eps: float = 1e-5, impl: str = "auto") -> torch.Tensor:
    """``rmsnorm(y * silu(z))`` of rows whose ``d_total`` channels lie on
    several ranks, ``y`` / ``z`` / ``weight`` holding this rank's: the
    rank's partial sums of squares [...] f32, ``reduce`` summing them over
    the ranks in place, then the scale (two launches on the card about the
    reduce)."""
    impl = _resolve(impl, y)
    _check_no_grad(impl, y, z, weight)
    if z.shape != y.shape or z.dtype != y.dtype:
        raise ValueError(f"split rmsnorm: operands {tuple(y.shape)} {y.dtype} and "
                         f"{tuple(z.shape)} {z.dtype} differ")
    cuda = impl == "cuda"
    partial = _rn.mul_silu_partial_cuda if cuda else _rn.mul_silu_partial_plain
    scale = _rn.rmsnorm_scale_cuda if cuda else _rn.rmsnorm_scale_plain
    p, sumsq = partial(y.contiguous(), _rows(z))
    sumsq = reduce(sumsq)
    return scale(p, sumsq, weight.contiguous(), d_total, eps)


# --------------------------------------------------------------------------
# Int8 matmul (AutoQuant substrate)
# --------------------------------------------------------------------------

def quantize_int8(w: torch.Tensor, axis: int = 0):
    """Symmetric per-channel int8 quantization along ``axis`` (the
    contraction axis): returns (w_q int8, scale f32 over remaining dims).
    ``max(amax, 1e-8) / 127`` and then ``w / scale``, rounded half to even,
    in that order, so the int8 weights are bit-identical to the reference's."""
    wf = w.float()
    w_q, scale = _int8_codes(wf, wf.abs().amax(dim=axis, keepdim=True))
    return w_q, scale.squeeze(axis)


def _int8_codes(xf: torch.Tensor, amax: torch.Tensor):
    """(int8 codes, f32 scale) of ``xf`` under its channels' ``amax``."""
    scale = torch.clamp(amax, min=1e-8) / 127.0
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def int8_matmul_weight_only(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                            impl: str = "auto") -> torch.Tensor:
    """x @ dequant(w_q), out ``x.dtype``: the memory-bound lever (paper
    §4.2 weight-only); the per-output-channel scale is applied after the
    dot."""
    impl = _resolve(impl, x)
    _check_no_grad(impl, x, w_scale)
    fn = (_im.int8_matmul_weight_only_cuda if impl == "cuda"
          else _im.int8_matmul_weight_only_plain)
    return fn(x.contiguous(), w_q.contiguous(), w_scale.float().contiguous())


def quantize_rows(x: torch.Tensor, amax_reduce: Optional[Callable] = None):
    """Dynamic activation quantization, per row of ``x [..., K]``: returns
    (x_q int8 [..., K], x_scale f32 [..., 1]), by the same formula and in
    the same order as ``quantize_int8``. ``amax_reduce`` maps each row's
    amax [..., 1] to the whole row's when ``x`` holds only a slice of its K
    axis (a row-parallel linear under tensor parallelism: the max over the
    ranks), so the codes are those of the whole row."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    if amax_reduce is not None:
        amax = amax_reduce(amax)
    return _int8_codes(xf, amax)


def int8_matmul_dynamic(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                        impl: str = "auto", amax_reduce: Optional[Callable] = None
                        ) -> torch.Tensor:
    """Dynamic per-row activation quantization + int8 x int8 GEMM, out f32:
    the compute-bound lever (paper §4.2 dynamic). The activation scales
    (amax, scale, round, clip) are plain torch outside the kernel, as the
    reference computes them outside its Pallas kernel; ``amax_reduce`` as
    in ``quantize_rows``."""
    impl = _resolve(impl, x)
    _check_no_grad(impl, x, w_scale)
    x_q, x_scale = quantize_rows(x, amax_reduce)
    fn = _im.int8_matmul_dynamic_cuda if impl == "cuda" else _im.int8_matmul_dynamic_plain
    return fn(x_q, w_q.contiguous(), w_scale.float().contiguous(), x_scale)


# --------------------------------------------------------------------------
# Mamba-2 SSD (chunked state-space duality)
# --------------------------------------------------------------------------

def ssd_scan(
    x: torch.Tensor,  # [B, T, H, P]
    dt: torch.Tensor,  # [B, T, H] (already softplus'd, >0)
    A: torch.Tensor,  # [H] (negative)
    B_: torch.Tensor,  # [B, T, G, N]
    C: torch.Tensor,  # [B, T, G, N]
    D: torch.Tensor,  # [H]
    *,
    chunk: int = 256,
    initial_state: Optional[torch.Tensor] = None,
    impl: str = "auto",
):
    """(y [B, T, H, P] in ``x``'s type, final state [B, H, P, N] f32). The
    chunk is ``min(chunk, T)``, as the TPU kernel's wrapper takes it; the
    chunked result equals the sequential recurrence up to rounding."""
    impl = _resolve(impl, x)
    _check_no_grad(impl, x, dt, A, B_, C, D, initial_state)
    chunk = max(1, min(chunk, x.shape[1]))
    if initial_state is not None:
        initial_state = initial_state.float().contiguous()
    fn = _ss.ssd_scan_cuda if impl == "cuda" else _ss.ssd_scan_plain
    return fn(x.contiguous(), dt.float().contiguous(), A.float().contiguous(),
              B_.to(x.dtype).contiguous(), C.to(x.dtype).contiguous(),
              D.float().contiguous(), chunk=chunk, initial_state=initial_state)


def ssd_decode_step(
    x: torch.Tensor,  # [B, H, P] one token
    dt: torch.Tensor,  # [B, H]
    A: torch.Tensor,  # [H]
    B_: torch.Tensor,  # [B, G, N]
    C: torch.Tensor,  # [B, G, N]
    D: torch.Tensor,  # [H]
    state: torch.Tensor,  # [B, H, P, N]
):
    """Single-token SSD recurrence (decode): O(H.P.N) per token, plain
    torch on every device (the reference computes it in XLA; it has no
    Pallas kernel). Returns (y [B, H, P] in ``x``'s type, new state f32)."""
    h = x.shape[1]
    rep = h // B_.shape[1]
    xf, dtf = x.float(), dt.float()
    Bf = torch.repeat_interleave(B_.float(), rep, dim=1)
    Cf = torch.repeat_interleave(C.float(), rep, dim=1)
    decay = torch.exp(dtf * A.float()[None])
    upd = torch.einsum("bh,bhp,bhn->bhpn", dtf, xf, Bf)
    new_state = decay[:, :, None, None] * state.float() + upd
    y = torch.einsum("bhn,bhpn->bhp", Cf, new_state)
    y = y + D.float()[None, :, None] * xf
    return y.to(x.dtype), new_state


# --------------------------------------------------------------------------
# HSTU pointwise attention
# --------------------------------------------------------------------------

def hstu_attention(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,
    v: torch.Tensor,
    rel_bias: torch.Tensor,  # [2 * max_rel - 1]
    *,
    max_attn_len: Optional[int] = None,
    lengths: Optional[torch.Tensor] = None,  # [B]
    impl: str = "auto",
) -> torch.Tensor:
    """``SiLU(q.k^T * D^-1/2 + rel_bias[clip(i - j)]) / T`` times V under the
    causal, ``max_attn_len`` and key-length masks; ``lengths`` None means
    every row is ``T`` long."""
    impl = _resolve(impl, q)
    _check_no_grad(impl, q, k, v, rel_bias)
    b, t = q.shape[:2]
    if lengths is None:
        lengths = torch.full((b,), t, dtype=torch.int32, device=q.device)
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    fn = _ha.hstu_attention_cuda if impl == "cuda" else _ha.hstu_attention_plain
    return fn(q.contiguous(), k.contiguous(), v.contiguous(), rel_bias.float().contiguous(),
              max_attn_len=max_attn_len, lengths=lengths)
