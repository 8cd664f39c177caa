"""Mamba-2 chunked SSD scan: the CUDA kernels ``csrc/ssd_scan.cu`` and their
plain versions.

Replaces ``repro/kernels/ssd_scan.py::ssd_scan_pallas`` (``_ssd_kernel``):
per chunk of Q positions, the quadratic intra-chunk term
``(C_i.B_j) exp(cum_i - cum_j) dt_j x_j`` (j <= i), the inter-chunk term
``exp(cum_i) C_i h_prev``, ``+ D x``, and the state update; returns y and
the final f32 state. The TPU kernel carries the state across a sequential
grid axis. On the GPU a bf16 call runs three stages (:func:`launch_plan`):
each chunk's own state on the tensor cores, the sequential recurrence over
chunks, then every chunk's outputs in parallel; the plain versions of the
stages are :func:`chunk_cumsum_plain`, :func:`chunk_state_plain`,
:func:`state_passing_plain` and :func:`chunk_scan_plain`. f32 operands of
the tensor-core products are split in two bf16 halves (:func:`split_bf16`),
which the final state's tolerance needs. An f32 call runs the first
design: one block per (batch row, head) walking the chunks in order with
f32 FMAs (see the source's note).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

#: calls that launched the CUDA kernels in this process (chip_smoke resets
#: and reads it); one per call, whatever :func:`launch_plan` launches
LAUNCHES = 0
#: widest head (P), state (N) and chunk (Q) the kernel takes
MAX_P, MAX_N, MAX_CHUNK = 64, 128, 256


def ssd_scan_plain(
    x: torch.Tensor,  # [B, T, H, P]
    dt: torch.Tensor,  # [B, T, H] f32
    A: torch.Tensor,  # [H] f32
    B_: torch.Tensor,  # [B, T, G, N]
    C: torch.Tensor,  # [B, T, G, N]
    D: torch.Tensor,  # [H] f32
    *,
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # [B, H, P, N] f32
):
    """A torch copy of the reference's chunked XLA scan
    (``repro/kernels/ops.py::_ssd_chunked_xla``): zero-pad T to a chunk
    multiple, f32 intra-chunk scores with the decay clamped to 0 before
    ``exp`` in the masked triangle, chunk states, the sequential inter-chunk
    recurrence, then ``+ D x``. Returns (y in ``x``'s type, final state f32)."""
    b, t, h, p = x.shape
    g, n = B_.shape[2], B_.shape[3]
    rep = h // g
    pad = (-t) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    tp = t + pad
    nc = tp // chunk

    xf = x.float().reshape(b, nc, chunk, h, p)
    dtf = dt.float().reshape(b, nc, chunk, h)
    Bf = torch.repeat_interleave(B_.float(), rep, dim=2).reshape(b, nc, chunk, h, n)
    Cf = torch.repeat_interleave(C.float(), rep, dim=2).reshape(b, nc, chunk, h, n)
    Af = A.float()

    log_decay = dtf * Af[None, None, None, :]  # [B,nc,Q,H], <= 0
    cum = torch.cumsum(log_decay, dim=2)  # inclusive
    cum_total = cum[:, :, -1]  # [B,nc,H]

    cb = torch.einsum("bcqhn,bckhn->bchqk", Cf, Bf)
    cum_h = cum.permute(0, 1, 3, 2)  # [B,nc,H,Q]
    ldiff = cum_h[..., :, None] - cum_h[..., None, :]  # [B,nc,H,Q,Q]
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    ldiff = torch.where(causal, ldiff, torch.zeros_like(ldiff))  # no overflow above
    decay_mat = torch.where(causal, torch.exp(ldiff), torch.zeros_like(ldiff))
    w = cb * decay_mat * dtf.permute(0, 1, 3, 2)[..., None, :]
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", w, xf)

    state_w = torch.exp(cum_total[:, :, None] - cum) * dtf  # [B,nc,Q,H]
    chunk_states = torch.einsum("bckh,bckhn,bckhp->bchpn", state_w, Bf, xf)
    decay_chunk = torch.exp(cum_total)  # [B,nc,H]
    hstate = (initial_state.float() if initial_state is not None
              else torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(hstate)
        hstate = decay_chunk[:, c, :, None, None] * hstate + chunk_states[:, c]
    h_prev = torch.stack(h_prevs, dim=1)  # [B,nc,H,P,N] state before each chunk

    y_inter = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Cf, h_prev, torch.exp(cum))
    y = (y_intra + y_inter).reshape(b, tp, h, p)[:, :t]
    y = y + D.float()[None, None, :, None] * xf.reshape(b, tp, h, p)[:, :t]
    return y.to(x.dtype), hstate


def launch_plan(b: int, t: int, h: int, p: int, g: int, n: int, chunk: int,
                dtype: torch.dtype = torch.bfloat16) -> Tuple[str, ...]:
    """The device kernels one ``ssd_scan_cuda`` call launches, in order, from
    the shapes alone: f32 one walk; bf16 the chunk state, the state passing
    (not with exactly one chunk: the chunk state writes the final state
    itself) and the chunk scan. ``g`` and ``p``, ``n`` do not change it."""
    if b == 0 or h == 0:
        return ()
    if dtype != torch.bfloat16:
        return ("ssd_scan_kernel",)
    n_chunks = math.ceil(t / chunk)
    return (("ssd_chunk_state_kernel",) * (n_chunks >= 1)
            + ("ssd_state_passing_kernel",) * (n_chunks != 1)
            + ("ssd_chunk_scan_kernel",) * (n_chunks >= 1))


def split_bf16(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) in bf16 with hi = bf16(v), lo = bf16(v - hi): the two halves
    an f32 operand goes to the tensor cores as (hi + lo is ~2^-17 relative
    to v)."""
    hi = v.to(torch.bfloat16)
    return hi, (v - hi.float()).to(torch.bfloat16)


def _chunked(a: torch.Tensor, chunk: int) -> torch.Tensor:
    """[B, T, ...] zero-padded to a chunk multiple, as f32 [B, nc, Q, ...]."""
    pad = (-a.shape[1]) % chunk
    a = F.pad(a.float(), (0, 0) * (a.ndim - 2) + (0, pad))
    return a.reshape(a.shape[0], -1, chunk, *a.shape[2:])


def chunk_cumsum_plain(dt: torch.Tensor, A: torch.Tensor, chunk: int) -> torch.Tensor:
    """Stage 1's inclusive cumulative decay, [B, H, nc, Q] f32: the sum of
    dt * A inside each chunk (past T, dt is zero, so the last sum repeats)."""
    return torch.cumsum(_chunked(dt, chunk) * A.float(), dim=2).permute(0, 3, 1, 2)


def chunk_state_plain(x, dt, B_, cum, chunk: int,
                      operand: Optional[Callable] = None) -> torch.Tensor:
    """Stage 1's state of each chunk alone, [B, H, nc, P, N] f32:
    ``sum_j exp(total - cum_j) dt_j x_j B_j^T``. ``operand`` maps the f32
    factor ``x_j * sw_j`` to what the product sees (the kernel's split, a
    single bf16 rounding, or nothing)."""
    h, g = x.shape[2], B_.shape[2]
    xf = _chunked(x, chunk)  # [B, nc, Q, H, P]
    Bf = torch.repeat_interleave(_chunked(B_, chunk), h // g, dim=3)  # [B, nc, Q, H, N]
    sw = torch.exp(cum[..., -1:] - cum) * _chunked(dt, chunk).permute(0, 3, 1, 2)
    xw = xf * sw.permute(0, 2, 3, 1)[..., None]
    if operand is not None:
        xw = operand(xw)
    return torch.einsum("bcqhp,bcqhn->bhcpn", xw, Bf)


def state_passing_plain(states, cum, initial_state=None):
    """Stage 2: ``h_c = exp(total_c) h_{c-1} + S_c`` over the chunks in
    order from ``initial_state`` or 0. Returns (the state before each chunk,
    [B, H, nc, P, N], and the final state, [B, H, P, N])."""
    b, h, nc, p, n = states.shape
    s = (initial_state.float() if initial_state is not None
         else torch.zeros((b, h, p, n), dtype=torch.float32, device=states.device))
    before = []
    for c in range(nc):
        before.append(s)
        s = torch.exp(cum[:, :, c, -1])[..., None, None] * s + states[:, :, c]
    return torch.stack(before, dim=2) if before else states, s


def chunk_scan_plain(x, dt, B_, C, D, cum, h_prev, chunk: int,
                     operand: Optional[Callable] = None) -> torch.Tensor:
    """Stage 3: y of every chunk from its cumulative decay and the state
    before it: ``sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) dt_j x_j +
    exp(cum_i) C_i h_prev^T + D x_i`` in ``x``'s type. ``operand`` maps the
    f32 operands W and h_prev as in :func:`chunk_state_plain`."""
    b, t, h, p = x.shape
    rep = h // B_.shape[2]
    op = operand if operand is not None else (lambda v: v)
    xf = _chunked(x, chunk)
    Bf = torch.repeat_interleave(_chunked(B_, chunk), rep, dim=3)
    Cf = torch.repeat_interleave(_chunked(C, chunk), rep, dim=3)
    dtf = _chunked(dt, chunk).permute(0, 3, 1, 2)  # [B, H, nc, Q]
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    ldiff = torch.where(causal, cum[..., :, None] - cum[..., None, :], torch.zeros(()))
    w = torch.einsum("bcihn,bcjhn->bhcij", Cf, Bf) * torch.where(
        causal, torch.exp(ldiff), torch.zeros(())) * dtf[..., None, :]
    y = torch.einsum("bhcij,bcjhp->bcihp", op(w), xf)
    y = y + torch.einsum("bcihn,bhcpn,bhci->bcihp", Cf, op(h_prev), torch.exp(cum))
    y = y.reshape(b, -1, h, p)[:, :t] + D.float()[None, None, :, None] * x.float()
    return y.to(x.dtype)


def ssd_scan_cuda(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B_: torch.Tensor,
    C: torch.Tensor,
    D: torch.Tensor,
    *,
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,
):
    """Launch the CUDA kernels of :func:`launch_plan` on PyTorch's current
    stream. ``x``, ``B_`` and ``C`` share one type (f32 or bf16); ``dt``,
    ``A``, ``D`` and ``initial_state`` are f32. Raises for anything the
    kernels do not take."""
    global LAUNCHES
    tensors = [x, dt, A, B_, C, D] + ([initial_state] if initial_state is not None else [])
    _build.require_cuda("ssd_scan", *tensors)
    b, t, h, p = x.shape
    g, n = B_.shape[2], B_.shape[3]
    if dt.shape != (b, t, h) or A.shape != (h,) or D.shape != (h,):
        raise ValueError("ssd_scan: dt must be [B, T, H], A and D [H]")
    if B_.shape != (b, t, g, n) or C.shape != B_.shape or g < 1 or h % g:
        raise ValueError(f"ssd_scan: B {tuple(B_.shape)} / C {tuple(C.shape)} do not fit "
                         f"x {tuple(x.shape)}")
    if not (1 <= p <= MAX_P and 1 <= n <= MAX_N and 1 <= chunk <= MAX_CHUNK):
        raise ValueError(f"ssd_scan: the kernel takes P <= {MAX_P}, N <= {MAX_N}, "
                         f"chunk <= {MAX_CHUNK}; got P={p}, N={n}, chunk={chunk}")
    if B_.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError("ssd_scan: x, B and C must share one type")
    f32 = [dt, A, D] + ([initial_state] if initial_state is not None else [])
    if any(a.dtype != torch.float32 for a in f32):
        raise TypeError("ssd_scan: dt, A, D and initial_state must be float32")
    if initial_state is not None and initial_state.shape != (b, h, p, n):
        raise ValueError("ssd_scan: initial_state must be [B, H, P, N]")
    if b > 65535 or h > 65535:  # the grids' y and z extents
        raise ValueError(f"ssd_scan: B={b}, H={h} exceed the grid")
    code = _build.dtype_code(x)
    y = torch.empty_like(x)
    h_t = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    cum_ws = states = None  # the bf16 route's f32 workspaces (source's note)
    if x.dtype == torch.bfloat16:
        n_chunks = math.ceil(t / chunk)
        cum_ws = torch.empty((b, h, n_chunks, chunk), dtype=torch.float32, device=x.device)
        if n_chunks > 1:
            states = torch.empty((b, h, n_chunks, p, n), dtype=torch.float32,
                                 device=x.device)
    lib = _build.library()
    rc = lib.ssd_scan_launch(
        code, x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(), C.data_ptr(),
        D.data_ptr(), None if initial_state is None else initial_state.data_ptr(),
        y.data_ptr(), h_t.data_ptr(), None if cum_ws is None else cum_ws.data_ptr(),
        None if states is None else states.data_ptr(), b, t, h, p, g, n, chunk,
        _build.stream_of(x),
    )
    _build.check(rc, "ssd_scan")
    LAUNCHES += 1
    return y, h_t
