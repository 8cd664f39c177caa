"""Mamba-2 chunked SSD scan: the CUDA kernel ``csrc/ssd_scan.cu`` and its
plain version.

Replaces ``repro/kernels/ssd_scan.py::ssd_scan_pallas`` (``_ssd_kernel``):
per chunk of Q positions, the quadratic intra-chunk term
``(C_i.B_j) exp(cum_i - cum_j) dt_j x_j`` (j <= i), the inter-chunk term
``exp(cum_i) C_i h_prev``, ``+ D x``, and the state update; returns y and
the final f32 state. The TPU kernel carries the state across a sequential
grid axis; the CUDA kernel gives each (batch row, head) one block that
walks the chunks in order with the state in shared memory (see the
source's note). At the served prefill (B = 1, T = 256, 24 heads, P = 64,
N = 128) its 24 blocks' f32 FMA loops set its time.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

#: launches of the CUDA kernel in this process (chip_smoke resets and reads it)
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
    """Launch the CUDA kernel on PyTorch's current stream. ``x``, ``B_`` and
    ``C`` share one type (f32 or bf16); ``dt``, ``A``, ``D`` and
    ``initial_state`` are f32. Raises for anything the kernel does not take."""
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
    if b > 65535:  # the grid's y extent
        raise ValueError(f"ssd_scan: B={b} exceeds the grid")
    code = _build.dtype_code(x)
    y = torch.empty_like(x)
    h_t = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    lib = _build.library()
    rc = lib.ssd_scan_launch(
        code, x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(), C.data_ptr(),
        D.data_ptr(), None if initial_state is None else initial_state.data_ptr(),
        y.data_ptr(), h_t.data_ptr(), b, t, h, p, g, n, chunk, _build.stream_of(x),
    )
    _build.check(rc, "ssd_scan")
    LAUNCHES += 1
    return y, h_t
