"""RMSNorm with a fused prologue: the CUDA kernel ``csrc/rmsnorm.cu`` and its
plain versions.

Replaces ``repro/kernels/rmsnorm.py::rmsnorm_pallas`` (``_rmsnorm_kernel``).
The kernel normalises the row that its prologue makes out of two inputs:

=========  ==========  =======================================
prologue   inputs      outputs
=========  ==========  =======================================
none       x           ``rmsnorm(x)``
add        x, r        ``s = x + r`` and ``rmsnorm(s)``
mul        a, u        ``rmsnorm(a * u)``
mul_silu   y, z        ``rmsnorm(y * silu(z))``
=========  ==========  =======================================

Each intermediate is rounded to the tensors' type where the unfused
PyTorch ops round it, so the fused op equals its plain version (the
unfused ops, then :func:`rmsnorm_plain`) up to the norm's own f32 sums, and
``s`` equals ``x + r`` bit for bit. On the H100 it is bound by bytes: a
row is held in registers by one warp (by up to 8 on a grid of few rows),
loaded as 16-byte vectors and read once (see the source's note and
:func:`route`). The second operand may be a row-strided view (unit last
stride), read in place.

The split-row form (``mul_silu_split``) normalises a row whose channels lie
on several tensor-parallel ranks (Mamba-2's gate norm at TP > 1), in two
launches about a reduce the caller makes: ``mul_silu_partial_cuda`` writes
the rank's ``p = y * silu(z)`` and each row's f32 partial sum of squares,
the ranks sum the partials, and ``rmsnorm_scale_cuda`` scales ``p`` by
``rsqrt(sum / d_total + eps)`` and the weight. Each launch counts once under
``mul_silu_split``; the plain versions are ``mul_silu_partial_plain`` and
``rmsnorm_scale_plain``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

#: the prologues, in the order of the C interface's codes
PROLOGUES = ("none", "add", "mul", "mul_silu")
#: launches of the CUDA kernel in this process, over every prologue
LAUNCHES = 0
#: the split-row form's counter name (both of its launches)
SPLIT = "mul_silu_split"
#: launches by prologue, and the split-row form's (updated in place;
#: chip_smoke resets and reads it)
LAUNCHES_BY_PROLOGUE = dict.fromkeys(PROLOGUES + (SPLIT,), 0)
#: the warp path holds at most this many bytes of each operand a lane, with
#: at most MAX_WARPS warps a row: rows of up to 8 * 32 * 128 bytes (16384
#: bf16, 8192 f32); longer rows take the block-per-row kernel
LANE_BYTES, MAX_WARPS = 128, 8
#: warps a row double while a grid has fewer warps than this
TARGET_WARPS = 1024


def route(n_rows: int, d: int, dtype: torch.dtype) -> Tuple[str, Optional[int], Optional[int]]:
    """The kernel plan for ``n_rows`` rows of width ``d``, which the wrapper
    hands ``csrc/rmsnorm.cu``: ``("warp", W, E)`` with W warps a row (the
    fewest that hold the row within ``LANE_BYTES`` a lane, doubled up to
    ``MAX_WARPS`` while the grid has under ``TARGET_WARPS`` warps and every
    lane keeps a whole 16-byte vector: few rows are latency, which more
    warps a row split) and E elements a lane (the least of 8, 16, 32, 64,
    and at W = 1 also 24 and 48, that holds the row); or ``("block", None,
    None)``."""
    size = torch.finfo(dtype).bits // 8
    vec = 16 // size

    def need(w):
        return -(-d // (32 * w * vec)) * vec

    w = 1
    while w <= MAX_WARPS and need(w) * size > LANE_BYTES:
        w *= 2
    if w > MAX_WARPS:
        return "block", None, None
    while w < MAX_WARPS and n_rows * w < TARGET_WARPS and d >= 2 * w * 32 * vec:
        w *= 2
    sizes = (8, 16, 24, 32, 48, 64) if w == 1 else (8, 16, 32, 64)
    return "warp", w, next(e for e in sizes if need(w) <= e)


def rmsnorm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The kernel's function in plain torch: f32 mean of squares, rsqrt,
    weight multiply in f32, cast back to ``x``'s type."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * weight.float()).to(x.dtype)


def add_rmsnorm_plain(x: torch.Tensor, r: torch.Tensor, weight: torch.Tensor,
                      eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(s, rmsnorm(s))`` with ``s = x + r``: the unfused ops."""
    s = x + r
    return s, rmsnorm_plain(s, weight, eps)


def mul_rmsnorm_plain(a: torch.Tensor, u: torch.Tensor, weight: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """``rmsnorm(a * u)``: the unfused ops."""
    return rmsnorm_plain(a * u, weight, eps)


def mul_silu_rmsnorm_plain(y: torch.Tensor, z: torch.Tensor, weight: torch.Tensor,
                           eps: float = 1e-5) -> torch.Tensor:
    """``rmsnorm(y * silu(z))``: the unfused ops."""
    return rmsnorm_plain(y * F.silu(z), weight, eps)


def _launch(prologue: str, x: torch.Tensor, other: Optional[torch.Tensor],
            weight: torch.Tensor, eps: float):
    """Launch the kernel with ``prologue`` on PyTorch's current stream;
    returns ``(s or None, y)``. Raises for anything the kernel does not
    take: CPU or non-contiguous ``x``/``weight``, a second operand whose
    rows do not share one stride with a unit last stride, mixed types or
    devices, a weight of the wrong width."""
    global LAUNCHES
    _build.require_cuda("rmsnorm", x, weight)
    d = x.shape[-1]
    if weight.shape != (d,):
        raise ValueError(f"rmsnorm: weight {tuple(weight.shape)} does not match d={d}")
    if weight.dtype != x.dtype:
        raise TypeError(f"rmsnorm: weight {weight.dtype} differs from x {x.dtype}")
    code = _build.dtype_code(x)
    rows = None if other is None else _build.require_rows("rmsnorm", other, x)
    y = torch.empty_like(x)
    s = torch.empty_like(x) if prologue == "add" else None
    n_rows = x.numel() // d if d else 0
    if n_rows == 0:  # nothing to launch
        return s, y
    r_ptr, r_stride = (None, 0) if rows is None else (rows.data_ptr(), rows.stride(0))
    _, warps, per_lane = route(n_rows, d, x.dtype)
    lib = _build.library()
    rc = lib.rmsnorm_launch(code, PROLOGUES.index(prologue), warps or 0, per_lane or 0,
                            x.data_ptr(), r_ptr, r_stride, weight.data_ptr(),
                            None if s is None else s.data_ptr(), y.data_ptr(), n_rows, d,
                            float(eps), _build.stream_of(x))
    _build.check(rc, f"rmsnorm ({prologue})")
    LAUNCHES += 1
    LAUNCHES_BY_PROLOGUE[prologue] += 1
    return s, y


def rmsnorm_cuda(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``rmsnorm(x)`` on the CUDA kernel."""
    return _launch("none", x, None, weight, eps)[1]


def add_rmsnorm_cuda(x: torch.Tensor, r: torch.Tensor, weight: torch.Tensor,
                     eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(s, rmsnorm(s))`` with ``s = x + r`` on the CUDA kernel; ``r`` may
    be row-strided."""
    return _launch("add", x, r, weight, eps)


def mul_rmsnorm_cuda(a: torch.Tensor, u: torch.Tensor, weight: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """``rmsnorm(a * u)`` on the CUDA kernel; ``u`` may be row-strided."""
    return _launch("mul", a, u, weight, eps)[1]


def mul_silu_rmsnorm_cuda(y: torch.Tensor, z: torch.Tensor, weight: torch.Tensor,
                          eps: float = 1e-5) -> torch.Tensor:
    """``rmsnorm(y * silu(z))`` on the CUDA kernel; ``z`` may be
    row-strided."""
    return _launch("mul_silu", y, z, weight, eps)[1]


# ---- the split-row form ----------------------------------------------------

def mul_silu_partial_plain(y: torch.Tensor, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(p, sumsq)``: ``p = y * silu(z)`` (the unfused ops) and each row's
    f32 sum of squares of ``p`` [...]."""
    p = y * F.silu(z)
    pf = p.float()
    return p, (pf * pf).sum(-1)


def rmsnorm_scale_plain(p: torch.Tensor, sumsq: torch.Tensor, weight: torch.Tensor,
                        d_total: int, eps: float = 1e-5) -> torch.Tensor:
    """``p * rsqrt(sumsq / d_total + eps) * weight`` in f32, cast back to
    ``p``'s type: ``rmsnorm_plain`` with the mean over ``d_total`` channels,
    of which ``p`` holds a rank's."""
    y = p.float() * torch.rsqrt(sumsq[..., None] / d_total + eps)
    return (y * weight.float()).to(p.dtype)


def _count_split() -> None:
    global LAUNCHES
    LAUNCHES += 1
    LAUNCHES_BY_PROLOGUE[SPLIT] += 1


def mul_silu_partial_cuda(y: torch.Tensor, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 1 of the split-row form on the CUDA kernel: ``(p, sumsq)`` as
    ``mul_silu_partial_plain``; ``z`` may be row-strided."""
    _build.require_cuda("rmsnorm split", y)
    d = y.shape[-1]
    rows = _build.require_rows("rmsnorm split", z, y)
    p = torch.empty_like(y)
    sumsq = torch.empty(y.shape[:-1], dtype=torch.float32, device=y.device)
    n_rows = y.numel() // d if d else 0
    if n_rows == 0:
        return p, sumsq
    rc = _build.library().rmsnorm_partial_launch(
        _build.dtype_code(y), PROLOGUES.index("mul_silu"), y.data_ptr(), rows.data_ptr(),
        rows.stride(0), p.data_ptr(), sumsq.data_ptr(), n_rows, d, _build.stream_of(y))
    _build.check(rc, "rmsnorm split (partial)")
    _count_split()
    return p, sumsq


def rmsnorm_scale_cuda(p: torch.Tensor, sumsq: torch.Tensor, weight: torch.Tensor,
                       d_total: int, eps: float = 1e-5) -> torch.Tensor:
    """Pass 2 of the split-row form on the CUDA kernel, as
    ``rmsnorm_scale_plain``."""
    _build.require_cuda("rmsnorm split", p, sumsq, weight)
    d = p.shape[-1]
    if weight.shape != (d,) or weight.dtype != p.dtype:
        raise ValueError(f"rmsnorm split: weight {tuple(weight.shape)} {weight.dtype} does "
                         f"not match rows of {d} {p.dtype}")
    if sumsq.dtype != torch.float32 or sumsq.shape != p.shape[:-1]:
        raise ValueError(f"rmsnorm split: sums {tuple(sumsq.shape)} {sumsq.dtype} for rows "
                         f"{tuple(p.shape[:-1])}")
    y = torch.empty_like(p)
    n_rows = p.numel() // d if d else 0
    if n_rows == 0:
        return y
    rc = _build.library().rmsnorm_scale_launch(
        _build.dtype_code(p), p.data_ptr(), sumsq.data_ptr(), weight.data_ptr(), y.data_ptr(),
        n_rows, d, float(d_total), float(eps), _build.stream_of(p))
    _build.check(rc, "rmsnorm split (scale)")
    _count_split()
    return y
