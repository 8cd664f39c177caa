"""Int8 GEMMs of AutoQuant (paper §4.2): the CUDA kernels
``csrc/int8_matmul.cu`` and their plain versions.

Replaces ``repro/kernels/int8_matmul.py``:

- ``int8_matmul_weight_only_*`` — ``int8_matmul_pallas`` (``_wo_kernel``):
  ``x[..., K]`` (bf16/f32) @ ``w_q[K, N]`` int8, f32 accumulation,
  ``* w_scale[N]`` in the epilogue, out ``x.dtype``. On the H100 it is
  bound by bytes at decode (M = 8 rows): the int8 weights are half the
  bf16 bytes. bf16 x runs on the tensor cores (``mma.sync`` bf16, the int8
  tile dequantized exactly to bf16 in shared memory), with 64-row tiles
  above ``WO_SMALL_M`` rows and 16-row tiles at or below; f32 x runs the
  CUDA-core template (:func:`wo_tile_m`, :func:`plan_weight_only`). The C
  entry takes the same route from x's type and M.
- ``int8_matmul_dynamic_*`` — ``int8_matmul_dynamic_pallas``
  (``_dyn_kernel``): ``x_q[..., K]`` int8 @ ``w_q[K, N]`` int8 with an
  exact int32 accumulator, then ``acc * x_scale[m] * w_scale[n]`` in f32,
  out f32, bit for bit as its plain version, on the tensor cores
  (``mma.sync`` s8). The per-row activation quantization stays outside,
  in ``ops.int8_matmul_dynamic``.

Both kernels predicate their edges instead of padding M, N and K up to
tile multiples as the Pallas kernels do, and split K over blocks where the
output tiles alone cannot fill the card (see the source's note).

The dynamic kernel has no small-M rule: every M, decode (M = 8) and
prefill (M = 256) alike, runs the ``mma.sync`` s8 tensor-core kernel, which
measured faster than the CUDA-core template at decode too (the source's
note); :func:`split_k_dynamic` is its K split, and
:func:`split_k_weight_only` the weight-only kernel's.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import int_matmul_exact

#: launches of each CUDA kernel in this process (chip_smoke resets and reads them)
LAUNCHES_WO = 0
LAUNCHES_DYN = 0

# the CUDA-core template's tile (csrc/int8_matmul.cu): 8 rows x 128
# columns, K in 128-row steps
_BM, _BN, _BK = 8, 128, 128
# the tensor-core kernels' tiles: 64 (or, weight-only at small M, 16) rows
# x 128 columns, K in stages of 64 (bytes for the dynamic kernel, bf16
# elements for the weight-only one)
_TC_BM, _TC_BN, _TC_BK = 64, 128, 64
#: least K per split of the tensor-core kernels (4 pipeline stages)
_TC_MIN_CHUNK = 4 * _TC_BK
#: bf16 x with at most this many rows runs the 16-row tensor-core tile
#: (``kWoSmallM`` of csrc/int8_matmul.cu, which routes the launch)
WO_SMALL_M = 16


def split_k(m: int, n: int, k: int, n_sms: int) -> Tuple[int, int]:
    """(splits, k_chunk) of K over blocks for the CUDA-core template
    (weight-only): enough splits for the M x N tiles to reach two blocks per SM, each
    chunk a whole number of 128-row steps, no split empty."""
    tiles = math.ceil(n / _BN) * math.ceil(m / _BM)
    splits = max(1, min(math.ceil(2 * n_sms / max(tiles, 1)), math.ceil(k / _BK)))
    k_chunk = max(1, math.ceil(math.ceil(k / splits) / _BK)) * _BK
    return max(1, math.ceil(k / k_chunk)), k_chunk


def _split_k_tc(m: int, n: int, k: int, blocks: int, tile_m: int,
                min_chunk: int = _TC_MIN_CHUNK) -> Tuple[int, int]:
    """(splits, k_chunk) of K over blocks for a tensor-core kernel with
    ``tile_m`` x 128 output tiles: split only while the tiles are fewer
    than ``blocks``, each split at least ``min_chunk`` of K and a whole
    number of 64-deep stages, no split empty."""
    tiles = math.ceil(n / _TC_BN) * math.ceil(m / tile_m)
    splits = max(1, min(math.ceil(blocks / max(tiles, 1)), k // min_chunk))
    k_chunk = max(1, math.ceil(math.ceil(k / splits) / _TC_BK)) * _TC_BK
    return max(1, math.ceil(k / k_chunk)), k_chunk


def split_k_dynamic(m: int, n: int, k: int, n_sms: int) -> Tuple[int, int]:
    """(splits, k_chunk) of K over blocks for the dynamic tensor-core
    kernel (64 x 128 tiles, 64-byte stages)."""
    return _split_k_tc(m, n, k, n_sms, _TC_BM)


def wo_tile_m(m: int, dtype: torch.dtype) -> int:
    """The weight-only route by M and x's type: f32 x runs the CUDA-core
    template (8-row tiles; TF32 would miss the f32 tolerance), bf16 x the
    tensor-core kernel, with 16-row tiles up to ``WO_SMALL_M`` rows (faster
    than the CUDA-core template at all four decode shapes on the H100,
    ``PERF.md``) and 64-row tiles above."""
    if dtype != torch.bfloat16:
        return 8
    return 16 if m <= WO_SMALL_M else 64


def split_k_weight_only(m: int, n: int, k: int, n_sms: int,
                        tile_m: int) -> Tuple[int, int]:
    """(splits, k_chunk) of K over blocks for the weight-only kernel of
    ``tile_m`` rows: the CUDA-core template's plan (:func:`split_k`) for 8;
    for 64, split while the 64 x 128 tiles are fewer than the SMs, as the
    dynamic kernel; for 16 (small M, bound by the weight bytes in flight),
    split while the tiles are fewer than two blocks per SM, down to chunks
    of two 64-element stages."""
    if tile_m == 8:
        return split_k(m, n, k, n_sms)
    if tile_m == 16:
        return _split_k_tc(m, n, k, 2 * n_sms, tile_m, 2 * _TC_BK)
    return _split_k_tc(m, n, k, n_sms, tile_m)


@functools.lru_cache(maxsize=None)
def plan_weight_only(m: int, n: int, k: int, dtype: torch.dtype,
                     n_sms: int) -> Tuple[int, int, int]:
    """(tile_m, splits, k_chunk) the weight-only wrapper launches with: the
    route of :func:`wo_tile_m` and its K split."""
    tile_m = wo_tile_m(m, dtype)
    return (tile_m, *split_k_weight_only(m, n, k, n_sms, tile_m))


def _workspace(splits: int, m: int, n: int, dtype, device) -> Optional[torch.Tensor]:
    """When K is split, the partial-tile workspace [splits, M, N] the
    kernel sums in its second pass."""
    return torch.empty((splits, m, n), dtype=dtype, device=device) if splits > 1 else None


def int8_matmul_weight_only_plain(x: torch.Tensor, w_q: torch.Tensor,
                                  w_scale: torch.Tensor) -> torch.Tensor:
    """``_wo_kernel`` in plain torch: x and w as f32, an f32 dot, then
    ``* w_scale`` in the epilogue, then the cast to ``x.dtype``."""
    acc = x.float() @ w_q.float()
    return (acc * w_scale.float()).to(x.dtype)


def int8_matmul_dynamic_plain(x_q: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                              x_scale: torch.Tensor) -> torch.Tensor:
    """``_dyn_kernel`` in plain torch: an exact int32 accumulator, then
    ``acc * x_scale * w_scale`` in f32 (in that order), out f32."""
    k, n = w_q.shape
    acc = int_matmul_exact(x_q.reshape(-1, k), w_q).reshape(*x_q.shape[:-1], n)
    return acc.float() * x_scale.float() * w_scale.float()


def _check_weights(name: str, k: int, w_q: torch.Tensor, w_scale: torch.Tensor) -> int:
    if w_q.dtype != torch.int8 or w_q.ndim != 2 or w_q.shape[0] != k:
        raise ValueError(f"{name}: w_q must be int8 [K={k}, N], got {w_q.dtype} "
                         f"{tuple(w_q.shape)}")
    n = w_q.shape[1]
    if w_scale.dtype != torch.float32 or w_scale.shape != (n,):
        raise ValueError(f"{name}: w_scale must be float32 [{n}], got {w_scale.dtype} "
                         f"{tuple(w_scale.shape)}")
    return n


def int8_matmul_weight_only_cuda(x: torch.Tensor, w_q: torch.Tensor,
                                 w_scale: torch.Tensor) -> torch.Tensor:
    """Launch the weight-only kernel on PyTorch's current stream: bf16 x on
    the tensor cores, f32 x on the CUDA-core template (:func:`wo_tile_m`).
    Raises for anything the kernel does not take (CPU or non-contiguous
    tensors, an x that is not f32/bf16, int8 weights of the wrong shape,
    scales that are not f32 [N])."""
    global LAUNCHES_WO
    name = "int8_matmul_weight_only"
    _build.require_cuda(name, x, w_q, w_scale)
    code = _build.dtype_code(x)
    k = x.shape[-1]
    n = _check_weights(name, k, w_q, w_scale)
    out = torch.empty((*x.shape[:-1], n), dtype=x.dtype, device=x.device)
    m = math.prod(x.shape[:-1])
    _, splits, k_chunk = plan_weight_only(m, n, k, x.dtype, _build.n_sms(x.device.index))
    part = _workspace(splits, m, n, torch.float32, x.device)
    lib = _build.library()
    rc = lib.int8_matmul_wo_launch(code, x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
                                   out.data_ptr(), None if part is None else part.data_ptr(),
                                   m, n, k, splits, k_chunk, _build.stream_of(x))
    _build.check(rc, name)
    LAUNCHES_WO += 1
    return out


def int8_matmul_dynamic_cuda(x_q: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                             x_scale: torch.Tensor) -> torch.Tensor:
    """Launch the dynamic int8 x int8 tensor-core kernel on PyTorch's
    current stream. Raises for anything the kernel does not take (CPU or
    non-contiguous tensors, activations that are not int8, weights or
    scales of the wrong type or shape)."""
    global LAUNCHES_DYN
    name = "int8_matmul_dynamic"
    _build.require_cuda(name, x_q, w_q, w_scale, x_scale)
    if x_q.dtype != torch.int8:
        raise ValueError(f"{name}: x_q must be int8, got {x_q.dtype}")
    k = x_q.shape[-1]
    n = _check_weights(name, k, w_q, w_scale)
    m = math.prod(x_q.shape[:-1])
    if x_scale.dtype != torch.float32 or x_scale.numel() != m:
        raise ValueError(f"{name}: x_scale must be float32 with {m} rows, got "
                         f"{x_scale.dtype} {tuple(x_scale.shape)}")
    out = torch.empty((*x_q.shape[:-1], n), dtype=torch.float32, device=x_q.device)
    splits, k_chunk = split_k_dynamic(m, n, k, _build.n_sms(x_q.device.index))
    part = _workspace(splits, m, n, torch.int32, x_q.device)
    rc = _build.library().int8_matmul_dyn_launch(
        x_q.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), x_scale.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(), m, n, k, splits, k_chunk,
        _build.stream_of(x_q))
    _build.check(rc, name)
    LAUNCHES_DYN += 1
    return out
