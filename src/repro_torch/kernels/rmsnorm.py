"""Fused RMSNorm: the CUDA kernel ``csrc/rmsnorm.cu`` and its plain version.

Replaces ``repro/kernels/rmsnorm.py::rmsnorm_pallas`` (``_rmsnorm_kernel``).
On the H100 it is bound by bytes: each element is read once and written
once for ~4 flops. The kernel runs one block per row of the flattened
``[N, d]`` view and keeps the f32 sum of squares in registers and shared
memory (see the source's note).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: launches of the CUDA kernel in this process (chip_smoke resets and reads it)
LAUNCHES = 0


def rmsnorm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The kernel's function in plain torch: f32 mean of squares, rsqrt,
    weight multiply in f32, cast back to ``x``'s type."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * weight.float()).to(x.dtype)


def rmsnorm_cuda(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream. Raises for
    anything the kernel does not take (CPU or non-contiguous tensors, mixed
    or unsupported types, a weight of the wrong width)."""
    global LAUNCHES
    _build.require_cuda("rmsnorm", x, weight)
    d = x.shape[-1]
    if weight.shape != (d,):
        raise ValueError(f"rmsnorm: weight {tuple(weight.shape)} does not match d={d}")
    if weight.dtype != x.dtype:
        raise TypeError(f"rmsnorm: weight {weight.dtype} differs from x {x.dtype}")
    code = _build.dtype_code(x)
    out = torch.empty_like(x)
    n_rows = x.numel() // d if d else 0
    lib = _build.library()
    rc = lib.rmsnorm_launch(code, x.data_ptr(), weight.data_ptr(), out.data_ptr(),
                            n_rows, d, float(eps), _build.stream_of(x))
    _build.check(rc, "rmsnorm")
    LAUNCHES += 1
    return out

