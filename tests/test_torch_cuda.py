"""The port's CUDA kernels against their plain versions on the card.

This file imports no JAX (the card's machine has none); it runs there with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py`` and
skips itself on a host without CUDA. Tolerances as in test_torch_kernels.py:
f32 (TF32 off) atol 2e-5 / rtol 2e-4, bf16 atol = rtol = 2e-2."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rn

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-4), torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


def close(got, want, dtype):
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    before = (rn.LAUNCHES, fa.LAUNCHES, da.LAUNCHES)
    x, w = r(5, 2048), r(2048)
    close(ops.rmsnorm(x, w), rn.rmsnorm_plain(x, w), dtype)
    q, k, v = r(2, 67, 8, 64), r(2, 67, 2, 64), r(2, 67, 2, 64)
    close(ops.flash_attention(q, k, v, window=16),
          ops.flash_attention(q, k, v, window=16, impl="torch"), dtype)
    ln = torch.tensor([1, 67], dtype=torch.int32, device=dev)
    close(ops.decode_attention(q[:, 0], k, v, ln),
          ops.decode_attention(q[:, 0], k, v, ln, impl="torch"), dtype)
    torch.cuda.synchronize()
    # "auto" on CUDA tensors launched each kernel exactly once
    assert (rn.LAUNCHES, fa.LAUNCHES, da.LAUNCHES) == tuple(n + 1 for n in before)
