"""Threefry-2x32 counter-based random numbers as ``jax.random`` computes them
(the default ``threefry2x32`` implementation with
``jax_threefry_partitionable`` on), in torch integer ops.

The serving scheduler samples every committed token under a key folded from
(request, stream, token index) — ``core/sampling.py`` — and the reference
derives those keys and the Gumbel noise of its categorical sampler from
``jax.random``. The port keeps its own copy of that arithmetic so the same
seed gives the same keys, bits and uniforms, bit for bit, on the CPU and on
the card.

A key is a tensor ``[..., 2]`` of two uint32 words held in int64 (CUDA's
uint32 coverage is thin): every sum and shift is masked back to 32 bits.
``fold_in`` also takes numpy keys, hashed on the host.
Counters follow the reference's partitionable layout: element ``i`` of a
``shape`` draw hashes the 64-bit counter ``i`` (row-major flat index) split
into its high and low words, and 32-bit draws keep ``bits1 ^ bits2``.

Not bit-exact: ``gumbel`` takes two ``log``s, which XLA and torch round apart
in the last bit now and then (within 2 ulp), so ``categorical`` can pick
another token only where two perturbed scores nearly tie.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
F32_TINY = torch.finfo(torch.float32).tiny


def _add(a, b):
    return (a + b) & MASK


def _rotl(x, r: int):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of the counter words (``x1``, ``x2``) under the
    key words (``k1``, ``k2``): 20 rounds, a key injection every four, as
    ``jax._src.prng._threefry2x32_lowering``. All four are int64 tensors of
    uint32 values that broadcast together, all four numpy int64 arrays, or
    all four Python ints."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [_add(x1, ks[0]), _add(x2, ks[1])]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = _add(x[0], x[1])
            x[1] = x[0] ^ _rotl(x[1], r)
        x[0] = _add(x[0], ks[(i + 1) % 3])
        x[1] = _add(x[1], ks[(i + 2) % 3] + (i + 1))
    return x[0], x[1]


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off: the seed is taken
    as a 32-bit integer, so the high word is 0 and the low word ``seed mod
    2**32``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64, device=device)


def _words(key):
    return key[..., 0], key[..., 1]


def fold_in(key, data):
    """``jax.random.fold_in``: the hash of the counter (0, ``data``) under
    ``key``. ``key`` [..., 2] and ``data`` (an int or an integer array, taken
    mod 2**32) broadcast: one new key per element. A numpy ``key`` is hashed
    on the host in numpy (the scheduler derives its per-slot keys so, with no
    device launch) and gives a numpy key; a tensor ``key`` gives a tensor."""
    k1, k2 = _words(key)
    if isinstance(key, np.ndarray):
        data = np.asarray(data, dtype=np.int64) & MASK
        y1, y2 = threefry2x32(k1, k2, np.zeros_like(data), data)
        return np.stack(np.broadcast_arrays(y1, y2), axis=-1)
    if not isinstance(data, torch.Tensor):  # a fill, not a host-to-device copy
        data = torch.full((), int(data), dtype=torch.int64, device=key.device)
    data = data.to(device=key.device, dtype=torch.int64) & MASK
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> [num, 2] on ``key``'s device: key
    ``i`` is the hash of the counter (0, i), taken in Python integers (the
    batch engines split their per-step key on the host: no device launch)."""
    k1, k2 = (int(v) for v in key.tolist())
    return torch.tensor([threefry2x32(k1, k2, 0, i) for i in range(num)],
                        dtype=torch.int64, device=key.device)


def bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element of ``shape`` (``jax.random.bits``), int64.
    ``key`` may carry leading batch dims [..., 2]: each key draws its own
    ``shape`` block, as ``vmap`` over keys does, giving [..., *shape]."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    k1, k2 = _words(key)
    k1 = k1.reshape(k1.shape + (1,) * len(shape))
    k2 = k2.reshape(k2.shape + (1,) * len(shape))
    y1, y2 = threefry2x32(k1, k2, idx >> 32, idx & MASK)
    return y1 ^ y2


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """f32 uniforms in [minval, maxval) (``jax.random.uniform``): the top 23
    bits as the mantissa of a float in [1, 2), minus 1, scaled by the f32
    width and shifted in one rounding (XLA fuses the two into an FMA; the
    f32 product is exact in f64), and held at ``minval`` or above."""
    mant = (bits(key, shape) >> 9) | 0x3F800000
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    scale = float(np.float32(maxval) - np.float32(lo))
    return torch.clamp((floats.double() * scale + lo).float(), min=lo)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Standard Gumbel noise in f32 (``jax.random.gumbel``, mode "low"):
    ``-log(-log(u))`` of uniforms in [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, shape, minval=F32_TINY, maxval=1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis by the
    Gumbel-max trick: one Gumbel draw of ``logits``' whole shape under
    ``key`` (moved to ``logits``' device), the argmax of noise plus logits
    (the first index on a tie)."""
    return torch.argmax(gumbel(key.to(logits.device), logits.shape) + logits, dim=-1)
