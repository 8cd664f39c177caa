"""Request-length profiles of the paper's workloads (Table 2): a copy of
``LengthProfile``, ``PAPER_PROFILES``, ``_sample_lognormal`` and
``sample_lengths`` from ``repro/training/data.py``, so that the port's
traces draw the same lengths as the JAX launcher for the same seed."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


@dataclass(frozen=True)
class LengthProfile:
    """(min, max, mean) input/output token lengths for one paper workload."""

    name: str
    in_min: int
    in_max: int
    in_mean: float
    out_min: int
    out_max: int
    out_mean: float


# Table 2 of the paper, verbatim.
PAPER_PROFILES: Dict[str, LengthProfile] = {
    "llama_humaneval": LengthProfile("llama_humaneval", 44, 430, 154, 55, 10_000, 692),
    "llama_mbpp": LengthProfile("llama_mbpp", 29, 1748, 59, 38, 10_000, 1076),
    "seamless_s2t": LengthProfile("seamless_s2t", 179, 1464, 493, 15, 98, 36),
    "seamless_t2s": LengthProfile("seamless_t2s", 12, 80, 31, 145, 1030, 393),
    "chameleon_it": LengthProfile("chameleon_it", 1030, 1030, 1030, 30, 30, 30),
    "chameleon_itt": LengthProfile("chameleon_itt", 1033, 1095, 1040, 10, 10, 10),
    "chameleon_ti": LengthProfile("chameleon_ti", 10, 22, 14, 1025, 1025, 1025),
    "hstu": LengthProfile("hstu", 4507, 5121, 4814, 4507, 5121, 4814),
}


def _sample_lognormal(rng, lo: int, hi: int, mean: float, n: int) -> np.ndarray:
    """Length sampler: lognormal clipped to [lo, hi] with target mean —
    matches the long-tailed output-length spread of Table 2."""
    mu = np.log(max(mean, 1.0))
    x = rng.lognormal(mean=mu, sigma=0.6, size=n)
    return np.clip(x, lo, hi).astype(np.int64)


def sample_lengths(
    profile: LengthProfile, n: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    ins = _sample_lognormal(rng, profile.in_min, profile.in_max, profile.in_mean, n)
    outs = _sample_lognormal(rng, profile.out_min, profile.out_max, profile.out_mean, n)
    return ins, outs
