"""The kernel wrappers' launch counters, read and advanced as one.

Every CUDA wrapper adds one to its module's counter where it launches its
kernel (RMSNorm also by prologue and its split-row form, the int8 GEMMs by
mode). A launch recorded
into a CUDA graph runs again at every replay, but a replay runs no Python,
so whoever replays a graph adds the captured call's counts once a replay
(``add``): the counters then read what an eager run would have launched.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import hstu_attention as _ha
from repro_torch.kernels import int8_matmul as _im
from repro_torch.kernels import paged_decode_attention as _pda
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssd_scan as _ss


def _holders() -> Dict[str, Tuple[object, str]]:
    """Counter name -> (module or dict, key)."""
    return {"rmsnorm": (_rn, "LAUNCHES"),
            **{f"rmsnorm/{p}": (_rn.LAUNCHES_BY_PROLOGUE, p) for p in _rn.LAUNCHES_BY_PROLOGUE},
            "flash_attention": (_fa, "LAUNCHES"),
            "decode_attention": (_da, "LAUNCHES"),
            "decode_attention_partial": (_da, "LAUNCHES_PARTIAL"),
            "combine_partial_attention": (_da, "LAUNCHES_MERGE"),
            "paged_decode_attention": (_pda, "LAUNCHES"),
            "int8_matmul_weight_only": (_im, "LAUNCHES_WO"),
            "int8_matmul_dynamic": (_im, "LAUNCHES_DYN"),
            "hstu_attention": (_ha, "LAUNCHES"), "ssd_scan": (_ss, "LAUNCHES")}


def snapshot() -> Dict[str, int]:
    """Every counter's value now."""
    return {name: holder[key] if isinstance(holder, dict) else getattr(holder, key)
            for name, (holder, key) in _holders().items()}


def restore(values: Dict[str, int]) -> None:
    """Set every counter to ``values`` (a ``snapshot``)."""
    for name, (holder, key) in _holders().items():
        if isinstance(holder, dict):
            holder[key] = values[name]
        else:
            setattr(holder, key, values[name])


def since(before: Dict[str, int]) -> Dict[str, int]:
    """Launches of each kernel since ``before`` (a ``snapshot``)."""
    now = snapshot()
    return {name: now[name] - before[name] for name in now}


def add(delta: Dict[str, int], times: int = 1) -> None:
    """Advance every counter by ``times`` x its entry in ``delta``."""
    now = snapshot()
    restore({name: now[name] + times * delta.get(name, 0) for name in now})
