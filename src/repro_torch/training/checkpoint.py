"""Checkpointing: flat-key ``.npz`` snapshots of (params, optimizer state,
step) — the counterpart of ``repro/training/checkpoint.py``, in its format,
so that a file either package writes restores in the other.

Keys: ``params/<path>``, ``opt/step``, ``opt/mu/<path>``, ``opt/nu/<path>``
and ``__step__``, a path being the reference's (``layers/0/attn/wq/w``).
npz has no bfloat16: a bf16 leaf is stored as its uint16 bit pattern under
the key with ``__bf16__`` appended. The serving-only ``table_f32`` copy is
never written; a template that holds one gets it rebuilt from the restored
table.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.training.optimizer import path_str, tree_items, tree_map

_BF16 = "__bf16__"  # npz has no bfloat16: stored as uint16 bit pattern


def _to_numpy(t: torch.Tensor) -> Tuple[str, np.ndarray]:
    """(key suffix, array) of one leaf, bf16 as its bit pattern."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return _BF16, t.view(torch.int16).numpy().view(np.uint16)
    return "", t.numpy()


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    out = {}
    for path, leaf in tree_items(L.drop_f32_table(tree) if isinstance(tree, dict) else tree):
        suffix, arr = _to_numpy(leaf)
        out[path_str(path) + suffix] = arr
    return out


def save(path: str, params: Any, opt_state: Any = None, step: int = 0) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {f"params/{k}": v for k, v in _flatten(params).items()}
    if opt_state is not None:
        payload.update({f"opt/{k}": v for k, v in _flatten(opt_state).items()})
    payload["__step__"] = np.asarray(step)
    np.savez(path, **payload)


def _from_numpy(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if arr.dtype == np.uint16 and like.dtype == torch.bfloat16:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device=like.device, dtype=like.dtype)


def restore(path: str, params_like: Any, opt_like: Any = None) -> Tuple[Any, Any, int]:
    """Restore into the structure of (params_like, opt_like) templates, each
    leaf on its template's device in its template's dtype."""
    with np.load(path, allow_pickle=False) as z:
        data = {k: z[k] for k in z.files}
    step = int(data.pop("__step__"))

    def fill(template: Any, prefix: str) -> Any:
        def leaf(p, like):
            key = prefix + path_str(p)
            arr = data[key + _BF16] if key + _BF16 in data else data[key]
            if arr.shape != tuple(like.shape):
                raise ValueError(f"{key}: {arr.shape} != {tuple(like.shape)}")
            return _from_numpy(arr, like)
        return tree_map(leaf, template)

    tied = isinstance(params_like, dict) and "table_f32" in params_like.get("embed", {})
    params = fill(L.drop_f32_table(params_like) if isinstance(params_like, dict)
                  else params_like, "params/")
    if tied:
        with torch.no_grad():
            L.add_f32_table(params["embed"])
    opt = fill(opt_like, "opt/") if opt_like is not None else None
    return params, opt, step
