"""Bridge from the JAX package's params and caches to the port's.

The input is the reference's pytree with every leaf already a numpy array
(``jax.tree.map(np.asarray, model.init(key))``), so nothing here imports
JAX. Names and layouts are the same on both sides, so the bridge is a
rename: dicts and lists are rebuilt, leaves become tensors on ``device``.
A ``scanned`` block (``scan_layers``: every leaf with a leading [L] axis)
is unstacked into the ``layers`` list the port runs; bf16 leaves (numpy's
``ml_dtypes.bfloat16``) are reinterpreted bit for bit. Tied non-f32 tables
get the f32 unembed copy the port's own ``init`` adds.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def to_tensor(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def tree_to_torch(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_torch(v, device) for v in tree]
    return to_tensor(tree, device)


def _index(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _n_stacked(tree: Any) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return np.asarray(tree).shape[0]


def _unstack(tree: dict) -> dict:
    """Move a ``scanned`` block's leading [L] axis into the ``layers``
    list (after the unrolled prefix layers, as the reference runs them)."""
    if "scanned" not in tree:
        return tree
    tree = dict(tree)
    scanned = tree.pop("scanned")
    tree["layers"] = list(tree.get("layers", [])) + [
        _index(scanned, i) for i in range(_n_stacked(scanned))
    ]
    return tree


def params_to_torch(cfg: ModelConfig, np_params: dict, device) -> dict:
    """The reference's params (numpy leaves) as the port's params."""
    params = tree_to_torch(_unstack(np_params), device)
    if cfg.tie_embeddings:
        L.add_f32_table(params["embed"])
    return params


def cache_to_torch(np_cache: dict, device) -> dict:
    """The reference's contiguous cache (numpy leaves) as the port's."""
    return tree_to_torch(_unstack(np_cache), device)
