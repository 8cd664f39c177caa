"""KV-cache slot-pool row ops — the contiguous-pool part of
``repro/core/kv_cache.py``, as in-place index updates.

Every cache leaf's axis 0 is the sequence-slot axis. Where the reference
donates the pool to a jitted program so XLA updates its buffers in place,
the port writes into the pool's tensors directly: refilling or evicting a
slot never reallocates the pool.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import attention as A


def leaves(tree: Any):
    """The tensors of a nested dict/list tree, in insertion order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def cache_bytes(cache: Any) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(cache))


@torch.inference_mode()
def write_slot(pool: Any, row: Any, slot: int) -> Any:
    """Copy a single-sequence cache (leaves [1, ...]) into sequence slot
    ``slot`` of a pooled cache (leaves [B, ...]), in place: K/V buffers and
    the length counter of that slot only."""
    for p, r in zip(leaves(pool), leaves(row)):
        A.write_slot_row(p, r, slot)
    return pool


@torch.inference_mode()
def reset_slots(pool: Any, mask: torch.Tensor) -> Any:
    """Evict the slots marked in ``mask`` [B] by zeroing their ``lengths``
    in place (stale K/V beyond the counter is masked by the decode validity
    mask). Later pool-wide decode steps re-increment every row's counter,
    so a freed slot's counter drifts until it is re-assigned — liveness
    belongs to the SlotPool's host free-list, not this counter."""
    pool["lengths"].masked_fill_(mask.to(pool["lengths"].device), 0)
    return pool
