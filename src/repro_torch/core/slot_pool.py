"""Unified KV slot-pool: the static cache as a pool of sequence slots —
``_PoolBase`` and ``SlotPool`` of ``repro/core/slot_pool.py``.

ONE cache of shape [slots, max_len, ...] is allocated on the pool's device
and never reallocated; each slot carries its own request and ``lengths``
counter and is evicted and refilled without touching its neighbours
(``kv_cache.write_slot`` / ``reset_slots`` update the pool in place). The
paged ``BlockPool`` waits for the next slice of the port.
"""
from __future__ import annotations

import heapq
from typing import Any, List, Optional

import torch

from repro_torch.core import kv_cache
from repro_torch.models.registry import Model


class _PoolBase:
    """Slot accounting: a min-heap free-list (acquire is lowest-index-first
    in O(log slots)) plus the occupancy / reservation metrics the scheduler
    reads. Subclasses own ``cache`` and the assign/evict storage logic."""

    def __init__(self, slots: int):
        if slots < 1:
            raise ValueError("pool needs at least one slot")
        self.slots = slots
        self._free: List[int] = list(range(slots))  # min-heap: pop -> lowest

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_active(self) -> int:
        return self.slots - len(self._free)

    @property
    def occupancy(self) -> float:
        """Fraction of slots doing real work this step (1 - idle share)."""
        return self.n_active / self.slots

    @property
    def reserved_bytes(self) -> int:
        """Bytes the pool holds allocated regardless of use."""
        return kv_cache.cache_bytes(self.cache)

    def acquire(self) -> Optional[int]:
        """Claim a free slot (lowest index first), or None if full."""
        return heapq.heappop(self._free) if self._free else None


class SlotPool(_PoolBase):
    """Fixed pool of ``slots`` sequence slots backed by one static cache on
    ``device``.

    Invariants:
    - a slot is either on the free-list or assigned to exactly one request;
    - the HOST free-list is the sole source of truth for slot liveness:
      ``evict`` zeroes a freed slot's ``lengths``, but the pool-wide decode
      step still increments every row's counter, so a free slot's device
      counter drifts upward until ``assign`` overwrites it;
    - ``assign`` replaces a slot's entire cache row (K/V buffers *and*
      length counter) with a freshly prefilled single-sequence row.
    """

    def __init__(self, model: Model, slots: int, max_len: int, device):
        super().__init__(slots)
        self.model = model
        self.max_len = max_len
        self.device = torch.device(device)
        self.cache: Any = model.init_cache(slots, max_len, self.device)

    def assign(self, slot: int, row_cache: Any, length: Optional[int] = None) -> None:
        """Install a prefilled single-sequence cache (leaves [1, ...]) into
        ``slot``. The row's ``lengths[0]`` becomes the slot's counter
        (``length`` is accepted for BlockPool signature parity)."""
        self.cache = kv_cache.write_slot(self.cache, row_cache, slot)

    def evict(self, slot: int) -> None:
        """Finish a slot: zero its length and return it to the free-list."""
        mask = torch.zeros((self.slots,), dtype=torch.bool)
        mask[slot] = True
        self.cache = kv_cache.reset_slots(self.cache, mask)
        heapq.heappush(self._free, slot)

    def reset(self) -> None:
        """Evict everything (serve-loop restart)."""
        self.cache = kv_cache.reset_slots(
            self.cache, torch.ones((self.slots,), dtype=torch.bool)
        )
        self._free = list(range(self.slots))
