"""Unified KV slot-pool: the static cache as a pool of sequence slots —
``_PoolBase``, ``SlotPool`` and ``BlockPool`` of ``repro/core/slot_pool.py``.

``SlotPool``: ONE cache of shape [slots, max_len, ...] is allocated on the
pool's device and never reallocated; each slot carries its own request and
``lengths`` counter and is evicted and refilled without touching its
neighbours (``kv_cache.write_slot`` / ``reset_slots`` update the pool in
place).

``BlockPool`` is the paged variant: the same slot free-list, but K/V lives
in a shared pool of fixed-size physical blocks addressed through per-slot
block tables, so a slot holds only the blocks its tokens occupy (see
``core/kv_cache.py``). Its host state (free-lists, tables, refcounts) is
numpy, as in the reference; the device side is in-place writes into the
pool's preallocated tensors. Blocks are refcounted: a slot group's streams
share their common prefix (``share``, ``permute_group``: beam's KV reorder
as a table rewrite) and the block a stream writes next is unshared
copy-on-write (``ensure_writable``, one ``kv_cache.copy_block``); the
cross-request prefix cache (``core/prefix_cache.py``) holds blocks of its
own (``cache_ref`` / ``cache_unref``) that admissions ``adopt``.
``truncate`` releases the table suffix a rejected speculative window leaves
behind.

A tensor-parallel rank builds its pool from its rank-local model
(``distributed/tp_pool.py``): the K/V tensors hold the rank's KV heads
(``sharding.cache_specs_tp``'s head split; an encoder-decoder's self and
cross K/V alike), an MLA pool the whole latent (which the reference
replicates), a Mamba-2 pool its heads' state and its conv tail's
channels, a hybrid pool its RG-LRU channels' state and conv tail and its
rows of each ring split along the sequence (the whole ring where its rows
do not divide the ranks), while the host state, the block tables and
``lengths`` are whole and the same on every rank. Admission, write-back
and release walk the rank's own tree, so they touch only its share.
"""
from __future__ import annotations

import heapq
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.analysis.hotpath import hot_path
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
        """Finish a slot: zero its length (a fill on the device, no copy
        from the host) and return it to the free-list."""
        self.cache = kv_cache.set_slot_length(self.cache, slot, 0)
        heapq.heappush(self._free, slot)

    @hot_path
    def sync(self, stage=None) -> None:
        """No host-side tables to flush (BlockPool signature parity)."""

    def truncate(self, slot: int, kv_len: int) -> None:
        """Nothing to release: a contiguous slot reserves its whole row, so a
        speculative rewind is the pool-wide ``lengths`` rewind alone
        (BlockPool signature parity)."""

    def reset(self) -> None:
        """Evict everything (serve-loop restart)."""
        self.cache = kv_cache.reset_slots(
            self.cache, torch.ones((self.slots,), dtype=torch.bool)
        )
        self._free = list(range(self.slots))


class BlockPool(_PoolBase):
    """Paged KV pool: ``slots`` sequence slots over ``num_blocks`` shared
    physical blocks of ``block_size`` tokens each, on ``device``.

    Storage is ONE ``[num_blocks, block_size, ...]`` K/V allocation per
    layer; a slot's logical positions map to physical blocks through its
    row of the host block table, shipped to the device by ``sync``.
    Invariants (as the reference's):

    - physical block 0 is the garbage sink: never on the free-list, never
      in a live slot's table; freed slots' zeroed table rows route their
      pool-wide decode writes into it;
    - every block in 1..num_blocks-1 is free (on the free-list, refcount 0)
      or held, its refcount the number of owning slots plus one while the
      prefix cache holds it (``_cached``); a cached block of refcount 1 is
      cached-only, the overflow the prefix cache's reclaim frees;
    - a block is written only while its refcount is 1: the block under a
      group stream's write cursor is unshared by ``ensure_writable``, and
      shared full prefix blocks are never written again;
    - both free-lists are min-heaps: acquire order stays lowest-first;
    - ``num_blocks - 1 >= max_blocks``: one worst-case request always
      fits, so the scheduler's preemption ladder terminates (an S-stream
      group: the scheduler asks S x max_blocks at submit).
    """

    def __init__(self, model: Model, slots: int, max_len: int, device, *,
                 block_size: int = 16, num_blocks: Optional[int] = None):
        super().__init__(slots)
        if block_size < 1 or block_size > max_len:
            raise ValueError("need 1 <= block_size <= max_len")
        cfg = model.config
        if getattr(cfg, "sliding_window", None):
            raise NotImplementedError("paged pool unsupported on ring/window caches")
        if getattr(cfg, "scan_layers", False):
            raise NotImplementedError("paged pool unsupported with scan_layers")
        if getattr(cfg, "encdec", None) is not None:
            # per-slot cross-attention rows (encoder frames) have no block
            # layout: enc-dec requests serve through the contiguous SlotPool
            raise NotImplementedError(
                "paged pool unsupported for enc-dec cross-attention caches"
            )
        if cfg.family not in ("dense", "moe", "mla_moe", "vlm"):
            raise NotImplementedError(
                f"family {cfg.family!r}: the paged pool holds attention K/V or MLA latents only"
            )
        self.model = model
        self.max_len = max_len
        self.device = torch.device(device)
        self.block_size = block_size
        self.max_blocks = -(-max_len // block_size)  # ceil: worst case / slot
        if num_blocks is None:
            # parity default: every slot can hold a worst-case request
            num_blocks = slots * self.max_blocks + 1
        if num_blocks - 1 < self.max_blocks:
            raise ValueError(
                f"num_blocks={num_blocks} cannot fit one worst-case request "
                f"({self.max_blocks} blocks + sink block 0)"
            )
        self.num_blocks = num_blocks

        cache = model.init_cache(num_blocks, block_size, self.device)
        cache["lengths"] = torch.zeros((slots,), dtype=torch.int32,
                                       device=self.device)  # per SLOT, not block
        self.block_tables = np.zeros((slots, self.max_blocks), np.int32)
        cache["block_tables"] = torch.zeros((slots, self.max_blocks), dtype=torch.int32,
                                            device=self.device)
        self.cache: Any = cache

        self._free_blocks: List[int] = list(range(1, num_blocks))  # heap; 0 = sink
        self._owned: List[List[int]] = [[] for _ in range(slots)]
        self._ref = np.zeros((num_blocks,), np.int32)  # holders per block
        # True while the prefix cache holds the block: one reference more
        # than its owning slots, so evictions never free it under the trie
        self._cached = np.zeros((num_blocks,), bool)
        self._bt_dirty = False
        self.n_cow_copies = 0  # copy-on-write unshares (one block copy each)

    # ---- block accounting ------------------------------------------------
    @property
    def n_free_blocks(self) -> int:
        return len(self._free_blocks)

    @property
    def n_used_blocks(self) -> int:
        return (self.num_blocks - 1) - len(self._free_blocks)

    @property
    def block_occupancy(self) -> float:
        """Fraction of allocatable blocks currently owned by a slot."""
        return self.n_used_blocks / max(self.num_blocks - 1, 1)

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` cached tokens."""
        return max(1, -(-n_tokens // self.block_size))

    def owned_blocks(self, slot: int) -> List[int]:
        return list(self._owned[slot])

    @property
    def n_cached_blocks(self) -> int:
        """Blocks the prefix cache holds (owned by slots too, or not)."""
        return int(self._cached.sum())

    @property
    def n_reclaimable_blocks(self) -> int:
        """Cached blocks no slot owns (refcount 1, the cache's own): what
        the prefix cache's reclaim can return to the free-list, which the
        admission gate counts as free."""
        return int((self._cached & (self._ref == 1)).sum())

    def _take_block(self, slot: int) -> int:
        """Pop the lowest free block into ``slot``'s next table entry."""
        phys = heapq.heappop(self._free_blocks)
        self._ref[phys] = 1
        self.block_tables[slot, len(self._owned[slot])] = phys
        self._owned[slot].append(phys)
        self._bt_dirty = True
        return phys

    def _drop_ref(self, phys: int) -> None:
        self._ref[phys] -= 1
        if self._ref[phys] == 0:
            heapq.heappush(self._free_blocks, phys)

    # ---- slot lifecycle --------------------------------------------------
    def assign(self, slot: int, row_cache: Any, length: int) -> None:
        """Admit a prefilled dense row (leaves [1, S_row, ...]) into
        ``slot``: take blocks for its ``length`` prompt tokens and copy them
        block by block (``kv_cache.append_block``), then set its counter."""
        need = self.blocks_for(length)
        if need > self.max_blocks:
            raise ValueError(f"prompt of {length} tokens exceeds max_len")
        if need > len(self._free_blocks):
            raise RuntimeError("out of KV blocks (admission must gate on n_free_blocks)")
        assert not self._owned[slot], "assign into a slot that still owns blocks"
        for j in range(need):
            kv_cache.append_block(self.cache["layers"], row_cache["layers"],
                                  self._take_block(slot), j * self.block_size)
        kv_cache.set_slot_length(self.cache, slot, length)

    def ensure(self, slot: int, kv_len: int) -> bool:
        """Grow ``slot`` until it owns the block its next write (logical
        position ``kv_len``) lands in. Host-only: a growth block becomes
        readable one position at a time as the validity mask advances.
        Returns False when the pool is out of blocks."""
        needed = kv_len // self.block_size + 1
        while len(self._owned[slot]) < needed:
            if not self._free_blocks:
                return False
            self._take_block(slot)
        return True

    def ensure_writable(self, slot: int, kv_len: int) -> bool:
        """``ensure``, and the block the next write lands in (logical
        position ``kv_len``) owned by ``slot`` alone: a block a sibling
        stream shares is replaced by a fresh one holding a copy
        (``kv_cache.copy_block``), so the pool-wide write cannot reach the
        sibling. The shared blocks before the write cursor stay shared.
        Returns False when the pool is out of blocks."""
        if not self.ensure(slot, kv_len):
            return False
        j = kv_len // self.block_size
        phys = int(self._owned[slot][j])
        if self._ref[phys] <= 1:
            return True
        if not self._free_blocks:
            return False
        fresh = heapq.heappop(self._free_blocks)
        self._ref[fresh] = 1
        self._ref[phys] -= 1
        self._owned[slot][j] = fresh
        self.block_tables[slot, j] = fresh
        self._bt_dirty = True
        kv_cache.copy_block(self.cache["layers"], phys, fresh)
        self.n_cow_copies += 1
        return True

    # ---- block sharing: slot groups and the prefix cache -----------------
    def share(self, dst: int, src: int) -> None:
        """Admit ``dst`` as a copy-free clone of ``src``: the same table, a
        reference more on every block (a prefix-shared group's streams
        prefill once). ``dst`` must own no block; its device counter is
        copied from ``src``'s."""
        assert not self._owned[dst], "share into a slot that still owns blocks"
        self._owned[dst] = list(self._owned[src])
        for phys in self._owned[dst]:
            self._ref[phys] += 1
        self.block_tables[dst, :] = self.block_tables[src, :]
        self._bt_dirty = True
        kv_cache.set_slot_length(self.cache, dst, self.cache["lengths"][src])

    def permute_group(self, slots: List[int], parent: np.ndarray) -> None:
        """Beam's KV reorder as a host table rewrite: stream ``i`` (slot
        ``slots[i]``) continues from stream ``parent[i]``'s cache by sharing
        its blocks; blocks no stream keeps return to the free-list. No
        device K/V moves; the next write's block is unshared by
        ``ensure_writable``."""
        old = [self._owned[s] for s in slots]
        # references first: a block dropped and re-taken never passes
        # through the free-list
        for i in range(len(slots)):
            for phys in old[int(parent[i])]:
                self._ref[phys] += 1
        for blks in old:
            for phys in blks:
                self._drop_ref(phys)
        for i, s in enumerate(slots):
            src = old[int(parent[i])]
            self._owned[s] = list(src)
            self.block_tables[s, :] = 0
            self.block_tables[s, : len(src)] = src
        self._bt_dirty = True

    def adopt(self, slot: int, blocks: List[int], n_tokens: int) -> None:
        """A prefix-cache hit at admission: attach the trie's matched full
        prompt blocks (in logical order) to empty ``slot``'s table by
        refcounted sharing, and pin its device counter to ``n_tokens`` (=
        ``len(blocks) * block_size``) at once, so a decode step that runs
        before the suffix's first chunk writes past the adopted span, never
        into a shared block. The slot never writes its adopted blocks: its
        prefill resumes at the first uncached token."""
        assert not self._owned[slot], "adopt into a slot that still owns blocks"
        assert n_tokens == len(blocks) * self.block_size
        for j, phys in enumerate(blocks):
            assert self._cached[phys], "adopting a block the cache dropped"
            self._ref[phys] += 1
            self._owned[slot].append(phys)
            self.block_tables[slot, j] = phys
        self._bt_dirty = True
        kv_cache.set_slot_length(self.cache, slot, n_tokens)

    def cache_ref(self, phys: int) -> None:
        """The prefix cache takes its own reference on a block a finishing
        slot still owns, before that slot's eviction drops its own: the
        block goes from owned to cached without visiting the free-list."""
        assert self._ref[phys] >= 1, "cache_ref on an unowned block"
        assert not self._cached[phys], "block already cached"
        self._cached[phys] = True
        self._ref[phys] += 1

    def cache_unref(self, phys: int) -> None:
        """Drop the prefix cache's reference (reclaim, reset): the block is
        free again once no slot owns it."""
        assert self._cached[phys], "cache_unref on an uncached block"
        self._cached[phys] = False
        self._drop_ref(phys)

    def is_sole_cached_ref(self, phys: int) -> bool:
        """True while the prefix cache is the block's only holder."""
        return bool(self._cached[phys]) and self._ref[phys] == 1

    def evict(self, slot: int) -> None:
        """Finish (or preempt) a slot: one reference dropped per owned
        block, the table row zeroed (its later garbage writes hit the sink
        block), the slot back on the free-list, its device counter zeroed."""
        for phys in self._owned[slot]:
            self._drop_ref(phys)
        self._owned[slot] = []
        self.block_tables[slot, :] = 0
        self._bt_dirty = True
        heapq.heappush(self._free, slot)
        kv_cache.set_slot_length(self.cache, slot, 0)  # a fill, no copy from the host

    def truncate(self, slot: int, kv_len: int) -> None:
        """Release the table suffix a rejected speculative window leaves
        behind: keep the blocks through the one logical position ``kv_len``
        (the slot's next write) lands in, as ``ensure`` counts them, and
        return the rest to the free-list, their table entries pointed back
        at the sink block. Host-only: the stale K/V in dropped and kept
        blocks lies past the validity window until rewritten. A block a
        sibling stream still owns only loses a reference."""
        keep = kv_len // self.block_size + 1
        owned = self._owned[slot]
        while len(owned) > keep:
            phys = owned.pop()
            self.block_tables[slot, len(owned)] = 0
            self._drop_ref(phys)
            self._bt_dirty = True

    @hot_path
    @torch.inference_mode()
    def sync(self, stage=None) -> None:
        """Copy the host block table into the device table in place, if it
        changed since the last sync. Without ``stage`` the copy is
        synchronous. A scheduler's step passes its staging buffers
        (``scheduler._Staging``): the table is copied into a pinned host
        buffer at once, so the host may edit its table as soon as this
        returns, and from there to the device without blocking the host;
        that buffer is written again only after the step's finish."""
        if not self._bt_dirty:
            return
        if stage is None:
            self.cache["block_tables"].copy_(torch.from_numpy(self.block_tables))
        else:
            self.cache["block_tables"].copy_(stage.host("block_tables", self.block_tables),
                                             non_blocking=True)
        self._bt_dirty = False

    def reset(self) -> None:
        for slot in range(self.slots):
            self._owned[slot] = []
        self.block_tables[:, :] = 0
        self._free = list(range(self.slots))
        self._free_blocks = list(range(1, self.num_blocks))
        self._ref[:] = 0
        self._cached[:] = False  # a PrefixCache over this pool is reset with it
        self._bt_dirty = True
        kv_cache.reset_slots(self.cache, torch.ones((self.slots,), dtype=torch.bool))
        self.sync()
