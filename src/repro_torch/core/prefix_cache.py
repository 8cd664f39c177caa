"""Cross-request radix prefix cache over paged KV blocks — a copy of
``repro/core/prefix_cache.py`` (host state only: dicts and numpy, no torch).

A trie node per FULL block of prompt tokens: node ``d`` is keyed by the raw
bytes of the prompt's span ``[d * block_size, (d + 1) * block_size)`` under
its ancestors, and holds the physical block of that span's K/V. The same
span under the same ancestors was computed over the same token prefix, so a
hit is the cold prefill's K/V.

- **match** (admission): walk the prompt's spans, capped at
  ``(n_prompt - 1) // block_size`` blocks so at least one suffix token is
  left to prefill (the first sampled token's logits come off a fresh last
  position). The scheduler adopts the matched blocks
  (``BlockPool.adopt``) and starts the chunk cursor at the first uncached
  token; the hit request never writes the blocks it adopted.
- **insert** (finish, preemption): a sequence's full prompt blocks are
  handed to the trie instead of freed: each new node takes the cache's own
  pool reference (``BlockPool.cache_ref``) before the slot's reference
  drops. A span already cached keeps its incumbent block, so a replay
  re-inserting the blocks it adopted is a no-op.
- **reclaim** (back-pressure): cached blocks no slot reads are freed
  least-recently-used, leaf first. A slot that adopted a node holds its
  whole root path, so every ancestor of a read node has refcount >= 2 and
  the loop ends when no reclaimable leaf is left. The scheduler reclaims
  before it preempts.

The trie allocates no device memory: the prefix cache changes reserved KV
bytes by zero.
"""
from __future__ import annotations

import heapq
from typing import Dict, List

import numpy as np


class _Node:
    """One cached full block: ``phys`` holds the K/V of the prompt span
    ``key`` (the span's raw token bytes) under this node's ancestor
    chain. ``last_use`` is a monotonic trie-wide counter (not a clock):
    touched root-to-leaf on every match/insert, compared only for LRU
    ordering."""

    __slots__ = ("key", "phys", "parent", "children", "last_use")

    def __init__(self, key: bytes, phys: int, parent: "_Node"):
        self.key = key
        self.phys = phys
        self.parent = parent
        self.children: Dict[bytes, "_Node"] = {}
        self.last_use = 0


class PrefixCache:
    """Radix/trie prefix cache mapping full-block prompt spans to the
    physical KV blocks holding them (host state only; the blocks live in
    the ``BlockPool``'s device allocation and are refcount-shared)."""

    def __init__(self, block_size: int):
        if block_size < 1:
            raise ValueError("need block_size >= 1")
        self.block_size = block_size
        self.root = _Node(b"", -1, None)  # sentinel; never holds a block
        self._clock = 0  # monotonic LRU counter
        # counters (the scheduler aggregates them into serve metrics)
        self.n_inserted_blocks = 0
        self.n_reclaimed_blocks = 0

    def __len__(self) -> int:
        """Number of cached blocks (= trie nodes below the root)."""
        n, stack = 0, [self.root]
        while stack:
            node = stack.pop()
            n += len(node.children)
            stack.extend(node.children.values())
        return n

    def _spans(self, prompt: np.ndarray, n_blocks: int) -> List[bytes]:
        """The prompt's first ``n_blocks`` full-block spans as trie keys.
        Keys are the spans' raw little-endian int32 bytes — exact, cheap
        to hash, and free of per-token host casts."""
        bs = self.block_size
        flat = np.ascontiguousarray(prompt, np.int32)
        return [flat[d * bs:(d + 1) * bs].tobytes() for d in range(n_blocks)]

    def match(self, prompt: np.ndarray) -> List[int]:
        """Longest-cached-prefix walk: physical block ids for the leading
        full-block spans of ``prompt`` found in the trie, stopping at the
        first miss. Capped at ``(len(prompt) - 1) // block_size`` blocks
        so >= 1 suffix token is always left for prefill (the first
        sampled token must come off a freshly computed last position,
        exactly as cold serving would produce it). Touches the matched
        chain's LRU stamps root-to-leaf."""
        cap = (len(prompt) - 1) // self.block_size
        if cap <= 0:
            return []
        self._clock += 1
        node, hit = self.root, []
        for key in self._spans(prompt, cap):
            child = node.children.get(key)
            if child is None:
                break
            child.last_use = self._clock
            hit.append(child.phys)
            node = child
        return hit

    def insert(self, prompt: np.ndarray, blocks: List[int], pool) -> int:
        """Hand a finished (or preempted) sequence's full prompt blocks
        over to the trie: ``blocks[d]`` holds the K/V of the prompt's
        span ``d``, and ``prompt`` must cover ``len(blocks)`` full
        blocks. A newly cached block gains the cache's own pool reference
        (``pool.cache_ref``) — call BEFORE the slot's eviction decref so
        the block never transits through the free-list (refcount
        handoff). Spans already present keep their incumbent block (the
        walk continues through it): the caller's duplicate is released
        by its normal eviction decref, which also makes a preemption
        replay re-inserting its own adopted blocks a clean no-op.
        Returns the number of newly cached blocks."""
        n_full = min(len(blocks), len(prompt) // self.block_size)
        if n_full <= 0:
            return 0
        self._clock += 1
        node, fresh = self.root, 0
        for d, key in enumerate(self._spans(prompt, n_full)):
            child = node.children.get(key)
            if child is None:
                child = _Node(key, blocks[d], node)
                node.children[key] = child
                pool.cache_ref(blocks[d])
                fresh += 1
                self.n_inserted_blocks += 1
            child.last_use = self._clock
            node = child
        return fresh

    def reclaim(self, pool, need: int) -> int:
        """Free up to ``need`` cached blocks, least-recently-used leaves
        first, and return how many were actually freed. A leaf is
        reclaimable only while the pool's refcount says the cache is its
        SOLE holder; evicting it may expose its parent as the next
        candidate. Stops early when no reclaimable leaf remains — by the
        root-path invariant (an adopting slot references a node's whole
        ancestor chain) nothing else in the trie could be freed either."""
        if need <= 0:
            return 0
        cand: List = []
        stack = [self.root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                if child.children:
                    stack.append(child)
                else:
                    heapq.heappush(cand, (child.last_use, child.phys, child))
        freed = 0
        while freed < need and cand:
            _, _, node = heapq.heappop(cand)
            if node.children or node.parent is None:
                continue  # gained children meanwhile / already unlinked
            if not pool.is_sole_cached_ref(node.phys):
                continue  # a slot still reads it; not reclaimable (yet)
            parent = node.parent
            del parent.children[node.key]
            node.parent = None
            pool.cache_unref(node.phys)
            freed += 1
            self.n_reclaimed_blocks += 1
            if parent is not self.root and not parent.children:
                heapq.heappush(cand, (parent.last_use, parent.phys, parent))
        return freed

    def reset(self, pool) -> None:
        """Drop every cached block (releasing the cache's references) —
        pool-reset / test teardown hook."""
        stack = list(self.root.children.values())
        self.root.children.clear()
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            node.children.clear()
            node.parent = None
            pool.cache_unref(node.phys)
