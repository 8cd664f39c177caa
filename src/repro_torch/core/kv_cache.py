"""KV-cache ops — the beam reorders, the slot-pool row ops, the paged
block ops, the per-token byte rate and the concat-grown ``DynamicCache``
of ``repro/core/kv_cache.py``, as in-place index updates.

Every cache leaf's axis 0 is the sequence-slot axis: a transformer's K/V
buffers, or an SSM's conv tail and f32 state (``models/ssm.py``), beside
the ``lengths`` counter. Where the reference donates the pool to a jitted
program so XLA updates its buffers in place, the port writes into the
pool's tensors directly: refilling or evicting a slot never reallocates
the pool.

Paged pools (``core/slot_pool.BlockPool``) keep K/V as physical blocks
``[num_blocks, block_size, ...]`` addressed through a per-slot block table
(host numpy, shipped to the device by ``BlockPool.sync``); physical block 0
is the garbage sink that freed slots' table rows point at. The block ops
below copy prefilled rows into blocks (``append_block``), copy one block
over another (``copy_block``: the copy-on-write unshare of a block that two
streams of a slot group would both write) and set or zero a slot's counter
(``set_slot_length``, a fill on the device: an eviction inside a step's
launch phase copies nothing from the host); the block table itself is never
touched here.
"""
from __future__ import annotations

from typing import Any, Dict

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


def sorted_leaves(tree: Any):
    """The tensors of a nested dict/list tree in the reference's pytree
    order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from sorted_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from sorted_leaves(v)
    else:
        yield tree


def cache_bytes(cache: Any) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(cache))


def cache_token_bytes(cache: Any) -> float:
    """Bytes per cached token per sequence (the KV-cache rate): the whole
    cache's bytes over batch x the longest sequence axis. The batch is the
    leading axis of the first leaf of two or more dims in the reference's
    leaf order (a paged pool's block table: its slots), the sequence axis
    axis 1 of the leaves of three or more dims (a block pool's block size).
    0.0 when no leaf has two dims (``{}``, a cache of ``lengths`` alone)."""
    wide = [x for x in sorted_leaves(cache) if x.dim() >= 2]
    if not wide:
        return 0.0
    b = wide[0].shape[0]
    s = max((x.shape[1] for x in wide if x.dim() >= 3), default=1)
    return cache_bytes(cache) / (b * s)


def _map(fn, tree: Any) -> Any:
    """``tree`` rebuilt with ``fn`` applied to every tensor leaf."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


# --------------------------------------------------------------------------
# beam reorder (paper Obs #4's KV_Cache_Reorder)
# --------------------------------------------------------------------------

def reorder(cache: Any, beam_idx: torch.Tensor) -> Any:
    """The functional gather along the batch axis, ``cache[b] <-
    cache[beam_idx[b]]`` for every leaf, into fresh tensors (the reference's
    ``jnp.take(x, beam_idx, axis=0)``)."""
    idx = beam_idx.to(torch.long)
    return _map(lambda x: x.index_select(0, idx.to(x.device)), cache)


@torch.inference_mode()
def reorder_realloc(cache: Any, beam_idx: torch.Tensor) -> Any:
    """The paper's ``index_select`` baseline: gather every cache leaf along
    the batch axis, ``cache[b] <- cache[beam_idx[b]]`` (the K/V buffers,
    the cross K/V, ``lengths`` and ``frame_lengths``) into fresh tensors."""
    return reorder(cache, beam_idx)


@torch.inference_mode()
def reorder_donated(cache: Any, beam_idx: torch.Tensor) -> Any:
    """The reorder that keeps each cache tensor (the paper's "keep the
    memory pointer of each cache", the reference's donated jit): every
    leaf's gathered rows are copied back into it. Returns ``cache``."""
    idx = beam_idx.to(torch.long)
    for x in leaves(cache):
        x.copy_(x.index_select(0, idx.to(x.device)))
    return cache


@torch.inference_mode()
def write_slot(pool: Any, row: Any, slot: int) -> Any:
    """Copy a single-sequence cache (leaves [1, ...]) into sequence slot
    ``slot`` of a pooled cache (leaves [B, ...]), in place: that slot's
    buffers (K/V, or conv tail and state) and length counter only. Both
    trees are built by the same model code, so their leaves pair up in
    insertion order."""
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


def write_back(cache: Any, new: Any) -> Any:
    """Copy every leaf of a step's returned cache ``new`` that is not
    ``cache``'s own tensor into it, in place: the forward's fresh
    ``lengths``, and a recurrent layer's new state and conv tail (the
    attention K/V is written in place already). A step replayed as a CUDA
    graph must leave its state in the tensors it reads. Returns ``cache``."""
    if isinstance(new, dict):
        for k, v in new.items():
            write_back(cache[k], v)
    elif isinstance(new, (list, tuple)):
        for dst, src in zip(cache, new):
            write_back(dst, src)
    elif new is not cache:
        cache.copy_(new)
    return cache


@torch.inference_mode()
def rewind(cache: Any, new_lengths: torch.Tensor) -> Any:
    """Roll the cache back to ``new_lengths`` [B] tokens (a speculative
    window's rejected suffix): the new lengths are copied into the pool's
    ``lengths`` in place. The rejected K/V stays where it was, past the
    validity window, until the next write there replaces it."""
    cache["lengths"].copy_(new_lengths)
    return cache


# --------------------------------------------------------------------------
# paged block-pool ops
# --------------------------------------------------------------------------

@torch.inference_mode()
def append_block(pool_layers: Any, row_layers: Any, block: int, start: int) -> Any:
    """Copy one block of a prefilled dense row into physical block ``block``
    of a paged pool, in place: ``pool_layers`` leaves are [num_blocks,
    block_size, ...], ``row_layers`` leaves [1, S_row, ...], and the block
    is ``row[0, start : start + block_size]``. The row counts as zero-padded
    to a block multiple: a block past the row's end gets its tail zeroed,
    never a clamped slice that would shift its tokens."""
    for p, r in zip(leaves(pool_layers), leaves(row_layers)):
        chunk = r[0, start : start + p.shape[1]]
        n = chunk.shape[0]
        p[block, :n] = chunk.to(p.dtype)
        p[block, n:] = 0
    return pool_layers


@torch.inference_mode()
def copy_block(pool_layers: Any, src: int, dst: int) -> Any:
    """Copy physical block ``src`` over physical block ``dst`` in every K/V
    leaf ([num_blocks, block_size, ...]), in place: the copy-on-write unshare
    of a block two slot-group streams would otherwise both write. The pool's
    tensors are written where they are; no new buffer is allocated."""
    for p in leaves(pool_layers):
        p[dst].copy_(p[src])
    return pool_layers


def free_blocks(pool: Any, mask: torch.Tensor) -> Any:
    """Paged eviction: zero the freed slots' ``lengths`` in place
    (``reset_slots``). The block table and the block free-list are host
    state (``BlockPool``), and freed blocks need no clearing: stale K/V is
    unreachable until a new owner's validity mask covers what it rewrote."""
    return reset_slots(pool, mask)


@torch.inference_mode()
def set_slot_length(pool: Any, slot: int, length: int) -> Any:
    """Install one slot's token counter in place, a fill on the device
    (paged admission: the K/V rows arrive by ``append_block``; eviction:
    length 0, and freed blocks need no clearing, since stale K/V is
    unreachable until a new owner's validity mask covers what it rewrote)."""
    pool["lengths"][slot].fill_(length)
    return pool


class DynamicCache:
    """Concat-grown K/V cache, the anti-pattern the static cache replaces:
    every append reallocates each layer's K and V one step longer, so no
    step's shapes repeat and no step can be captured as a graph (the paper's
    Obs #2 launch-overhead pathology). Kept as the reference's baseline."""

    def __init__(self):
        self.layers: Dict[int, Dict[str, torch.Tensor]] = {}

    def append(self, layer: int, k: torch.Tensor, v: torch.Tensor):
        """Grow ``layer``'s K and V [B, S, ...] by ``k`` / ``v`` along axis 1
        (the first append stores them); returns the grown pair."""
        if layer not in self.layers:
            self.layers[layer] = {"k": k, "v": v}
        else:
            c = self.layers[layer]
            c["k"] = torch.cat([c["k"], k], dim=1)
            c["v"] = torch.cat([c["v"], v], dim=1)
        return self.layers[layer]["k"], self.layers[layer]["v"]

    @property
    def seq_len(self) -> int:
        if not self.layers:
            return 0
        return next(iter(self.layers.values()))["k"].shape[1]
