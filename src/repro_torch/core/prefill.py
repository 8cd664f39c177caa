"""Chunked prefill: chunk cursors and the token-budget step packer — a copy
of ``repro/core/prefill.py`` (pure numpy host bookkeeping, no torch).

Chunked prefill (Sarathi/vLLM-style) splits each admitted prompt into
chunks and feeds at most ``prefill_budget`` prompt tokens into every
pool-wide step beside all live decode tokens; ``engine.mixed_step`` runs
both in one forward, so an admission never stalls the residents behind a
whole ``pad_to``-token prefill.

- a :class:`ChunkCursor` tracks one admitted-but-unprefilled request: the
  trimmed prompt, the slot it owns, and ``pos`` — how many prompt tokens
  have already been written into the slot's KV blocks;
- :meth:`ChunkedPrefill.plan` assembles one step: decode slots get their
  last sampled token in lane 0 (``t_new = 1``); waiting cursors are walked
  FIFO and granted ``min(remaining, budget_left)`` lanes each until the
  step's prefill budget is spent; idle rows ride with ``t_new = 0``;
- chunk spans are contiguous, disjoint, and strictly advancing — no prompt
  token is ever written twice, and a final partial chunk is *padded* to
  the lane width (``t_new`` records the true length), never dropped;
- preemption of a half-prefilled request simply removes its cursor
  (:meth:`ChunkedPrefill.remove`); re-admission starts a fresh cursor at
  ``pos = 0`` and replays the identical greedy token stream.

The scheduler (core/scheduler.py, ``chunked=True``) owns block allocation:
before dispatching a plan it ensures each scheduled chunk's span of KV
blocks exists, excluding (``skip``) the cursors the pool cannot back this
step.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List

import numpy as np


@dataclass
class ChunkCursor:
    """One admitted request mid-prefill: ``prompt[pos:]`` is still owed to
    the slot's KV blocks. ``admit_seq`` orders cursors against decode slots
    for preemption (the victim is the youngest lowest-priority resident)."""

    req: Any  # ServeRequest (duck-typed: .rid, .priority, .temperature, ...)
    slot: int
    prompt: np.ndarray  # [n_prompt] int32, already trimmed to pad_to
    admit_seq: int = 0
    pos: int = 0  # prompt tokens already written (the chunk cursor)

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32)
        if len(self.prompt) < 1:
            raise ValueError("chunked admission needs at least one prompt token")

    @property
    def n_prompt(self) -> int:
        return len(self.prompt)

    @property
    def remaining(self) -> int:
        return self.n_prompt - self.pos

    @property
    def done(self) -> bool:
        return self.pos >= self.n_prompt


@dataclass
class Chunk:
    """One scheduled chunk: ``t`` prompt tokens starting at ``start``."""

    slot: int
    start: int
    t: int


@dataclass
class StepPlan:
    """One mixed step's static-shape payload: ``tokens`` [slots, width] and
    per-slot ``t_new`` (0 = idle row), plus the chunk spans it covers."""

    tokens: np.ndarray
    t_new: np.ndarray
    chunks: List[Chunk] = field(default_factory=list)


class ChunkedPrefill:
    """Chunk-cursor queue + token-budget packer for the mixed step.

    ``budget`` is both the per-step prefill-token budget and the static
    lane width of the mixed-step executable (a single cursor may take the
    whole budget in one chunk, so the row must hold it). Cursors are kept
    in admission order (dict insertion order): the head cursor drains
    first, which keeps TTFT ordering close to FIFO admission.
    """

    def __init__(self, slots: int, budget: int):
        if budget < 1:
            raise ValueError("prefill budget must be at least one token")
        self.slots = slots
        self.budget = budget
        self.cursors: Dict[int, ChunkCursor] = {}  # slot -> cursor, FIFO

    def __len__(self) -> int:
        return len(self.cursors)

    def add(self, cursor: ChunkCursor) -> None:
        assert cursor.slot not in self.cursors, "slot already prefilling"
        self.cursors[cursor.slot] = cursor

    def remove(self, slot: int) -> ChunkCursor:
        """Drop a cursor (prefill finished, or the request was preempted —
        re-admission builds a fresh cursor, restarting at ``pos = 0``)."""
        return self.cursors.pop(slot)

    def plan(self, decode_tokens: np.ndarray, decode_slots: Iterable[int],
             skip: Iterable[int] = ()) -> StepPlan:
        """Pack one mixed step: decode lanes for every live slot plus up to
        ``budget`` prefill tokens from the cursor queue (FIFO). Does NOT
        advance cursors — the scheduler commits spans only after the step's
        blocks are ensured and the executable has run (``advance``).
        ``skip`` excludes cursors (by slot) whose chunks the pool cannot
        back this step, so their budget share flows to later cursors
        instead of being hoarded by a starved queue head."""
        tokens = np.zeros((self.slots, self.budget), np.int32)
        t_new = np.zeros((self.slots,), np.int32)
        skip = set(skip)
        for s in decode_slots:
            tokens[s, 0] = decode_tokens[s]
            t_new[s] = 1
        left = self.budget
        chunks: List[Chunk] = []
        for slot, cur in self.cursors.items():
            if left <= 0:
                break
            if slot in skip:
                continue
            t = min(cur.remaining, left)
            if t <= 0:
                continue
            tokens[slot, :t] = cur.prompt[cur.pos : cur.pos + t]
            t_new[slot] = t  # final partial chunk: padded lanes, true t_new
            chunks.append(Chunk(slot=slot, start=cur.pos, t=t))
            left -= t
        return StepPlan(tokens=tokens, t_new=t_new, chunks=chunks)

    def advance(self, chunk: Chunk) -> ChunkCursor:
        """Commit one dispatched chunk: the cursor moves past it, exactly
        once (the no-token-written-twice invariant)."""
        cur = self.cursors[chunk.slot]
        assert chunk.start == cur.pos, "chunk committed out of order"
        assert chunk.t >= 1 and chunk.start + chunk.t <= cur.n_prompt
        cur.pos += chunk.t
        return cur
