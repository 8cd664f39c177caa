"""Continuous-batching scheduler: slot recycling over the KV pools — the
``policy``/priority/greedy, paged and chunked parts of
``repro/core/scheduler.py``.

- ONE batch-1 ``engine.prefill`` admits a request into a free slot via the
  pool's in-place row write (``SlotPool.assign`` / ``BlockPool.assign``);
- ONE pool-wide ``engine.decode_step`` runs every step;
- after each step, finished slots (per-slot EOS / max-new, tracked in
  ``SlotState``) are evicted and refilled from the waiting queue, so the
  decode batch stays as full as the queue allows.

``policy="fixed"`` degrades the same machinery to run-to-completion
batches: admission only happens when the pool is drained. Both policies
run the same prefill and decode shapes, so they give the same tokens.
Admission honours ``ServeRequest.priority`` (highest arrived first, FIFO
within a class).

``paged=True`` swaps the contiguous SlotPool for the BlockPool: admission
is also gated on free blocks (the prompt's blocks plus a one-block
watermark, none when the pool is idle), every decode step first grows each
active slot oldest-first to cover its next write, and when the blocks run
out the youngest request of the lowest priority is preempted — evicted,
its blocks freed, and requeued at the queue's front for full recompute,
which greedy decoding replays token for token.

``chunked=True`` (requires ``paged=True``) admits by enqueueing a chunk
cursor (core/prefill.py) instead of running a prefill: every step with
pending cursors is ``engine.mixed_step``, carrying every live slot's decode
token plus up to ``prefill_budget`` prompt tokens written straight into
the admitted slots' blocks; steps with no pending chunk run the plain
decode step. A half-prefilled request is preempted like any other
resident and replays from chunk zero.

Not ported yet (``NotImplementedError``): the prefix cache, slot groups
(beam / contrastive), encoder-decoder requests (their frames at admission),
speculative windows, ``temperature > 0`` sampling
(it needs the per-(rid, token-index) keys of a later slice), priority
aging, replicas and TP.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import engine, sampling
from repro_torch.core.prefill import ChunkCursor, ChunkedPrefill
from repro_torch.core.slot_pool import BlockPool, SlotPool
from repro_torch.models.registry import Model


@dataclass
class ServeRequest:
    """One generation request plus its measured lifecycle timestamps
    (all relative to the scheduler run's t0; ``t_arrival`` is when the
    request becomes visible to the admission loop)."""

    rid: int
    prompt: np.ndarray  # [<= pad_to] int token ids
    max_new: int
    t_arrival: float = 0.0
    temperature: float = 0.0  # 0 => greedy (the only mode ported)
    eos_id: Optional[int] = None  # per-request EOS override
    priority: int = 0  # higher = more urgent
    # a decoding profile (beam / contrastive slot groups, speculative
    # windows); None = plain greedy, the only mode ported
    profile: Optional[Any] = None
    # ---- filled in by the scheduler ----
    tokens: List[int] = field(default_factory=list)
    t_first: Optional[float] = None  # first token (TTFT reference)
    t_done: Optional[float] = None

    @property
    def ttft(self) -> float:
        return self.t_first - self.t_arrival

    @property
    def tpot(self) -> float:
        """Mean time per output token after the first."""
        n = max(len(self.tokens) - 1, 1)
        return (self.t_done - self.t_first) / n

    @property
    def e2e(self) -> float:
        return self.t_done - self.t_arrival


@dataclass
class SlotState:
    """Host-side view of one occupied pool slot.

    ``kv_len`` mirrors the slot's device-side token counter (prompt tokens
    at admission, +1 per decode step): the logical position the NEXT decode
    write lands in, which paged growth must cover. ``admit_seq`` orders
    slots oldest-first for block contention (the preemption victim is the
    youngest)."""

    req: ServeRequest
    slot: int
    n_generated: int = 0
    kv_len: int = 0
    admit_seq: int = 0

    def finished(self, token: int, eos_id: Optional[int]) -> bool:
        return (eos_id is not None and token == eos_id) or (
            self.n_generated >= self.req.max_new
        )


class Scheduler:
    """Admission + decode-step loop over a ``SlotPool`` or ``BlockPool`` on
    ``device``.

    The per-slot last tokens live in a host numpy mirror shipped to the
    device once per step; the step's one device-to-host sync is the greedy
    argmax (``_sample``)."""

    def __init__(
        self,
        model: Model,
        params,
        *,
        slots: int,
        pad_to: int,
        max_new_cap: int,
        device,
        eos_id: Optional[int] = None,
        policy: str = "continuous",
        paged: bool = False,
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        chunked: bool = False,
        prefill_budget: Optional[int] = None,
        prefix_cache: bool = False,
    ):
        if policy not in ("continuous", "fixed"):
            raise ValueError(f"unknown policy {policy!r}")
        if chunked and not paged:
            raise ValueError("chunked prefill requires the paged block-pool")
        if chunked and policy != "continuous":
            raise ValueError("chunked prefill requires policy='continuous'")
        if prefix_cache:
            raise NotImplementedError(
                "the cross-request prefix cache waits for a later slice of the port"
            )
        if model.config.encdec is not None:
            raise NotImplementedError(
                "serving an encoder-decoder needs per-request extra inputs at admission: a "
                "later slice; run it batch-at-a-time (engine.generate_beam)"
            )
        self.model = model
        self.params = params
        self.slots = slots
        self.pad_to = pad_to
        self.max_new_cap = max_new_cap
        self.max_len = pad_to + max_new_cap + 1
        self.device = torch.device(device)
        self.eos_id = eos_id
        self.policy = policy
        self.paged = paged
        if paged:
            self.pool = BlockPool(model, slots, self.max_len, self.device,
                                  block_size=block_size, num_blocks=num_blocks)
        else:
            self.pool = SlotPool(model, slots, self.max_len, self.device)
        self.chunked = chunked
        self.chunk_mgr: Optional[ChunkedPrefill] = None
        if chunked:
            budget = prefill_budget if prefill_budget is not None else block_size
            self.chunk_mgr = ChunkedPrefill(slots, budget)
        self.active: Dict[int, SlotState] = {}
        self.waiting: Deque[ServeRequest] = deque()
        self.finished: List[ServeRequest] = []
        # host mirror of each slot's last token (free slots decode garbage)
        self._token = np.zeros((slots,), np.int32)
        # metrics
        self.n_decode_steps = 0  # every pool-wide step, mixed ones included
        self.n_prefills = 0
        self.n_preemptions = 0
        self.n_mixed_steps = 0  # steps that carried at least one chunk
        self.n_chunks = 0
        self.n_chunk_tokens = 0
        # decode-stall-per-admission: for an admission made while residents
        # decode, the interval from the previous step's commit to the next
        self.admission_stalls: List[float] = []
        self._last_commit_t: Optional[float] = None
        self._stall_marks: List[float] = []
        self.occupancy_trace: List[float] = []
        self.block_occupancy_trace: List[float] = []
        self.peak_used_blocks = 0
        self._seq = 0  # admission order (preemption picks the youngest)
        self._t0 = time.perf_counter()  # run() rebases; timestamps are offsets

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    # ---- request intake --------------------------------------------------
    def normalize(self, r: ServeRequest) -> ServeRequest:
        """Submit-time validation: caps ``max_new`` and refuses what this
        slice of the port cannot serve."""
        r.max_new = min(r.max_new, self.max_new_cap)
        if r.temperature > 0.0:
            raise NotImplementedError(
                f"request {r.rid}: temperature > 0 needs the per-(rid, token-index) "
                "sampling keys of a later slice of the port"
            )
        if r.profile is not None:
            raise NotImplementedError(
                f"request {r.rid}: decoding profiles (slot groups, speculative windows) "
                "wait for a later slice of the port"
            )
        return r

    def submit(self, requests: List[ServeRequest]) -> None:
        # arrival order first; within an arrival instant, higher priority
        # first (stable — submission order breaks remaining ties)
        for r in sorted(requests, key=lambda r: (r.t_arrival, -r.priority)):
            self.waiting.append(self.normalize(r))

    # ---- admission -------------------------------------------------------
    def _trim_prompt(self, prompt: np.ndarray) -> np.ndarray:
        """The one trim policy of both admission paths (dense prefill and
        chunk cursors)."""
        return np.asarray(prompt, np.int32)[: self.pad_to]

    def _pad_prompt(self, prompt: np.ndarray):
        p = self._trim_prompt(prompt)
        buf = np.zeros((1, self.pad_to), np.int32)
        buf[0, : len(p)] = p
        return (torch.from_numpy(buf).to(self.device),
                torch.tensor([len(p)], dtype=torch.int32, device=self.device))

    def _eos(self, req: ServeRequest) -> Optional[int]:
        return req.eos_id if req.eos_id is not None else self.eos_id

    def _mark_admission_stall(self) -> None:
        if self.active and self._last_commit_t is not None:
            self._stall_marks.append(self._last_commit_t)

    def _admit_one(self, req: ServeRequest) -> None:
        self._mark_admission_stall()
        slot = self.pool.acquire()
        if slot is None:
            raise RuntimeError("admission without a free slot")
        tokens, length = self._pad_prompt(req.prompt)
        n_prompt = min(len(req.prompt), self.pad_to)
        logits, row = engine.prefill(self.model, self.params, tokens, length,
                                     self.max_len)
        self.pool.assign(slot, row, n_prompt)
        if self.paged:
            # claim the first decode step's block now (the gate checked a
            # watermark but assign took only the prompt's blocks; without
            # this a block-aligned prompt could be preempted on its first
            # step). May fail on an idle just-fits pool: _ensure_blocks
            # grows it at step time.
            self.pool.ensure(slot, n_prompt)
        self.n_prefills += 1
        first = int(sampling.greedy(logits)[0])  # the admission's one sync
        req.t_first = self._now()
        req.tokens.append(first)
        state = SlotState(req=req, slot=slot, n_generated=1, kv_len=n_prompt,
                          admit_seq=self._seq)
        self._seq += 1
        if state.finished(first, self._eos(req)):
            req.t_done = req.t_first
            self.finished.append(req)
            self.pool.evict(slot)
            return
        self.active[slot] = state
        self._token[slot] = first

    def _admit_one_chunked(self, req: ServeRequest) -> None:
        """Chunked admission: no prefill and no dense row — a slot and a
        chunk cursor; the mixed steps stream the prompt into the slot's
        blocks ``prefill_budget`` tokens at a time."""
        self._mark_admission_stall()
        slot = self.pool.acquire()
        if slot is None:
            raise RuntimeError("admission without a free slot")
        cursor = ChunkCursor(req=req, slot=slot, prompt=self._trim_prompt(req.prompt),
                             admit_seq=self._seq)
        self._seq += 1
        self.chunk_mgr.add(cursor)

    def _admissible(self, req: ServeRequest) -> bool:
        """Pool-side admission gate: one free slot; paged, also the prompt's
        blocks (chunked: the first chunk's block) plus a one-block
        watermark while the pool is busy (optimistic admission: growth is
        served on demand and backed by preemption, not reserved)."""
        if self.pool.n_free < 1:
            return False
        if not self.paged:
            return True
        n_prompt = max(1, min(len(req.prompt), self.pad_to))
        need = 1 if self.chunked else self.pool.blocks_for(n_prompt)
        if self.pool.n_active == 0:
            # idle pool: every block is free and one worst-case request is
            # guaranteed to fit; gating on the watermark here could wedge
            return self.pool.n_free_blocks >= need
        return self.pool.n_free_blocks >= need + 1

    def _next_candidate(self, now: float):
        """(index, request) of the highest-priority ARRIVED request; stable
        (leftmost wins ties). Arrived requests are a queue prefix, so the
        scan stops at the first future arrival."""
        best_i, best = None, None
        for i, r in enumerate(self.waiting):
            if r.t_arrival > now:
                break
            if best is None or r.priority > best.priority:
                best_i, best = i, r
        return best_i, best

    def _admit(self, now: float) -> None:
        if self.policy == "fixed" and self.active:
            return  # run-to-completion: no refill until the pool drains
        while True:
            i, cand = self._next_candidate(now)
            if cand is None or not self._admissible(cand):
                return
            del self.waiting[i]
            if self.chunked:
                self._admit_one_chunked(cand)
            else:
                self._admit_one(cand)

    # ---- paged back-pressure ---------------------------------------------
    def _victim(self):
        """Preemption victim: the youngest request of the lowest priority
        among all residents, decoding slots and half-prefilled cursors."""
        cands: list = list(self.active.values())
        if self.chunk_mgr is not None:
            cands += list(self.chunk_mgr.cursors.values())
        return min(cands, key=lambda s: (s.req.priority, -s.admit_seq))

    def _preempt(self, st) -> None:
        """Out-of-blocks back-pressure: evict the slot, free its blocks and
        requeue the request at the FRONT of the waiting queue for full
        recompute. ``st`` is a SlotState (decoding) or a ChunkCursor
        (mid-prefill: the cursor is dropped and re-admission restarts at
        chunk zero)."""
        if isinstance(st, ChunkCursor):
            self.chunk_mgr.remove(st.slot)
        else:
            del self.active[st.slot]
        self.pool.evict(st.slot)
        st.req.tokens = []
        self.waiting.appendleft(st.req)
        self.n_preemptions += 1

    def _ensure_blocks(self) -> None:
        """Before a paged step every active slot must own the block its next
        token writes into. Residents grow oldest-first; when the pool runs
        dry the youngest lowest-priority resident is preempted (repeatedly
        if needed). Terminates: one worst-case request always fits, so the
        oldest resident can always run alone."""
        for ent in sorted(self.active.values(), key=lambda st: st.admit_seq):
            if ent.slot not in self.active:
                continue  # already preempted while growing an older one
            while not self.pool.ensure(ent.slot, ent.kv_len):
                victim = self._victim()
                self._preempt(victim)
                if victim is ent:
                    break  # this slot WAS the victim; it queues

    # ---- decode ----------------------------------------------------------
    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """All-greedy pool: one argmax and the step's ONE host sync."""
        return sampling.greedy(logits).cpu().numpy()

    def _record_step_metrics(self) -> None:
        self.n_decode_steps += 1
        self.occupancy_trace.append(self.pool.occupancy)
        if self.paged:
            self.block_occupancy_trace.append(self.pool.block_occupancy)
            self.peak_used_blocks = max(self.peak_used_blocks, self.pool.n_used_blocks)

    def _harvest_stalls(self, now: float) -> None:
        if self._stall_marks:
            self.admission_stalls.extend(now - m for m in self._stall_marks)
            self._stall_marks.clear()
        self._last_commit_t = now

    def _commit_decode(self, toks: np.ndarray, now: float) -> List[ServeRequest]:
        self._harvest_stalls(now)
        done: List[ServeRequest] = []
        for slot, st in list(self.active.items()):
            token = int(toks[slot])
            st.req.tokens.append(token)
            st.n_generated += 1
            st.kv_len += 1  # this step wrote the slot's K/V at kv_len
            self._token[slot] = token
            if st.finished(token, self._eos(st.req)):
                st.req.t_done = now
                self.finished.append(st.req)
                done.append(st.req)
                del self.active[slot]
                self.pool.evict(slot)
        return done

    def step(self) -> List[ServeRequest]:
        """One pool-wide step; returns the requests it finished. With
        pending chunk cursors it is the mixed step, else the plain decode
        step. Each step's one device-to-host copy is ``_sample``."""
        if self.chunked and len(self.chunk_mgr):
            return self._step_mixed()
        return self._step_decode()

    def _step_decode(self) -> List[ServeRequest]:
        if self.paged:
            self._ensure_blocks()
            if not self.active:
                return []  # everything preempted back to the queue
            self.pool.sync()
        token = torch.from_numpy(self._token).to(self.device)
        logits, self.pool.cache = engine.decode_step(self.model, self.params,
                                                     self.pool.cache, token)
        toks = self._sample(logits)
        self._record_step_metrics()
        return self._commit_decode(toks, self._now())

    def _step_mixed(self) -> List[ServeRequest]:
        """One token-budget mixed step: a decode lane for every live slot
        plus up to ``prefill_budget`` prompt-chunk tokens, one forward."""
        self._ensure_blocks()  # decode growth first (victims incl. cursors)
        # pack, then back every chunk's span with blocks; a starved cursor
        # is excluded and the plan rebuilt so its budget share flows to
        # cursors whose chunks are backed (no budget hoarding)
        decode_slots = list(self.active)
        starved: set = set()
        while True:
            plan = self.chunk_mgr.plan(self._token, decode_slots, skip=starved)
            newly = [ch.slot for ch in plan.chunks
                     if not self.pool.ensure(ch.slot, ch.start + ch.t - 1)]
            if not newly:
                break
            starved.update(newly)
        if not plan.chunks:
            if self.active:
                # every pending chunk is block-starved: run the 1-lane
                # decode step, not a mixed step with no prefill token
                return self._step_decode()
            # nothing runnable: several cursors wedged on blocks — free the
            # youngest lowest-priority one and retry on the next loop turn
            if len(self.chunk_mgr) <= 1:
                raise RuntimeError(
                    "single prefill cursor wedged: BlockPool must fit one "
                    "worst-case request"
                )
            self._preempt(self._victim())
            return []
        # authoritative per-slot write positions from host state: plain
        # decode steps drift the device counters of free and mid-prefill
        # rows (every row increments), so the mixed step pins them
        base = np.zeros((self.slots,), np.int32)
        for slot, st in self.active.items():
            base[slot] = st.kv_len
        for slot, cur in self.chunk_mgr.cursors.items():
            base[slot] = cur.pos
        self.pool.sync()
        logits, self.pool.cache = engine.mixed_step(
            self.model, self.params, self.pool.cache,
            torch.from_numpy(plan.tokens).to(self.device),
            torch.from_numpy(plan.t_new).to(self.device),
            torch.from_numpy(base).to(self.device),
        )
        toks = self._sample(logits)
        self._record_step_metrics()
        self.n_mixed_steps += 1
        now = self._now()
        done = self._commit_decode(toks, now)
        for ch in plan.chunks:
            cur = self.chunk_mgr.advance(ch)
            self.n_chunks += 1
            self.n_chunk_tokens += ch.t
            if cur.done:
                self.chunk_mgr.remove(ch.slot)
                self._finish_prefill(cur, int(toks[ch.slot]), now)
        return done

    def _finish_prefill(self, cur: ChunkCursor, first: int, now: float) -> None:
        """The final chunk's last-lane logits are the first-token logits:
        commit the request's first token and flip the slot from prefill to
        decode (its device length already equals the prompt length)."""
        req = cur.req
        req.t_first = now
        req.tokens.append(first)
        state = SlotState(req=req, slot=cur.slot, n_generated=1, kv_len=cur.n_prompt,
                          admit_seq=cur.admit_seq)
        if state.finished(first, self._eos(req)):
            req.t_done = now
            self.finished.append(req)
            self.pool.evict(cur.slot)
            return
        self.active[cur.slot] = state
        self._token[cur.slot] = first

    # ---- run loop --------------------------------------------------------
    @torch.inference_mode()
    def run(self, requests: List[ServeRequest]) -> List[ServeRequest]:
        """Serve ``requests`` to completion; returns them in finish order.
        A request is invisible to admission until ``t0 + t_arrival``."""
        self.submit(requests)
        self._t0 = time.perf_counter()
        while self.waiting or self.has_work:
            self._admit(self._now())
            if not self.has_work:
                if self.waiting:  # pool idle, next request not arrived yet
                    wait = self.waiting[0].t_arrival - self._now()
                    if wait > 0:
                        time.sleep(min(wait, 1e-3))
                continue
            self.step()
        return self.finished

    @property
    def has_work(self) -> bool:
        """True while any resident (decoding slot or chunk cursor) needs a
        step."""
        return bool(self.active or (self.chunk_mgr is not None and len(self.chunk_mgr)))

    @property
    def mean_occupancy(self) -> float:
        if not self.occupancy_trace:
            return 0.0
        return float(np.mean(self.occupancy_trace))

    @property
    def mean_block_occupancy(self) -> float:
        if not self.block_occupancy_trace:
            return 0.0
        return float(np.mean(self.block_occupancy_trace))
