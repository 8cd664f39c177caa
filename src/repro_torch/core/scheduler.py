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

Every token is sampled per slot under the key folded from (request id,
stream, token index) into ``base_key`` (``sampling.slot_step_keys``), at the
request's own temperature and top-p (greedy at temperature 0): a request's
tokens depend on nothing but its own, so preemption replays them and the
policy, pool kind and batch mates never change them.

``SpeculativeProfile`` requests (LayerSkip, paper §4.3) make a step commit a
variable number of tokens: while a resident speculative slot has two or more
tokens of budget left (and no chunk is pending), the step drafts up to
``n_draft`` tokens per speculative slot with the first ``exit_layer`` layers
(``layerskip.draft_window``, into the pool cache), verifies every slot's
window in one full-model forward (``engine.verify_step``), samples each lane
under the key its token index would get under plain decoding, commits the
accepted prefix plus the full model's correction, and rolls the rejected
suffix back on the host (``kv_cache.rewind``; paged adds
``BlockPool.truncate``). Plain slots ride the same step with width-1
windows. The tokens equal a plain run's at any temperature.

Not ported yet (``NotImplementedError``): the prefix cache, slot groups
(beam / contrastive profiles), encoder-decoder requests (their frames at
admission), priority aging, replicas and TP.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import engine, kv_cache, layerskip, prng, profiles, sampling
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
    temperature: float = 0.0  # 0 => greedy
    top_p: float = 1.0  # 1 => no nucleus filtering
    eos_id: Optional[int] = None  # per-request EOS override
    priority: int = 0  # higher = more urgent
    # HOW to decode: None = per-slot sampling at (temperature, top_p); a
    # single-stream SamplingProfile collapses onto that, a
    # SpeculativeProfile adds draft/verify windows (slot groups: later)
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

    The per-slot decode state (last token, request id, tokens generated,
    temperature, top-p) lives in host numpy mirrors shipped to the device
    once per step; the step's one device-to-host copy is its sampled tokens
    (``_sample`` / ``_sample_window``). ``base_key`` (default
    ``PRNGKey(0)``) seeds every request's sampling keys, which are folded
    on the host."""

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
        base_key: Optional[torch.Tensor] = None,
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
        # the serve key, kept on the host: per-slot keys are folded in numpy
        # and shipped with the step (no device launch for them)
        self.base_key = (prng.PRNGKey(0) if base_key is None else base_key).cpu().numpy()
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
        # host mirrors of the per-slot decode state (free slots decode greedy
        # garbage under rid 0; their tokens are discarded)
        self._token = np.zeros((slots,), np.int32)
        self._rid = np.zeros((slots,), np.int64)
        self._stream = np.zeros((slots,), np.int64)  # always 0 until slot groups
        self._ngen = np.zeros((slots,), np.int64)
        self._temp = np.zeros((slots,), np.float32)
        self._top_p = np.ones((slots,), np.float32)
        # metrics
        self.n_decode_steps = 0  # every pool-wide step, mixed and speculative included
        self.n_prefills = 0
        self.n_preemptions = 0
        self.n_mixed_steps = 0  # steps that carried at least one chunk
        self.n_chunks = 0
        self.n_chunk_tokens = 0
        # speculative accounting: a "spec slot-step" is one slot carrying a
        # window of 2 or more lanes through one step; the histogram keys on
        # the tokens that slot committed (1: every draft rejected)
        self.n_spec_steps = 0  # steps that ran the draft + verify pair
        self.n_spec_slot_steps = 0
        self.n_spec_drafted = 0  # draft tokens proposed (window width - 1)
        self.n_spec_accepted = 0  # draft tokens the full model kept
        self.n_spec_committed = 0  # tokens committed by spec slot-steps
        self.spec_commit_hist: Dict[int, int] = {}
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
        """Submit-time validation: caps ``max_new``, collapses a
        single-stream ``SamplingProfile`` (a ``SpeculativeProfile`` too)
        onto the per-slot sampling fields, checks a speculative one against
        the model, and refuses the slot groups of multi-stream profiles."""
        r.max_new = min(r.max_new, self.max_new_cap)
        if r.profile is None:
            return r
        if not isinstance(r.profile, profiles.SamplingProfile):
            raise NotImplementedError(
                f"request {r.rid}: multi-stream profiles (beam / contrastive slot groups) "
                "wait for a later slice of the port"
            )
        if r.profile.sampler is not None:
            raise ValueError(
                "SamplingProfile.sampler callables are a batch-engine escape hatch; the "
                "pool serves the (temperature, top_p, eos_id) spec"
            )
        r.temperature = r.profile.temperature
        r.top_p = r.profile.top_p
        if r.profile.eos_id is not None:
            r.eos_id = r.profile.eos_id
        if isinstance(r.profile, profiles.SpeculativeProfile):
            self._check_speculative(r.rid, r.profile)
        return r

    def _check_speculative(self, rid: int, prof: profiles.SpeculativeProfile) -> None:
        """A speculative request needs a cache that rolls back (the rejected
        window is undone by a lengths rewind / table truncation: an SSM's
        recurrent state cannot be) and an exit strictly inside the stack."""
        cfg = self.model.config
        if cfg.family not in layerskip.FAMILIES:
            raise ValueError(
                f"request {rid}: SpeculativeProfile needs rollback-able attention caches; "
                f"family {cfg.family!r} is unsupported"
            )
        if not 1 <= prof.exit_layer < cfg.n_layers:
            raise ValueError(
                f"request {rid}: exit_layer must be in [1, {cfg.n_layers - 1}], got "
                f"{prof.exit_layer}"
            )
        if prof.n_draft < 1:
            raise ValueError(f"request {rid}: n_draft must be >= 1, got {prof.n_draft}")

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
        if req.temperature <= 0.0:
            first = int(sampling.greedy(logits)[0])  # the admission's one sync
        else:  # the (rid, stream 0, token 0) key, as every later token's
            keys = sampling.slot_step_keys(self.base_key, [req.rid], [0])
            knobs = torch.tensor([[req.temperature], [req.top_p]]).to(self.device)
            first = int(sampling.sample_slots(logits, torch.from_numpy(keys).to(self.device),
                                              knobs[0], knobs[1])[0])
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
        self._stage(slot, req, n_generated=1)

    def _stage(self, slot: int, req: ServeRequest, n_generated: int) -> None:
        """Install a slot's sampling state: its request id, stream 0, the
        index of its next token, its temperature and top-p."""
        self._rid[slot] = req.rid
        self._stream[slot] = 0
        self._ngen[slot] = n_generated
        self._temp[slot] = req.temperature
        self._top_p[slot] = req.top_p

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
        # staged now, so the step that finishes the prefill samples the first
        # token under the (rid, 0, 0) key with everyone else's decode tokens
        self._stage(slot, req, n_generated=0)

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
        self._temp[st.slot] = 0.0  # free slots decode greedy garbage
        st.req.tokens = []
        self.waiting.appendleft(st.req)
        self.n_preemptions += 1

    def _ensure_blocks(self, extra: Optional[np.ndarray] = None) -> None:
        """Before a paged step every active slot must own the block its next
        token writes into; ``extra`` [slots] widens a slot's target by that
        many positions past ``kv_len`` (a speculative window's writes reach
        ``kv_len + w - 1``). Residents grow oldest-first; when the pool runs
        dry the youngest lowest-priority resident is preempted (repeatedly
        if needed). Terminates: one worst-case request always fits, so the
        oldest resident can always run alone."""
        for ent in sorted(self.active.values(), key=lambda st: st.admit_seq):
            if ent.slot not in self.active:
                continue  # already preempted while growing an older one
            target = ent.kv_len + (0 if extra is None else int(extra[ent.slot]))
            while not self.pool.ensure(ent.slot, target):
                victim = self._victim()
                self._preempt(victim)
                if victim is ent:
                    break  # this slot WAS the victim; it queues

    # ---- decode ----------------------------------------------------------
    def _knobs(self) -> torch.Tensor:
        """(temperature, top_p) [2, slots] on the device."""
        return torch.from_numpy(np.stack([self._temp, self._top_p])).to(self.device)

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """Per-slot sampling (an all-greedy pool takes the argmax alone) and
        the step's ONE device-to-host copy; the keys are folded on the
        host."""
        if not self._temp.any():
            return sampling.greedy(logits).cpu().numpy()
        keys = sampling.slot_step_keys(self.base_key, self._rid, self._ngen, self._stream)
        knobs = self._knobs()
        return sampling.sample_slots(logits, torch.from_numpy(keys).to(self.device), knobs[0],
                                     knobs[1]).cpu().numpy()

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
            self._ngen[slot] = st.n_generated
            if st.finished(token, self._eos(st.req)):
                self._finish(st, now)
                done.append(st.req)
        return done

    def _finish(self, st: SlotState, now: float) -> None:
        st.req.t_done = now
        self.finished.append(st.req)
        del self.active[st.slot]
        self.pool.evict(st.slot)
        self._temp[st.slot] = 0.0  # free slots decode greedy garbage

    def step(self) -> List[ServeRequest]:
        """One pool-wide step; returns the requests it finished. With
        pending chunk cursors it is the mixed step; else, with a speculative
        resident that has two or more tokens of budget left, the draft +
        verify step; else the plain decode step. Each step's one
        device-to-host copy is its sampled tokens."""
        if self.chunked and len(self.chunk_mgr):
            return self._step_mixed()
        if self._spec_ready():
            return self._step_speculative()
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
            self._temp[cur.slot] = 0.0
            return
        self.active[cur.slot] = state
        self._token[cur.slot] = first
        self._ngen[cur.slot] = 1

    # ---- speculative decoding (SpeculativeProfile windows) ----------------
    def _spec_ready(self) -> bool:
        """A draft + verify step pays only when some resident slot can commit
        two or more tokens this step."""
        return any(isinstance(st.req.profile, profiles.SpeculativeProfile)
                   and st.req.max_new - st.n_generated >= 2
                   for st in self.active.values())

    def _window_widths(self) -> np.ndarray:
        """Each slot's verify-window width for one speculative step: a
        speculative slot ``min(n_draft + 1, budget left)`` (so a commit never
        overshoots ``max_new`` and the window never writes past the pool's
        ``max_len``), a plain slot 1 (its lane 0 is the plain decode step's),
        a free slot 0 (frozen through draft and verify)."""
        w = np.zeros((self.slots,), np.int32)
        for slot, st in self.active.items():
            left = st.req.max_new - st.n_generated
            prof = st.req.profile
            w[slot] = (min(prof.n_draft + 1, left)
                       if isinstance(prof, profiles.SpeculativeProfile) else 1)
        return w

    def _step_speculative(self) -> List[ServeRequest]:
        """One draft + verify step (LayerSkip, paper §4.3), at the largest
        resident (exit_layer, n_draft): narrower slots are frozen through
        per-slot draft counts ``n_live``. Paged, every slot first grows for
        its whole window (draft writes reach ``kv_len + w - 2``, verify
        ``kv_len + w - 1``), which may preempt; the widths are then rebuilt
        for the survivors and the table synced once, before the draft."""
        if self.paged:
            self._ensure_blocks(extra=np.maximum(self._window_widths() - 1, 0))
            if not self.active:
                return []  # everything preempted back to the queue
        w = self._window_widths()
        k_step, e_step = 0, 1
        for st in self.active.values():
            prof = st.req.profile
            if isinstance(prof, profiles.SpeculativeProfile):
                k_step = max(k_step, prof.n_draft)
                e_step = max(e_step, prof.exit_layer)
        if k_step == 0:  # every speculative slot was preempted away
            return self._step_decode()
        base = np.zeros((self.slots,), np.int32)
        for slot, st in self.active.items():
            base[slot] = st.kv_len
        self.pool.sync()
        # token, drafts a slot, write position and width: one copy
        host = np.stack([self._token, np.maximum(w - 1, 0), base, w]).astype(np.int32)
        token0, n_live, lengths, t_new = torch.from_numpy(host).to(self.device)
        window, cache = layerskip.draft_window(self.model, e_step, k_step, self.params,
                                               self.pool.cache, token0, n_live, lengths)
        logits, self.pool.cache = engine.verify_step(self.model, self.params, cache, window,
                                                     t_new, lengths)
        samples, win = self._sample_window(logits, window)
        self._record_step_metrics()
        self.n_spec_steps += 1
        done = self._commit_window(samples, win, w, self._now())
        # the rejected suffixes rolled back on the host: one pool-wide
        # lengths rewind (paged: table truncation too), built after the
        # evictions so freed slots rewind to 0
        new_len = np.zeros((self.slots,), np.int32)
        for slot, st in self.active.items():
            new_len[slot] = st.kv_len
            self.pool.truncate(slot, st.kv_len)
        kv_cache.rewind(self.pool.cache, torch.from_numpy(new_len).to(self.device))
        return done

    def _sample_window(self, logits: torch.Tensor, window: torch.Tensor):
        """Every verify lane sampled under its own key: lane ``j`` of a slot
        holds its request's token index ``n_generated + j``, the key plain
        decoding folds in for that token. Returns (samples, window) on the
        host, the step's one device-to-host copy."""
        if not self._temp.any():
            samples = sampling.greedy(logits)
        else:
            steps = self._ngen[:, None] + np.arange(logits.shape[1])[None]
            keys = sampling.window_step_keys(self.base_key, self._rid, steps, self._stream)
            knobs = self._knobs()
            samples = sampling.sample_window(logits, torch.from_numpy(keys).to(self.device),
                                             knobs[0], knobs[1])
        both = torch.stack([samples, window]).cpu().numpy()
        return both[0], both[1]

    def _commit_window(self, samples: np.ndarray, win: np.ndarray, w: np.ndarray,
                       now: float) -> List[ServeRequest]:
        """Variable-stride commit: slot ``b`` commits ``samples[b, 0..m]``,
        ``m`` the first lane whose full-model sample contradicts the draft
        (that sample is the full model's correction), the last lane, or an
        EOS / ``max_new`` finish, whichever comes first. ``kv_len`` grows by
        the commits: the verify step wrote lanes ``0..m-1``'s K/V, and the
        last committed token's K/V lands in the next step's lane 0."""
        self._harvest_stalls(now)
        done: List[ServeRequest] = []
        for slot, st in list(self.active.items()):
            wi = int(w[slot])
            eos = self._eos(st.req)
            commits, token, fin = 0, 0, False
            for j in range(wi):
                token = int(samples[slot, j])
                st.req.tokens.append(token)
                st.n_generated += 1
                commits += 1
                fin = st.finished(token, eos)
                if fin or j + 1 >= wi or token != int(win[slot, j + 1]):
                    break
            st.kv_len += commits
            self._token[slot] = token
            self._ngen[slot] = st.n_generated
            if wi > 1:
                self.n_spec_slot_steps += 1
                self.n_spec_drafted += wi - 1
                self.n_spec_accepted += commits - 1
                self.n_spec_committed += commits
                self.spec_commit_hist[commits] = self.spec_commit_hist.get(commits, 0) + 1
            if fin:
                self._finish(st, now)
                done.append(st.req)
        return done

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
