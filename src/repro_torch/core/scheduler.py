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

A multi-stream profile (beam, contrastive; core/profiles.py) makes its
request a *slot group* of ``n_streams`` slots, acquired, evicted and
preempted all or nothing, and ranked as one unit for growth and victim
choice. Group streams ride the pool-wide step like every slot; after it the
scheduler gathers each group's logits rows and lets its profile pick the
streams' next tokens and an optional cache permutation (beam's Obs #4 KV
reorder): on the paged pool a host table rewrite with copy-on-write
sharing (``BlockPool.permute_group`` / ``ensure_writable``), on the
contiguous pool a row gather (``kv_cache.reorder_donated``). A group always
takes the dense prefill, and so does a request with ``extra_inputs``
(encoder frames, written into its slots' cross-attention rows): encoder-
decoders serve on the contiguous pool. A group's step key folds (request
id, token index) into the serve key, so its replay after a preemption is
the same.

``prefix_cache=True`` (requires ``chunked``) adds the cross-request radix
prefix cache (core/prefix_cache.py): a chunked admission adopts every
cached leading full block of its prompt and starts its cursor at the first
uncached token; finished and preempted requests hand their full prompt
blocks to the trie; blocks only the trie holds are reclaimed, least
recently used first, before anything is preempted.

``priority_boost_after`` ages waiting requests (``age_waiting``): every
full interval an arrived request waits raises its priority by one, so a
steady stream of urgent traffic cannot starve it. Times come from the
injectable ``clock``; ``busy_s`` sums the clock time of this pool's own
admissions and steps.

A step is two phases, so the replica router (core/router.py) can launch
every replica's step before it waits for any: ``step_begin`` stages the
step's host inputs (tokens, plan, write positions, keys, knobs, a changed
block table) through pinned host buffers, copies them to the device without
blocking, launches the forward and the sampler and starts the sampled
tokens' copy back into a pinned buffer behind a CUDA event; ``step_finish``
waits on that event (the step's one sync) and commits on the host.
``step()`` is the two back to back. A speculative begin syncs no more
than a plain one: the verify window's write has a static shape
(``attention.window_addresses``). Admissions may copy synchronously.

``tp`` (a ``distributed.tp_pool.TPContext``) makes the scheduler one
rank of a tensor-parallel pool: the model, params and device are the
rank's (its widths, its shard, its card), and every prefill, decode,
mixed, verify and draft call goes through the one dispatch seam
``self._steps`` — the TP step family here, the single-device one
otherwise. Every rank runs the same scheduler on the same trace; rank 0
broadcasts each sampled token tensor (and the clock's readings), and every
rank commits those, so the host state stays the same on every rank by
construction, never by float sums agreeing. A TP step syncs the host (the
group's collectives wait), so ``step_begin``'s no-sync contract holds for
single-device steps only.
"""
from __future__ import annotations

import contextlib
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.hotpath import hot_path
from repro_torch.core import engine, kv_cache, layerskip, prng, profiles, sampling
from repro_torch.core.prefill import ChunkCursor, ChunkedPrefill
from repro_torch.core.prefix_cache import PrefixCache
from repro_torch.core.slot_pool import BlockPool, SlotPool
from repro_torch.models.registry import Model


class _SingleDevice:
    """The single-device step family, read from its modules at each call."""

    prefill = property(lambda self: engine.prefill)
    decode_step = property(lambda self: engine.decode_step)
    mixed_step = property(lambda self: engine.mixed_step)
    verify_step = property(lambda self: engine.verify_step)
    draft_window = property(lambda self: layerskip.draft_window)


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
    # boosts ``age_waiting`` already folded into ``priority``: a requeued or
    # replayed request is never granted the same boost twice
    n_boosts: int = 0
    # HOW to decode: None = per-slot sampling at (temperature, top_p); a
    # single-stream SamplingProfile collapses onto that, a
    # SpeculativeProfile adds draft/verify windows, a multi-stream profile
    # (beam, contrastive) makes the request a slot group
    profile: Optional[profiles.DecodingProfile] = None
    # prefill inputs beyond the prompt (an encoder-decoder's frames [1, F, d]
    # and frame_lengths [1]), written into the slot's own cross rows
    extra_inputs: Optional[Dict[str, np.ndarray]] = None
    # ---- filled in by the scheduler ----
    tokens: List[int] = field(default_factory=list)
    score: Optional[float] = None  # beam: the best hypothesis' score
    t_admit: Optional[float] = None
    t_first: Optional[float] = None  # first token (TTFT reference)
    t_done: Optional[float] = None
    # commit time of every token (t_first first)
    t_tokens: List[float] = field(default_factory=list)

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

    def padded_output(self, eos_id: Optional[int]) -> np.ndarray:
        """[max_new] output padded with ``eos_id`` (0 without one), as
        ``engine.generate`` returns its rows."""
        out = np.full((self.max_new,), eos_id if eos_id is not None else 0, np.int32)
        out[: len(self.tokens)] = self.tokens
        return out


def age_waiting(waiting, now: float, boost_after: Optional[float]) -> int:
    """The max-waiting-time boost of ``Scheduler._admit`` and the router's
    placement: every ARRIVED request gains one priority for each full
    ``boost_after`` seconds it has waited. ``n_boosts`` remembers what was
    granted, so a second call at the same ``now``, a preemption requeue or
    a spill grants nothing twice. Returns the boosts granted."""
    if boost_after is None or boost_after <= 0:
        return 0
    granted = 0
    for r in waiting:
        if r.t_arrival > now:
            break  # arrived requests are a queue prefix
        due = int((now - r.t_arrival) // boost_after)
        if due > r.n_boosts:
            r.priority += due - r.n_boosts
            granted += due - r.n_boosts
            r.n_boosts = due
    return granted


class _Staging:
    """One scheduler's per-step host buffers on a CUDA device: pinned, so a
    host-to-device copy from them returns at once, and so does the copy of
    the sampled tokens back. The host writes a buffer only in the next
    ``step_begin``, after this step's ``step_finish`` waited on the event
    recorded behind the step's last copy: every earlier copy on the stream
    has run by then. On the CPU the buffers are plain tensors and every
    copy is a plain one."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pinned = device.type == "cuda"
        self._bufs: Dict[str, torch.Tensor] = {}

    def _buf(self, name: str, shape, dtype) -> torch.Tensor:
        buf = self._bufs.get(name)
        if buf is None or buf.shape != shape or buf.dtype != dtype:
            # a normal tensor even when made inside a step's inference mode:
            # a caller outside that mode may stage through it too
            with torch.inference_mode(False):
                buf = torch.empty(shape, dtype=dtype, pin_memory=self.pinned)
            self._bufs[name] = buf
        return buf

    def host(self, name: str, arr: np.ndarray) -> torch.Tensor:
        """``arr`` copied into the host buffer ``name``."""
        src = torch.from_numpy(np.ascontiguousarray(arr))
        buf = self._buf(name, src.shape, src.dtype)
        buf.copy_(src)
        return buf

    def put(self, name: str, arr: np.ndarray) -> torch.Tensor:
        """``arr`` on the device, copied from the buffer ``name`` without
        blocking the host."""
        return self.host(name, arr).to(self.device, non_blocking=True, copy=True)

    def fetch(self, name: str, t: torch.Tensor) -> Tuple[torch.Tensor, Any]:
        """Start ``t``'s copy into the host buffer ``name``; returns the
        buffer and the event that marks the copy done (None on the CPU)."""
        buf = self._buf(name, t.shape, t.dtype)
        buf.copy_(t, non_blocking=True)
        if not self.pinned:
            return buf, None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return buf, event

    @staticmethod
    def wait(fetched) -> np.ndarray:
        """The fetched tensor on the host, once its copy is done."""
        buf, event = fetched
        if event is not None:
            event.synchronize()
        return buf.numpy().copy()


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


@dataclass
class GroupState:
    """Host-side view of one slot group: stream ``i`` lives in pool slot
    ``slots[i]``. Streams advance in lockstep, so one ``kv_len`` covers the
    group; its decoding state is ``pstate`` (the profile's, made anew on a
    preemption replay). ``admit_seq`` ranks the group as one unit;
    ``slot_rows`` is ``slots`` on the device, made once at admission, which
    gathers the group's logits rows every step."""

    req: ServeRequest
    slots: List[int]
    profile: profiles.DecodingProfile
    pstate: Any
    n_generated: int = 0
    kv_len: int = 0
    admit_seq: int = 0
    slot_rows: Any = None


class Scheduler:
    """Admission + decode-step loop over a ``SlotPool`` or ``BlockPool`` on
    ``device``.

    The per-slot decode state (last token, request id, tokens generated,
    temperature, top-p) lives in host numpy mirrors staged to the device
    once per step; the step's one device-to-host copy is its sampled tokens
    (``_sample`` / ``_sample_window``). ``base_key`` (default
    ``PRNGKey(0)``) seeds every request's sampling keys, which are folded
    on the host. ``replica_id`` names the pool in a router's fleet. With
    ``tp`` (a rank's ``TPContext``) the rank's local model, shard and device
    replace ``model``, ``params`` and ``device`` (``device`` must then be
    None)."""

    def __init__(
        self,
        model: Model,
        params,
        *,
        slots: int,
        pad_to: int,
        max_new_cap: int,
        device=None,
        eos_id: Optional[int] = None,
        policy: str = "continuous",
        paged: bool = False,
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        chunked: bool = False,
        prefill_budget: Optional[int] = None,
        prefix_cache: bool = False,
        priority_boost_after: Optional[float] = None,
        base_key: Optional[torch.Tensor] = None,
        clock=time.perf_counter,
        replica_id: int = 0,
        tp=None,
    ):
        if policy not in ("continuous", "fixed"):
            raise ValueError(f"unknown policy {policy!r}")
        if tp is not None and device is not None:
            raise ValueError("tp and device are mutually exclusive: a TP pool's rank is "
                             "placed by its group")
        if tp is None and device is None:
            raise ValueError("a Scheduler needs a device (or a tp context)")
        if chunked and not paged:
            raise ValueError("chunked prefill requires the paged block-pool")
        if chunked and policy != "continuous":
            raise ValueError("chunked prefill requires policy='continuous'")
        if prefix_cache and not chunked:
            # only a chunk cursor starts a prompt past position 0
            raise ValueError("prefix_cache requires chunked prefill")
        # the ONE dispatch seam: every prefill / decode / mixed / verify /
        # draft call goes through ``self._steps``
        self.tp = tp
        if tp is not None:
            model, params, device = tp.model, tp.params, tp.device
            clock = tp.group.shared_clock(clock)
            self._steps = tp.executables()
        else:
            self._steps = _SingleDevice()
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
        self.priority_boost_after = priority_boost_after
        self.clock = clock
        self.replica_id = replica_id
        self._staging = _Staging(self.device)
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
        # host-only trie over the pool's blocks: no device memory of its own
        self._pcache: Optional[PrefixCache] = (
            PrefixCache(self.pool.block_size) if prefix_cache else None)
        self.active: Dict[int, SlotState] = {}
        self.groups: Dict[int, GroupState] = {}  # slot groups by their first slot
        self.waiting: Deque[ServeRequest] = deque()
        self.finished: List[ServeRequest] = []
        # host mirrors of the per-slot decode state (free slots decode greedy
        # garbage under rid 0, their tokens discarded; so do group streams,
        # whose real tokens come from their profile's step)
        self._token = np.zeros((slots,), np.int32)
        self._rid = np.zeros((slots,), np.int64)
        self._stream = np.zeros((slots,), np.int64)  # stream index in a group
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
        self.n_group_admissions = 0
        # a beam reorder: a device row gather (contiguous pool) or a host
        # table permutation (paged pool)
        self.n_cache_reorders = 0
        self.n_block_permutes = 0
        # prefix cache: a lookup is one chunked admission's trie walk; the
        # skipped tokens are prompt positions adopted instead of prefilled
        self.n_prefix_lookups = 0
        self.n_prefix_hits = 0
        self.n_prefix_tokens_skipped = 0
        self.cached_block_trace: List[int] = []  # per step, like occupancy
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
        self.n_priority_boosts = 0  # age_waiting's grants
        # clock seconds of this pool's own admissions and steps: a router's
        # fleet runs as fast as its busiest replica would on a card of its own
        self.busy_s = 0.0
        self._seq = 0  # admission order (preemption picks the youngest)
        self._t0 = self.clock()  # run() rebases; timestamps are offsets

    def _now(self) -> float:
        return self.clock() - self._t0

    def _on_device(self):
        """The pool's card as the current device (kernels launch on the
        current device's stream); nothing on the CPU."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    # ---- request intake --------------------------------------------------
    def normalize(self, r: ServeRequest) -> ServeRequest:
        """Submit-time validation: caps ``max_new``, refuses a group that
        could never fit (more streams than slots; paged, more than the
        pool's usable blocks at worst), collapses a single-stream
        ``SamplingProfile`` (a ``SpeculativeProfile`` too) onto the per-slot
        sampling fields and checks a speculative one against the model."""
        r.max_new = min(r.max_new, self.max_new_cap)
        if r.profile is None:
            return r
        if not isinstance(r.profile, profiles.DecodingProfile):
            raise TypeError(f"request {r.rid}: profile {r.profile!r} is not a DecodingProfile")
        s_n = r.profile.n_streams
        if s_n > self.slots:
            raise ValueError(
                f"request {r.rid} needs a slot group of {s_n} streams but the pool has "
                f"only {self.slots} slots"
            )
        if self.paged and s_n * self.pool.max_blocks > self.pool.num_blocks - 1:
            # the preemption ladder ends only if the oldest resident can
            # always run alone, at its worst case
            raise ValueError(
                f"request {r.rid}: a {s_n}-stream group can need up to "
                f"{s_n * self.pool.max_blocks} blocks but the pool has "
                f"{self.pool.num_blocks - 1} usable"
            )
        if s_n > 1 or not isinstance(r.profile, profiles.SamplingProfile):
            return r
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
        if (self.active or self.groups) and self._last_commit_t is not None:
            self._stall_marks.append(self._last_commit_t)

    def _request_extra(self, req: ServeRequest) -> Optional[Dict[str, torch.Tensor]]:
        """The request's prefill extras (encoder frames) on the device."""
        if not req.extra_inputs:
            return None
        return {k: torch.as_tensor(v, device=self.device) for k, v in req.extra_inputs.items()}

    def _acquire(self) -> int:
        slot = self.pool.acquire()
        if slot is None:
            raise RuntimeError("admission without a free slot")
        return slot

    def _admit_one(self, req: ServeRequest, now: float) -> None:
        self._mark_admission_stall()
        slot = self._acquire()
        tokens, length = self._pad_prompt(req.prompt)
        n_prompt = min(len(req.prompt), self.pad_to)
        logits, row = self._steps.prefill(self.model, self.params, tokens, length,
                                          self.max_len, extra=self._request_extra(req))
        if self.paged:
            # assign pops the free-list directly: reclaim any shortfall from
            # the prefix cache first (the gate counted those blocks as free)
            self._reclaim_for(self.pool.blocks_for(n_prompt))
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
            first = int(self._agree(sampling.greedy(logits))[0])  # the admission's one sync
        else:  # the (rid, stream 0, token 0) key, as every later token's
            keys = sampling.slot_step_keys(self.base_key, [req.rid], [0])
            knobs = torch.tensor([[req.temperature], [req.top_p]]).to(self.device)
            first = int(self._agree(sampling.sample_slots(
                logits, torch.from_numpy(keys).to(self.device), knobs[0], knobs[1]))[0])
        req.t_admit, req.t_first = now, self._now()
        req.tokens.append(first)
        req.t_tokens.append(req.t_first)
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

    def _admit_one_chunked(self, req: ServeRequest, now: float) -> None:
        """Chunked admission: no prefill and no dense row — a slot and a
        chunk cursor; the mixed steps stream the prompt into the slot's
        blocks ``prefill_budget`` tokens at a time. With the prefix cache
        the cursor starts at the first uncached token: the cached leading
        full blocks are adopted, and their tokens enter no chunk."""
        self._mark_admission_stall()
        slot = self._acquire()
        prompt = self._trim_prompt(req.prompt)
        pos = self._prefix_admit(slot, prompt) if self._pcache is not None else 0
        cursor = ChunkCursor(req=req, slot=slot, prompt=prompt, admit_seq=self._seq, pos=pos)
        self._seq += 1
        self.chunk_mgr.add(cursor)
        req.t_admit = now
        # staged now, so the step that finishes the prefill samples the first
        # token under the (rid, 0, 0) key with everyone else's decode tokens
        self._stage(slot, req, n_generated=0)

    def _admit_one_group(self, req: ServeRequest, now: float) -> None:
        """Slot-group admission: ``n_streams`` slots all or nothing, the
        profile's stream prompts prefilled, and the profile's first step run
        on the prefill logits. A prefix-shared group (beam) prefills once:
        on the paged pool the other streams ``share`` its blocks, the
        contiguous pool writes the row into every stream's slot."""
        prof = req.profile
        s_n = prof.n_streams
        self._mark_admission_stall()
        slots = [self._acquire() for _ in range(s_n)]
        prompts = prof.stream_prompts(self._trim_prompt(req.prompt))
        n_lens = {len(p) for p in prompts}
        if len(n_lens) != 1:
            raise ValueError("a group's streams must share one prompt length")
        n_prompt = n_lens.pop()
        if self.paged:
            # a group's assigns pop the free-list directly
            self._reclaim_for(self.pool.blocks_for(n_prompt)
                              * (1 if prof.prefix_shared else s_n))
        extra = self._request_extra(req)
        if prof.prefix_shared:
            tokens, length = self._pad_prompt(prompts[0])
            logits, row = self._steps.prefill(self.model, self.params, tokens, length,
                                              self.max_len, extra=extra)
            self.n_prefills += 1
            self.pool.assign(slots[0], row, n_prompt)
            for s in slots[1:]:
                if self.paged:
                    self.pool.share(s, slots[0])
                else:
                    self.pool.assign(s, row, n_prompt)
            logit_rows = logits.repeat(s_n, 1)  # identical streams
        else:
            rows = []
            for s, p in zip(slots, prompts):
                tokens, length = self._pad_prompt(p)
                logits, row = self._steps.prefill(self.model, self.params, tokens, length,
                                                  self.max_len, extra=extra)
                self.n_prefills += 1
                self.pool.assign(s, row, n_prompt)
                rows.append(logits)
            logit_rows = torch.cat(rows, dim=0)
        req.t_admit = now
        g = GroupState(req=req, slots=slots, profile=prof,
                       pstate=prof.init(1, req.max_new, self.device), kv_len=n_prompt,
                       admit_seq=self._seq,
                       slot_rows=torch.tensor(slots, dtype=torch.long, device=self.device))
        self._seq += 1
        self.n_group_admissions += 1
        for i, s in enumerate(slots):
            self._rid[s] = req.rid
            self._stream[s] = i
            self._ngen[s] = 0
            self._temp[s] = 0.0  # a group samples in its profile
        if not self._advance_group(g, logit_rows, self._now()):
            self.groups[g.slots[0]] = g

    def _admissible(self, req: ServeRequest) -> bool:
        """Pool-side admission gate: ``n_streams`` free slots; paged, also
        free blocks for the streams' prompts plus a one-block watermark
        while the pool is busy (optimistic admission: growth is served on
        demand and backed by preemption, not reserved). A prefix-shared
        group needs its prompt's blocks once plus ``n_streams - 1``
        copy-on-write spares for the write cursor's block; a chunked single
        request only its first chunk's block. Blocks only the prefix cache
        holds count as free: admission reclaims them before any pop."""
        s_n = profiles.n_streams_of(req.profile)
        if self.pool.n_free < s_n:
            return False
        if not self.paged:
            return True
        n_prompt = max(1, min(len(req.prompt), self.pad_to))
        if s_n > 1:
            if req.profile.prefix_shared:
                need = self.pool.blocks_for(n_prompt) + (s_n - 1)
            else:
                need = self.pool.blocks_for(n_prompt) * s_n
        elif self.chunked:
            need = 1
        else:
            need = self.pool.blocks_for(n_prompt)
        free_b = self.pool.n_free_blocks
        if self._pcache is not None:
            free_b += self.pool.n_reclaimable_blocks
        if self.pool.n_active == 0:
            # idle pool: every block is free and one worst-case request is
            # guaranteed to fit; gating on the watermark here could wedge
            return free_b >= need
        return free_b >= need + 1

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
        if self.policy == "fixed" and (self.active or self.groups):
            return  # run-to-completion: no refill until the pool drains
        self.n_priority_boosts += age_waiting(self.waiting, now, self.priority_boost_after)
        while True:
            i, cand = self._next_candidate(now)
            if cand is None or not self._admissible(cand):
                return
            del self.waiting[i]
            self._admit_request(cand, now)

    def _admit_request(self, req: ServeRequest, now: float) -> None:
        if profiles.n_streams_of(req.profile) > 1:
            self._admit_one_group(req, now)
        elif self.chunked and not req.extra_inputs:
            # a chunk streams tokens only: extra inputs need the prefill
            self._admit_one_chunked(req, now)
        else:
            self._admit_one(req, now)

    # ---- router hooks (core/router.py) -----------------------------------
    def free_capacity(self) -> int:
        """The router's load signal: free blocks when paged, else free
        slots."""
        return self.pool.n_free_blocks if self.paged else self.pool.n_free

    def admissible(self, req: ServeRequest) -> bool:
        """Would ``try_admit`` take ``req`` now?"""
        return self._admissible(req)

    @torch.inference_mode()
    def try_admit(self, req: ServeRequest, now: float) -> bool:
        """Admit ``req`` (already normalized by the router) if this pool has
        room, else refuse: the router then spills it to the next replica.
        The admission's time is this pool's work, so it goes into
        ``busy_s``."""
        if not self._admissible(req):
            return False
        t = self.clock()
        with self._on_device():
            self._admit_request(req, now)
        self.busy_s += self.clock() - t
        return True

    def drain_waiting(self) -> List[ServeRequest]:
        """Hand back the requests this pool preempted onto its own queue,
        front first, for the router's shared queue: a replay may land on
        any replica, and its keys give it the same tokens there."""
        out = list(self.waiting)
        self.waiting.clear()
        return out

    def drain_finished(self) -> List[ServeRequest]:
        """Hand the finished requests to the router, in finish order."""
        out = self.finished
        self.finished = []
        return out

    def rebase(self, t0: float) -> None:
        """Set this pool's clock origin: a router gives every replica one,
        so their timestamps compare."""
        self._t0 = t0

    # ---- cross-request prefix cache (core/prefix_cache.py) ----------------
    @hot_path
    def _prefix_admit(self, slot: int, prompt: np.ndarray) -> int:
        """Adopt every cached leading full block of ``prompt`` into
        ``slot``'s table (refcounted, no device K/V work) and return the
        matched token count, where the chunk cursor starts. The match leaves
        at least one suffix token, whose logits the mixed step computes as
        cold serving does."""
        self.n_prefix_lookups += 1
        blocks = self._pcache.match(prompt)
        if not blocks:
            return 0
        matched = len(blocks) * self.pool.block_size
        self.pool.adopt(slot, blocks, matched)
        self.n_prefix_hits += 1
        self.n_prefix_tokens_skipped += matched
        return matched

    def _prefix_insert(self, slot: int, req: ServeRequest,
                       n_written: Optional[int] = None) -> None:
        """At every slot release (finish, preemption), before ``evict``
        drops the slot's references: hand the request's fully written prompt
        blocks to the trie, so they go from owned to cached without visiting
        the free-list. ``n_written`` caps a half-prefilled cursor's span. A
        span the trie holds already keeps its block (a replay inserting the
        blocks it adopted is a no-op)."""
        if self._pcache is None or req.extra_inputs:
            return
        prompt = self._trim_prompt(req.prompt)
        n = len(prompt) if n_written is None else min(n_written, len(prompt))
        n_full = n // self.pool.block_size
        if n_full <= 0:
            return
        self._pcache.insert(prompt, self.pool.owned_blocks(slot)[:n_full], self.pool)

    def _reclaim_for(self, need: int) -> None:
        """Make ``need`` blocks really free for a path that pops the
        free-list directly (a dense or group ``assign``): reclaim the
        shortfall from the prefix cache's least recently used leaves."""
        if self._pcache is not None:
            short = need - self.pool.n_free_blocks
            if short > 0:
                self._pcache.reclaim(self.pool, short)

    @hot_path
    def _ensure_or_reclaim(self, slot: int, kv_len: int, writable: bool = False) -> bool:
        """``BlockPool.ensure`` (``ensure_writable`` for a group stream)
        with the prefix cache as the first back-pressure: while the
        free-list is dry, reclaim one cached-only block and retry; False
        only when the trie has nothing to give, and the caller preempts."""
        grow = self.pool.ensure_writable if writable else self.pool.ensure
        while not grow(slot, kv_len):
            if self._pcache is None or not self._pcache.reclaim(self.pool, 1):
                return False
        return True

    # ---- paged back-pressure ---------------------------------------------
    def _victim(self):
        """Preemption victim: the youngest request of the lowest priority
        among all residents: decoding slots, half-prefilled cursors and
        whole slot groups."""
        cands: list = list(self.active.values()) + list(self.groups.values())
        if self.chunk_mgr is not None:
            cands += list(self.chunk_mgr.cursors.values())
        return min(cands, key=lambda s: (s.req.priority, -s.admit_seq))

    def _preempt(self, st) -> None:
        """Out-of-blocks back-pressure: evict the slot(s), free the blocks
        and requeue the request at the FRONT of the waiting queue for full
        recompute. ``st`` is a SlotState (decoding), a ChunkCursor
        (mid-prefill: the cursor is dropped and re-admission restarts at
        chunk zero; its written full blocks seed the prefix cache) or a
        GroupState (every stream's slot evicted, the profile state
        dropped)."""
        if isinstance(st, GroupState):
            del self.groups[st.slots[0]]
            for s in st.slots:
                self.pool.evict(s)
                self._temp[s] = 0.0
        else:
            if isinstance(st, ChunkCursor):
                self.chunk_mgr.remove(st.slot)
                self._prefix_insert(st.slot, st.req, n_written=st.pos)
            else:
                del self.active[st.slot]
                self._prefix_insert(st.slot, st.req)
            self.pool.evict(st.slot)
            self._temp[st.slot] = 0.0  # free slots decode greedy garbage
        st.req.tokens = []
        st.req.t_tokens = []
        st.req.score = None
        self.waiting.appendleft(st.req)
        self.n_preemptions += 1

    @hot_path
    def _ensure_blocks(self, extra: Optional[np.ndarray] = None) -> None:
        """Before a paged step every resident must own the block its next
        token writes into, a group stream exclusively (copy-on-write via
        ``ensure_writable``); ``extra`` [slots] widens a slot's target by
        that many positions past ``kv_len`` (a speculative window's writes
        reach ``kv_len + w - 1``; groups never step speculatively).
        Residents grow oldest-first, a group as one unit; when the pool runs
        dry (and the prefix cache has nothing to reclaim) the youngest
        lowest-priority resident is preempted, repeatedly if needed.
        Terminates: one worst-case request (or group, checked at submit)
        always fits, so the oldest resident can always run alone."""
        ents = sorted(list(self.active.values()) + list(self.groups.values()),
                      key=lambda st: st.admit_seq)
        for ent in ents:
            if isinstance(ent, GroupState):
                if ent.slots[0] not in self.groups:
                    continue  # already preempted while growing an older one
                gone = False
                for s in ent.slots:
                    while not self._ensure_or_reclaim(s, ent.kv_len, writable=True):
                        victim = self._victim()
                        self._preempt(victim)
                        if victim is ent:
                            gone = True
                            break
                    if gone:
                        break
                continue
            if ent.slot not in self.active:
                continue  # already preempted while growing an older one
            # repro-lint: disable=HS001 — extra is the host's numpy width vector
            target = ent.kv_len + (0 if extra is None else int(extra[ent.slot]))
            while not self._ensure_or_reclaim(ent.slot, target):
                victim = self._victim()
                self._preempt(victim)
                if victim is ent:
                    break  # this slot WAS the victim; it queues

    # ---- decode ----------------------------------------------------------
    def _agree(self, toks: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``toks`` on every rank of a TP pool (one broadcast): the
        tokens every rank commits. ``toks`` itself on one device."""
        return toks if self.tp is None else self.tp.group.broadcast(toks)

    @hot_path
    def _sample(self, logits: torch.Tensor):
        """Launch per-slot sampling (an all-greedy pool takes the argmax
        alone; the keys are folded on the host and staged with the knobs)
        and start the tokens' copy to the host: the fetch ``step_finish``
        waits on, the step's one device-to-host copy."""
        if not self._temp.any():  # repro-lint: disable=TB001 — the host's numpy knobs
            toks = sampling.greedy(logits)
        else:
            keys = sampling.slot_step_keys(self.base_key, self._rid, self._ngen, self._stream)
            knobs = self._staging.put("knobs", np.stack([self._temp, self._top_p]))
            toks = sampling.sample_slots(logits, self._staging.put("keys", keys), knobs[0],
                                         knobs[1])
        return self._staging.fetch("tokens", self._agree(toks))

    def _record_step_metrics(self) -> None:
        self.n_decode_steps += 1
        self.occupancy_trace.append(self.pool.occupancy)
        if self.paged:
            self.block_occupancy_trace.append(self.pool.block_occupancy)
            self.peak_used_blocks = max(self.peak_used_blocks, self.pool.n_used_blocks)
        if self._pcache is not None:
            self.cached_block_trace.append(self.pool.n_cached_blocks)

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
            st.req.t_tokens.append(now)
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
        self._prefix_insert(st.slot, st.req)
        self.pool.evict(st.slot)
        self._temp[st.slot] = 0.0  # free slots decode greedy garbage

    @hot_path
    def step(self) -> List[ServeRequest]:
        """One pool-wide step, both phases back to back; returns the
        requests it finished."""
        return self.step_finish(self.step_begin())

    @hot_path
    @torch.inference_mode()
    def step_begin(self):
        """Phase 1 of one pool-wide step: with pending chunk cursors the
        mixed step; else, with a speculative resident that has two or more
        tokens of budget left, the draft + verify step; else the plain
        decode step. Launches its device work and the sampled tokens' copy
        to the host without waiting for the card, and returns the handle
        ``step_finish`` takes (None: no device work, everything was
        preempted back to the queue)."""
        t = self.clock()
        try:
            with self._on_device():
                if self.chunked and len(self.chunk_mgr):
                    return self._begin_mixed()
                if self._spec_ready():
                    return self._begin_speculative()
                return self._begin_decode()
        finally:
            self.busy_s += self.clock() - t

    @hot_path
    @torch.inference_mode()
    def step_finish(self, pending) -> List[ServeRequest]:
        """Phase 2: wait for the step's sampled tokens (its one sync) and
        commit them on the host; returns the requests the step finished.
        Nothing may be admitted between a pool's begin and its finish: the
        commit walks the residents the begin launched for."""
        if pending is None:
            return []
        t = self.clock()
        try:
            with self._on_device():
                kind, *args = pending
                if kind == "mixed":
                    return self._finish_mixed(*args)
                if kind == "spec":
                    return self._finish_speculative(*args)
                return self._finish_decode(*args)
        finally:
            self.busy_s += self.clock() - t

    @hot_path
    def _begin_decode(self):
        if self.paged:
            self._ensure_blocks()
            if not self.active and not self.groups:
                return None  # everything preempted back to the queue
        self.pool.sync(self._staging)
        logits, self.pool.cache = self._steps.decode_step(
            self.model, self.params, self.pool.cache, self._staging.put("token", self._token))
        return ("decode", logits, self._sample(logits))

    @hot_path
    def _finish_decode(self, logits: torch.Tensor, fetched) -> List[ServeRequest]:
        toks = self._staging.wait(fetched)
        self._record_step_metrics()
        now = self._now()
        done = self._commit_decode(toks, now)
        return done + self._commit_groups(logits, now)

    @hot_path
    def _begin_mixed(self):
        """One token-budget mixed step: a decode lane for every live slot
        plus up to ``prefill_budget`` prompt-chunk tokens, one forward."""
        self._ensure_blocks()  # decode growth first (victims incl. cursors)
        # pack, then back every chunk's span with blocks; a starved cursor
        # is excluded and the plan rebuilt so its budget share flows to
        # cursors whose chunks are backed (no budget hoarding)
        decode_slots = list(self.active) + [s for g in self.groups.values() for s in g.slots]
        starved: set = set()
        while True:
            plan = self.chunk_mgr.plan(self._token, decode_slots, skip=starved)
            newly = [ch.slot for ch in plan.chunks
                     if not self._ensure_or_reclaim(ch.slot, ch.start + ch.t - 1)]
            if not newly:
                break
            starved.update(newly)
        if not plan.chunks:
            if self.active or self.groups:
                # every pending chunk is block-starved: run the 1-lane
                # decode step, not a mixed step with no prefill token
                return self._begin_decode()
            # nothing runnable: several cursors wedged on blocks — free the
            # youngest lowest-priority one and retry on the next loop turn
            if len(self.chunk_mgr) <= 1:
                raise RuntimeError(
                    "single prefill cursor wedged: BlockPool must fit one "
                    "worst-case request"
                )
            self._preempt(self._victim())
            return None
        # authoritative per-slot write positions from host state: plain
        # decode steps drift the device counters of free and mid-prefill
        # rows (every row increments), so the mixed step pins them
        base = np.zeros((self.slots,), np.int32)
        for slot, st in self.active.items():
            base[slot] = st.kv_len
        for g in self.groups.values():
            base[g.slots] = g.kv_len
        for slot, cur in self.chunk_mgr.cursors.items():
            base[slot] = cur.pos
        self.pool.sync(self._staging)
        logits, self.pool.cache = self._steps.mixed_step(
            self.model, self.params, self.pool.cache,
            self._staging.put("plan_tokens", plan.tokens), self._staging.put("t_new", plan.t_new),
            self._staging.put("base", base),
        )
        return ("mixed", logits, plan.chunks, self._sample(logits))

    @hot_path
    def _finish_mixed(self, logits: torch.Tensor, chunks, fetched) -> List[ServeRequest]:
        toks = self._staging.wait(fetched)
        self._record_step_metrics()
        self.n_mixed_steps += 1
        now = self._now()
        done = self._commit_decode(toks, now)
        done += self._commit_groups(logits, now)
        for ch in chunks:
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
        req.t_tokens.append(now)
        state = SlotState(req=req, slot=cur.slot, n_generated=1, kv_len=cur.n_prompt,
                          admit_seq=cur.admit_seq)
        if state.finished(first, self._eos(req)):
            req.t_done = now
            self.finished.append(req)
            self._prefix_insert(cur.slot, req)
            self.pool.evict(cur.slot)
            self._temp[cur.slot] = 0.0
            return
        self.active[cur.slot] = state
        self._token[cur.slot] = first
        self._ngen[cur.slot] = 1

    # ---- speculative decoding (SpeculativeProfile windows) ----------------
    def _spec_ready(self) -> bool:
        """A draft + verify step pays only when some resident slot can commit
        two or more tokens this step. A resident group forces plain steps
        (beam's per-step permutation and variable strides do not compose)."""
        if self.groups:
            return False
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

    @hot_path
    def _begin_speculative(self):
        """One draft + verify step (LayerSkip, paper §4.3), at the largest
        resident (exit_layer, n_draft): narrower slots are frozen through
        per-slot draft counts ``n_live``. Paged, every slot first grows for
        its whole window (draft writes reach ``kv_len + w - 2``, verify
        ``kv_len + w - 1``), which may preempt; the widths are then rebuilt
        for the survivors and the table synced once, before the draft."""
        if self.paged:
            self._ensure_blocks(extra=np.maximum(self._window_widths() - 1, 0))
            if not self.active:
                return None  # everything preempted back to the queue
        w = self._window_widths()
        k_step, e_step = 0, 1
        for st in self.active.values():
            prof = st.req.profile
            if isinstance(prof, profiles.SpeculativeProfile):
                k_step = max(k_step, prof.n_draft)
                e_step = max(e_step, prof.exit_layer)
        if k_step == 0:  # every speculative slot was preempted away
            return self._begin_decode()
        base = np.zeros((self.slots,), np.int32)
        for slot, st in self.active.items():
            base[slot] = st.kv_len
        self.pool.sync(self._staging)
        # token, drafts a slot, write position and width: one copy
        host = np.stack([self._token, np.maximum(w - 1, 0), base, w]).astype(np.int32)
        token0, n_live, lengths, t_new = self._staging.put("window_plan", host)
        window, cache = self._steps.draft_window(self.model, e_step, k_step, self.params,
                                                 self.pool.cache, token0, n_live, lengths)
        logits, self.pool.cache = self._steps.verify_step(self.model, self.params, cache,
                                                          window, t_new, lengths)
        return ("spec", w, self._sample_window(logits, window))

    @hot_path
    def _finish_speculative(self, w: np.ndarray, fetched) -> List[ServeRequest]:
        both = self._staging.wait(fetched)
        self._record_step_metrics()
        self.n_spec_steps += 1
        done = self._commit_window(both[0], both[1], w, self._now())
        # the rejected suffixes rolled back on the host: one pool-wide
        # lengths rewind (paged: table truncation too), built after the
        # evictions so freed slots rewind to 0
        new_len = np.zeros((self.slots,), np.int32)
        for slot, st in self.active.items():
            new_len[slot] = st.kv_len
            self.pool.truncate(slot, st.kv_len)
        kv_cache.rewind(self.pool.cache, torch.from_numpy(new_len).to(self.device))
        return done

    @hot_path
    def _sample_window(self, logits: torch.Tensor, window: torch.Tensor):
        """Every verify lane sampled under its own key: lane ``j`` of a slot
        holds its request's token index ``n_generated + j``, the key plain
        decoding folds in for that token. Starts the copy of (samples,
        window) to the host, the step's one device-to-host copy, and
        returns its fetch."""
        if not self._temp.any():  # repro-lint: disable=TB001 — the host's numpy knobs
            samples = sampling.greedy(logits)
        else:
            steps = self._ngen[:, None] + np.arange(logits.shape[1])[None]
            keys = sampling.window_step_keys(self.base_key, self._rid, steps, self._stream)
            knobs = self._staging.put("knobs", np.stack([self._temp, self._top_p]))
            samples = sampling.sample_window(logits, self._staging.put("window_keys", keys),
                                             knobs[0], knobs[1])
        return self._staging.fetch("window", torch.stack([self._agree(samples), window]))

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
                st.req.t_tokens.append(now)
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

    # ---- slot groups (multi-stream decoding profiles) ---------------------
    @hot_path
    def _advance_group(self, g: GroupState, logit_rows: torch.Tensor, now: float) -> bool:
        """One profile step of one group: the profile takes the group's
        [n_streams, V] logits rows and gives every stream's next feed token,
        an optional cache permutation and the finish flags, read in one
        device-to-host copy. The step key folds (request id, token index)
        into the serve key, so a replay draws the same keys wherever its
        slots lie. Returns True when the group finished (slots evicted)."""
        key = prng.fold_in(sampling.request_key(self.base_key, g.req.rid), g.n_generated)
        out = g.profile.step(g.pstate, logit_rows, torch.from_numpy(key))
        g.pstate = out.state
        s_n = len(g.slots)
        parts = [out.feed.to(torch.int64)]
        if out.perm is not None:
            parts.append(out.perm.to(torch.int64))
        if out.done is not None:
            parts.append(out.done.to(torch.int64))
        # the group's one sync a step, through the staged copy
        host = self._staging.wait(self._staging.fetch("group", self._agree(torch.cat(parts))))
        feed, rest = host[:s_n], host[s_n:]
        if out.perm is not None:
            self._apply_group_perm(g, rest[:s_n])
            rest = rest[s_n:]
        g.n_generated += 1
        if g.n_generated == 1:
            g.req.t_first = now
        g.req.t_tokens.append(now)
        self._token[g.slots] = feed
        self._ngen[g.slots] = g.n_generated
        finished = out.done is not None and bool(rest.all())
        if finished or g.n_generated >= g.req.max_new:
            self._finish_group(g, now)
            return True
        return False

    @hot_path
    def _apply_group_perm(self, g: GroupState, perm: np.ndarray) -> None:
        """Re-bind each stream's cache to its surviving parent's (beam's
        Obs #4 reorder). Paged: a host table permutation with refcounted
        prefix sharing, no device K/V moved (the write cursor's block is
        unshared by the next ``_ensure_blocks``). Contiguous: one in-place
        pool-wide row gather (``kv_cache.reorder_donated``), identity
        outside the group's slots."""
        if np.array_equal(perm, np.arange(len(g.slots))):
            return  # every stream kept its own cache
        if self.paged:
            self.pool.permute_group(g.slots, perm)
            self.n_block_permutes += 1
        else:
            full = np.arange(self.slots)
            sl = np.asarray(g.slots)  # repro-lint: disable=HS001 — a host list
            full[sl] = sl[perm]
            kv_cache.reorder_donated(self.pool.cache, torch.from_numpy(full).to(self.device))
            self.n_cache_reorders += 1

    @hot_path
    def _commit_groups(self, logits: torch.Tensor, now: float) -> List[ServeRequest]:
        """Advance every resident group on the pool-wide step's logits (its
        rows gathered by the admission-time device index). Runs after the
        step wrote each stream's K/V at ``kv_len``, hence the increment."""
        done: List[ServeRequest] = []
        for g in list(self.groups.values()):
            g.kv_len += 1
            if self._advance_group(g, logits[g.slot_rows], now):
                done.append(g.req)
        return done

    def _finish_group(self, g: GroupState, now: float) -> None:
        """Collapse the profile state into the request's output (beam: the
        best hypothesis and its score) and free every stream's slot."""
        fin = g.profile.finalize(g.pstate)
        toks = fin["tokens"][0].cpu().numpy()
        g.req.tokens = [int(t) for t in toks[: g.n_generated]]
        if "scores" in fin:
            g.req.score = float(fin["scores"][0])
        g.req.t_done = now
        self.finished.append(g.req)
        self.groups.pop(g.slots[0], None)
        for s in g.slots:
            self.pool.evict(s)
            self._temp[s] = 0.0

    # ---- run loop --------------------------------------------------------
    @torch.inference_mode()
    def run(self, requests: List[ServeRequest]) -> List[ServeRequest]:
        """Serve ``requests`` to completion; returns them in finish order.
        A request is invisible to admission until ``t0 + t_arrival``."""
        self.submit(requests)
        self._t0 = self.clock()
        while self.waiting or self.has_work:
            with self._on_device():
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
        """True while any resident (decoding slot, slot group or chunk
        cursor) needs a step."""
        return bool(self.active or self.groups
                    or (self.chunk_mgr is not None and len(self.chunk_mgr)))

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

    # ---- prefix-cache metrics (launch/serve.py report) --------------------
    @property
    def prefix_hit_rate(self) -> float:
        """Share of chunked admissions that adopted at least one block."""
        return self.n_prefix_hits / max(self.n_prefix_lookups, 1)

    @property
    def n_prefix_reclaimed(self) -> int:
        return self._pcache.n_reclaimed_blocks if self._pcache else 0

    @property
    def mean_cached_blocks(self) -> float:
        """Mean count of blocks the prefix cache held a step."""
        if not self.cached_block_trace:
            return 0.0
        return float(np.mean(self.cached_block_trace))
