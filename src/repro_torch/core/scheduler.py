"""Continuous-batching scheduler: slot recycling over the contiguous KV
slot-pool — the ``policy``/priority/greedy part of
``repro/core/scheduler.py``.

- ONE batch-1 ``engine.prefill`` admits a request into a free slot via the
  pool's in-place row write (``SlotPool.assign``);
- ONE pool-wide ``engine.decode_step`` runs every step;
- after each step, finished slots (per-slot EOS / max-new, tracked in
  ``SlotState``) are evicted and refilled from the waiting queue, so the
  decode batch stays as full as the queue allows.

``policy="fixed"`` degrades the same machinery to run-to-completion
batches: admission only happens when the pool is drained. Both policies
run the same prefill and decode shapes, so they give the same tokens.
Admission honours ``ServeRequest.priority`` (highest arrived first, FIFO
within a class).

Not ported yet (``NotImplementedError``): the paged block pool, chunked
prefill and the prefix cache (next slice), slot groups (beam /
contrastive), speculative windows, ``temperature > 0`` sampling (it needs
the per-(rid, token-index) keys of a later slice), priority aging, replicas
and TP.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import engine, sampling
from repro_torch.core.slot_pool import SlotPool
from repro_torch.models.registry import Model

_NEXT_SLICE = "the paged + chunked serving slice of the port"


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
    """Host-side view of one occupied pool slot."""

    req: ServeRequest
    slot: int
    n_generated: int = 0

    def finished(self, token: int, eos_id: Optional[int]) -> bool:
        return (eos_id is not None and token == eos_id) or (
            self.n_generated >= self.req.max_new
        )


class Scheduler:
    """Admission + decode-step loop over a ``SlotPool`` on ``device``.

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
        chunked: bool = False,
        prefix_cache: bool = False,
    ):
        if policy not in ("continuous", "fixed"):
            raise ValueError(f"unknown policy {policy!r}")
        if paged or chunked or prefix_cache:
            raise NotImplementedError(
                f"paged / chunked / prefix-cache serving waits for {_NEXT_SLICE}"
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
        self.pool = SlotPool(model, slots, self.max_len, self.device)
        self.active: Dict[int, SlotState] = {}
        self.waiting: Deque[ServeRequest] = deque()
        self.finished: List[ServeRequest] = []
        # host mirror of each slot's last token (free slots decode garbage)
        self._token = np.zeros((slots,), np.int32)
        # metrics
        self.n_decode_steps = 0
        self.n_prefills = 0
        # decode-stall-per-admission: for an admission made while residents
        # decode, the interval from the previous step's commit to the next
        self.admission_stalls: List[float] = []
        self._last_commit_t: Optional[float] = None
        self._stall_marks: List[float] = []
        self.occupancy_trace: List[float] = []
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
    def _pad_prompt(self, prompt: np.ndarray):
        p = np.asarray(prompt, np.int32)[: self.pad_to]
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
        logits, row = engine.prefill(self.model, self.params, tokens, length,
                                     self.max_len)
        self.pool.assign(slot, row)
        self.n_prefills += 1
        first = int(sampling.greedy(logits)[0])  # the admission's one sync
        req.t_first = self._now()
        req.tokens.append(first)
        state = SlotState(req=req, slot=slot, n_generated=1)
        if state.finished(first, self._eos(req)):
            req.t_done = req.t_first
            self.finished.append(req)
            self.pool.evict(slot)
            return
        self.active[slot] = state
        self._token[slot] = first

    def _admissible(self, req: ServeRequest) -> bool:
        """Pool-side admission gate: one free slot."""
        return self.pool.n_free >= 1

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
            self._admit_one(cand)

    # ---- decode ----------------------------------------------------------
    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """All-greedy pool: one argmax and the step's ONE host sync."""
        return sampling.greedy(logits).cpu().numpy()

    def _record_step_metrics(self) -> None:
        self.n_decode_steps += 1
        self.occupancy_trace.append(self.pool.occupancy)

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
            self._token[slot] = token
            if st.finished(token, self._eos(st.req)):
                st.req.t_done = now
                self.finished.append(st.req)
                done.append(st.req)
                del self.active[slot]
                self.pool.evict(slot)
        return done

    def step(self) -> List[ServeRequest]:
        """One pool-wide decode step; returns the requests it finished."""
        return self._finish_decode(self._begin_decode())

    def _begin_decode(self) -> torch.Tensor:
        """Dispatch the pool-wide decode step (no host sync); its logits."""
        token = torch.from_numpy(self._token).to(self.device)
        logits, cache = engine.decode_step(self.model, self.params, self.pool.cache,
                                           token)
        self.pool.cache = cache
        return logits

    def _finish_decode(self, logits: torch.Tensor) -> List[ServeRequest]:
        """The step's one device-to-host copy plus the host commit."""
        toks = self._sample(logits)
        self._record_step_metrics()
        return self._commit_decode(toks, self._now())

    # ---- run loop --------------------------------------------------------
    @torch.inference_mode()
    def run(self, requests: List[ServeRequest]) -> List[ServeRequest]:
        """Serve ``requests`` to completion; returns them in finish order.
        A request is invisible to admission until ``t0 + t_arrival``."""
        self.submit(requests)
        self._t0 = time.perf_counter()
        while self.waiting or self.active:
            self._admit(self._now())
            if not self.active:
                if self.waiting:  # pool idle, next request not arrived yet
                    wait = self.waiting[0].t_arrival - self._now()
                    if wait > 0:
                        time.sleep(min(wait, 1e-3))
                continue
            self.step()
        return self.finished

    @property
    def mean_occupancy(self) -> float:
        if not self.occupancy_trace:
            return 0.0
        return float(np.mean(self.occupancy_trace))
