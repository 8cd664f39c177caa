"""ReplicaRouter: data-parallel scheduler pools behind one shared queue — the
port of ``repro/core/router.py``, with its DP x TP fleet (``tp > 1``: each
replica a tensor-parallel pool on its own device group,
``sharding.replica_devices(group_size=tp)``).

The router owns N ``Scheduler`` pools of one geometry (contiguous or paged,
chunked or not) and places each arrived request on one of them:

- **route by free capacity**: the replica with the most free blocks (paged)
  or free slots (contiguous) is offered the request first, the lowest
  replica id breaking ties;
- **spill on back-pressure**: a replica whose admission gate refuses
  (``Scheduler.try_admit``) passes the request down the ranking to the first
  replica that takes it (``n_spills``);
- **head-of-line blocking**: when no replica can take the highest-priority
  arrived request, placement stops, as one pool's admission does;
- **requeue at the front on preemption**: after every round the requests a
  replica preempted onto its own queue go back to the front of the shared
  queue (``n_requeues``), so a replay may land on any replica.

Every token is sampled under a key folded from (request id, stream, token
index) into the one ``base_key`` all replicas share, so a request's tokens
do not depend on its replica, its batch mates or its preemptions.

A round launches every live replica's step (``step_begin``) before it waits
for any (``step_finish``): the begin copies nothing synchronously, so one
replica's host work overlaps the device work already queued for another.
Replicas on one card share its default stream, so their kernels run one
after another on the device. ``busy_s`` counts each replica's own admission
and step time, and ``busy_max_s`` the busiest: with one card per replica it
would bound the fleet's wall. On one shared card a replica's finish also
waits for the kernels queued before its own, so there it emulates such a
fleet and measures none.

The DP x TP fleet runs SPMD on the ``tp`` processes of ``tp_pool.spawn``:
process r holds rank r of every replica (``Scheduler(tp=TPContext)``, its
collectives on a group of the replica's own, ``tp_pool.replica_group``) and
the host state of all of them, and runs this same loop. The router's clock
is rank 0's (``TPGroup.shared_clock``), as each replica's is, so every
process places every request alike and all enter the same collectives in
the same order. A TP step waits on its collectives, so a round's begins
overlap nothing there; ``busy_s`` a replica then includes the wait on its
other ranks.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis.hotpath import hot_path
from repro_torch.core import prng
from repro_torch.core.kv_cache import _map, leaves
from repro_torch.core.scheduler import Scheduler, ServeRequest, age_waiting
from repro_torch.distributed import sharding, tp_pool


def _replica_devices(n: int, devices: Optional[Sequence[Any]] = None) -> List[torch.device]:
    """One device per replica: ``sharding.replica_devices`` over ``devices``
    (default: every CUDA card), as torch devices."""
    return [torch.device(d) for d in sharding.replica_devices(n, devices)]


def _place_replica(tree: Any, device: torch.device) -> Any:
    """``tree`` (params) on ``device``: the same object when every tensor is
    there already (replicas on one card share one copy of the weights),
    else a copy."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if all(t.device == device for t in leaves(tree) if isinstance(t, torch.Tensor)):
        return tree
    return _map(lambda t: t.to(device) if isinstance(t, torch.Tensor) else t, tree)


class ReplicaRouter:
    """N data-parallel ``Scheduler`` pools behind one shared queue.

    ``devices="auto"`` places replica ``i`` on ``cuda:{i % n_cards}`` with
    its own copy of the params when the host has more than one card, and
    every replica on ``cuda:0`` with the one params object otherwise; it
    raises without a card (no fallback). An explicit list gives each
    replica its device (the tests pass ``["cpu"] * n``). All replicas share
    ``base_key``: the tokens' independence of placement depends on it.

    ``tp > 1`` makes each replica a tensor-parallel pool of ``tp`` ranks;
    this process is rank ``group.rank`` of every one (``group``: its
    ``TPGroup`` from ``tp_pool.spawn``, of ``tp`` ranks), and ``model`` /
    ``params`` are the whole model's. ``devices`` is then one ``tp``-sized
    tuple a replica (``"auto"``: ``sharding.replica_devices(replicas,
    group_size=tp)`` over the cards, whole groups round-robin); replicas on
    one group share this rank's shard."""

    def __init__(
        self,
        model,
        params,
        *,
        replicas: int,
        slots: int,
        pad_to: int,
        max_new_cap: int,
        eos_id: Optional[int] = None,
        paged: bool = False,
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        chunked: bool = False,
        prefill_budget: Optional[int] = None,
        prefix_cache: bool = False,
        priority_boost_after: Optional[float] = None,
        base_key: Optional[torch.Tensor] = None,
        clock=time.perf_counter,
        devices: Any = "auto",
        tp: Optional[int] = None,
        group: Optional[tp_pool.TPGroup] = None,
    ):
        if replicas < 1:
            raise ValueError(f"need at least one replica, got {replicas}")
        self.tp = tp if tp is not None and tp > 1 else None
        if isinstance(devices, str) and devices == "auto":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "ReplicaRouter(devices='auto'): no CUDA device is available (pass "
                    "devices=['cpu'] * replicas to serve on the CPU)")
            if self.tp is not None:  # whole groups; raises without one tp-sized group
                devices = sharding.replica_devices(replicas, group_size=self.tp)
            elif torch.cuda.device_count() > 1:
                devices = _replica_devices(replicas)
            else:
                devices = [torch.device("cuda", 0)] * replicas
        if len(devices) != replicas:
            raise ValueError(f"{replicas} replicas need {replicas} devices, got {len(devices)}")
        base_key = prng.PRNGKey(0) if base_key is None else base_key
        # aging happens at the SHARED queue (a replica's own queue holds
        # only preemption replays between rounds), so the router owns it
        self.priority_boost_after = priority_boost_after
        self.n_priority_boosts = 0
        geometry = dict(
            slots=slots, pad_to=pad_to, max_new_cap=max_new_cap, eos_id=eos_id, paged=paged,
            block_size=block_size, num_blocks=num_blocks, chunked=chunked,
            prefill_budget=prefill_budget,
            # each replica's own trie: its cached blocks live in its pool
            prefix_cache=prefix_cache,
            base_key=base_key,  # shared: tokens must not depend on placement
            clock=clock)
        self.replicas: List[Scheduler] = []
        if self.tp is None:
            self.devices = [torch.device(d) for d in devices]
            self.clock = clock
            self.replicas = [
                Scheduler(model, _place_replica(params, dev), device=dev, replica_id=i,
                          **geometry)
                for i, dev in enumerate(self.devices)]
        else:
            tp_pool.check_supported(model.config, self.tp)  # before any group forms
            if group is None or group.size != self.tp:
                raise ValueError(f"tp={self.tp} replicas need this rank's TPGroup of "
                                 f"{self.tp} ranks, got {group}")
            self.devices = [tuple(torch.device(d) for d in g) for g in devices]
            # every process places on rank 0's clock; each replica's scheduler
            # wraps the raw clock in its own group's broadcast
            self.clock = group.shared_clock(clock)
            shards: Dict[tuple, tp_pool.TPContext] = {}
            for i, devs in enumerate(self.devices):
                g = tp_pool.replica_group(group, devs, i)
                ctx = shards[devs].on_group(g) if devs in shards else tp_pool.TPContext(
                    model, params, g)
                shards.setdefault(devs, ctx)
                self.replicas.append(Scheduler(model, None, tp=ctx, replica_id=i, **geometry))
        self.waiting: Deque[ServeRequest] = deque()
        self.finished: List[ServeRequest] = []
        # rid -> every replica that admitted it (a replay after a preemption
        # appends; the last entry finished it)
        self.placements: Dict[int, List[int]] = {}
        self.n_routed = 0  # admissions (more than the requests when some replay)
        self.n_spills = 0  # admitted by a replica other than the top choice
        self.n_requeues = 0  # preempted requests returned to the shared queue
        self._t0 = self.clock()

    def _now(self) -> float:
        return self.clock() - self._t0

    # ---- shared queue ----------------------------------------------------
    def submit(self, requests: List[ServeRequest]) -> None:
        """Validate and enqueue onto the shared queue, in arrival order and
        higher priority first within an arrival instant (one pool's order).
        The replicas share one geometry, so replica 0 validates for all."""
        for r in sorted(requests, key=lambda r: (r.t_arrival, -r.priority)):
            self.waiting.append(self.replicas[0].normalize(r))

    def _next_candidate(self, now: float):
        """(index, request) of the highest-priority arrived request, the
        leftmost on a tie: ``Scheduler._next_candidate``'s rule, so routed
        admissions come in one pool's order."""
        best_i, best = None, None
        for i, r in enumerate(self.waiting):
            if r.t_arrival > now:
                break
            if best is None or r.priority > best.priority:
                best_i, best = i, r
        return best_i, best

    # ---- placement -------------------------------------------------------
    def _ranked(self) -> List[int]:
        """Replica ids, most free capacity first, the lowest id on a tie."""
        return sorted(range(len(self.replicas)),
                      key=lambda i: (-self.replicas[i].free_capacity(), i))

    def _place(self, now: float) -> None:
        """Admit arrived requests until the queue drains or the
        highest-priority one fits on no replica (head-of-line blocking).
        Never between a round's begins and finishes: a finish commits for
        the residents its begin launched for."""
        self.n_priority_boosts += age_waiting(self.waiting, now, self.priority_boost_after)
        while True:
            i, cand = self._next_candidate(now)
            if cand is None:
                return
            placed = None
            for rank, rep in enumerate(self._ranked()):
                if self.replicas[rep].try_admit(cand, now):
                    placed = (rank, rep)
                    break
            if placed is None:
                return  # back-pressure everywhere: a step must free room
            del self.waiting[i]
            rank, rep = placed
            self.n_routed += 1
            if rank > 0:
                self.n_spills += 1
            self.placements.setdefault(cand.rid, []).append(rep)

    def _reclaim(self, sched: Scheduler) -> None:
        """Move the requests ``sched`` preempted onto its own queue to the
        front of the shared queue, their order kept."""
        pre = sched.drain_waiting()
        for req in reversed(pre):
            self.waiting.appendleft(req)
        self.n_requeues += len(pre)

    def _harvest(self) -> None:
        for sched in self.replicas:
            self.finished.extend(sched.drain_finished())

    # ---- stepping --------------------------------------------------------
    @hot_path
    def _round(self, live: Sequence[Scheduler]) -> None:
        """One fleet round: every live replica's step launched, then each
        one waited for and committed."""
        pendings = [(s, s.step_begin()) for s in live]
        for s, pending in pendings:
            s.step_finish(pending)

    @torch.inference_mode()
    def run(self, requests: List[ServeRequest]) -> List[ServeRequest]:
        """Serve ``requests`` across the fleet; returns them in harvest
        order. Every replica takes the router's clock origin, so their
        timestamps compare."""
        self.submit(requests)
        self._t0 = self.clock()
        for s in self.replicas:
            s.rebase(self._t0)
        while self.waiting or any(s.has_work for s in self.replicas):
            self._place(self._now())
            live = [s for s in self.replicas if s.has_work]
            if not live:
                if self.waiting:  # fleet idle, the next arrival is ahead
                    wait = self.waiting[0].t_arrival - self._now()
                    if wait > 0:
                        time.sleep(min(wait, 1e-3))
                continue
            self._round(live)
            for s in live:
                if s.waiting:
                    self._reclaim(s)
            self._harvest()
        return self.finished

    # ---- merged metrics --------------------------------------------------
    def _sum(self, name: str):
        return sum(getattr(s, name) for s in self.replicas)

    @property
    def n_decode_steps(self) -> int:
        return self._sum("n_decode_steps")

    @property
    def n_prefills(self) -> int:
        return self._sum("n_prefills")

    @property
    def n_preemptions(self) -> int:
        return self._sum("n_preemptions")

    @property
    def n_mixed_steps(self) -> int:
        return self._sum("n_mixed_steps")

    @property
    def reserved_bytes(self) -> int:
        """The fleet's KV pools, a TP replica's counted once whole."""
        return sum(s.pool.reserved_bytes if s.tp is None else s.tp.whole_bytes(s.pool.cache)
                   for s in self.replicas)

    @property
    def n_prefix_lookups(self) -> int:
        return self._sum("n_prefix_lookups")

    @property
    def n_prefix_hits(self) -> int:
        return self._sum("n_prefix_hits")

    @property
    def n_prefix_tokens_skipped(self) -> int:
        return self._sum("n_prefix_tokens_skipped")

    @property
    def prefix_hit_rate(self) -> float:
        return self.n_prefix_hits / max(self.n_prefix_lookups, 1)

    @property
    def n_prefix_reclaimed(self) -> int:
        return self._sum("n_prefix_reclaimed")

    @property
    def mean_cached_blocks(self) -> float:
        return float(np.mean([s.mean_cached_blocks for s in self.replicas]))

    @property
    def mean_occupancy(self) -> float:
        occ = [s.mean_occupancy for s in self.replicas if s.occupancy_trace]
        return float(np.mean(occ)) if occ else 0.0

    @property
    def admission_stalls(self) -> List[float]:
        return [x for s in self.replicas for x in s.admission_stalls]

    @property
    def busy_max_s(self) -> float:
        """The busiest replica's own seconds: the fleet's wall if each
        replica had a card of its own."""
        return max(s.busy_s for s in self.replicas)

    @property
    def steps_max(self) -> int:
        """The most pool steps one replica ran: ``busy_max_s``'s
        deterministic twin (every replica runs the same step shapes)."""
        return max(s.n_decode_steps for s in self.replicas)

    def replica_report(self, done: Optional[List[ServeRequest]] = None) -> List[Dict[str, Any]]:
        """Each replica's requests, steps, prefills, preemptions, busy
        seconds and occupancy. A request counts for the replica that
        finished it (its last placement); with the run's ``done`` list each
        entry adds its TTFT and TPOT percentiles and its tokens per busy
        second."""
        by_rep: Dict[int, List[ServeRequest]] = {i: [] for i in range(len(self.replicas))}
        for r in done or []:
            path = self.placements.get(r.rid)
            if path:
                by_rep[path[-1]].append(r)
        served = {i: 0 for i in range(len(self.replicas))}
        for path in self.placements.values():
            served[path[-1]] += 1
        out = []
        for s, dev in zip(self.replicas, self.devices):
            e: Dict[str, Any] = {
                "replica": s.replica_id,
                # a TP replica's group, one device a rank
                "device": str(dev) if self.tp is None else ",".join(map(str, dev)),
                "n_requests": served[s.replica_id],
                "decode_steps": s.n_decode_steps,
                "prefills": s.n_prefills,
                "preemptions": s.n_preemptions,
                "busy_s": s.busy_s,
                "mean_slot_occupancy": s.mean_occupancy,
            }
            if done is not None:
                rs = by_rep[s.replica_id]
                ttft = [r.ttft for r in rs]
                tpot = [r.tpot for r in rs if len(r.tokens) > 1]
                e.update(
                    ttft_p50_ms=float(np.percentile(ttft, 50)) * 1e3 if ttft else 0.0,
                    ttft_p99_ms=float(np.percentile(ttft, 99)) * 1e3 if ttft else 0.0,
                    tpot_p50_ms=float(np.percentile(tpot, 50)) * 1e3 if tpot else 0.0,
                    tokens_per_s_busy=sum(len(r.tokens) for r in rs) / max(s.busy_s, 1e-9),
                )
            out.append(e)
        return out
