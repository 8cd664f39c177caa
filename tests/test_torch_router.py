"""The port's replica router, two-phase step and priority aging against the
JAX package — the port of ``tests/test_router.py`` and of the aging tests in
``tests/test_serve.py`` — on the f32 llama3.2-1b smoke config (2 slots a
pool, pad 8, block 4), params bridged from the reference's init with the
embedding table scaled by 0.1 (so sampled tokens vary: see
``tests/test_torch_sampling.py``).

- ``ReplicaRouter`` against the JAX ``ReplicaRouter`` at 1, 2 and 3
  replicas, on the contiguous pool, a roomy paged pool and a paged pool too
  tight for two full requests (it preempts, and replays land on any
  replica), greedy and at t = 0.8 / top-p 0.9: tokens equal up to a
  reference near tie (top-1/top-2 gap below 1e-4 greedy, perturbed top-two
  gap below 1e-5 sampled), and the host bookkeeping exactly: placements,
  admissions, spills, requeues and each replica's steps, prefills,
  preemptions and occupancy;
- the router against one pool (exact tokens: the same numerics), the
  load-aware spill and the accounting invariants (a dense mirror of every
  free-list each round, exactly-once service, fully freed pools) at fixed
  seeds and under hypothesis, both routers driven by one deterministic
  clock so their placements compare;
- ``age_waiting`` and the starvation trace under a shared deterministic
  clock (the same finish order and boosts as the reference's);
- ``step()`` against ``step_begin`` / ``step_finish`` interleaved over two
  schedulers, for a decode, a mixed and a speculative step;
- ``BatchServer``, ``ServeRequest.padded_output``, ``run_scheduler``'s
  fleet metrics and the launcher's ``--replicas`` / ``--boost-after``
  lines; without a card, ``devices="auto"`` and ``--replicas`` raise."""
import re

import jax
import numpy as np
import pytest
import torch

from repro.core import profiles as jprofiles
from repro.core import router as jrouter
from repro.core import sampling as jsampling
from repro.core.scheduler import Scheduler as JScheduler
from repro.core.scheduler import ServeRequest as JRequest
from repro.core.scheduler import age_waiting as jage_waiting
from repro.launch import serve as jserve
from repro_torch.core import prng, profiles, router, sampling
from repro_torch.core.scheduler import Scheduler, ServeRequest, age_waiting
from repro_torch.launch import serve
from tests._hyp import given, hst, settings
from tests.test_torch_sampling import EMBED_SCALE, assert_sampled_match, bridged_pair
from tests.test_torch_speculative import _gap_at

PAD_TO = 8
MAX_NEW_CAP = 16
SLOTS = 2
BLOCK_SIZE = 4
NEAR_TIE = {False: 1e-4, True: 1e-5}  # greedy, sampled
#: max_len 8 + 16 + 1 = 25 is 7 blocks of 4 a request: 15 usable blocks hold
#: two full requests, 7 do not (the tight pool preempts)
POOLS = {"contiguous": {},
         "paged": dict(paged=True, block_size=BLOCK_SIZE, num_blocks=16),
         "tight": dict(paged=True, block_size=BLOCK_SIZE, num_blocks=8)}
REPLICA_COUNTERS = ("n_decode_steps", "n_prefills", "n_preemptions", "occupancy_trace")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while the module runs: its serving loops are
    many tiny eager ops, which a thread pool only slows beside other test
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return bridged_pair("llama3.2-1b", EMBED_SCALE)


def _traffic(n, seed=0, arrival_rate=0.0, max_new=None):
    """(rid, prompt, max_new, t_arrival) of ``n`` requests, the reference's
    ``_requests`` draws."""
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    for i in range(n):
        if arrival_rate > 0:
            t += rng.exponential(1.0 / arrival_rate)
        prompt = rng.integers(0, 512, size=int(rng.integers(3, PAD_TO + 1)))
        out.append((i, prompt, max_new or int(rng.integers(4, MAX_NEW_CAP + 1)), t))
    return out


def _reqs(cls, traffic, temperature=0.0, top_p=1.0, **kw):
    return [cls(rid=i, prompt=p, max_new=m, t_arrival=t, temperature=temperature,
                top_p=top_p, **kw) for i, p, m, t in traffic]


def _routers(pair, n_replicas, seed=0, clock=None, slots=SLOTS, max_new_cap=MAX_NEW_CAP, **kw):
    jmodel, jparams, model, params = pair
    extra = {} if clock is None else dict(clock=clock)
    geo = dict(replicas=n_replicas, slots=slots, pad_to=PAD_TO, max_new_cap=max_new_cap, **kw)
    jr = jrouter.ReplicaRouter(jmodel, jparams, base_key=jax.random.PRNGKey(seed),
                               devices=[None] * n_replicas, **geo, **extra)
    tr = router.ReplicaRouter(model, params, base_key=prng.PRNGKey(seed),
                              devices=["cpu"] * n_replicas, **geo, **extra)
    return jr, tr


def _assert_tokens(pair, traffic, got, want, temp, seed, what):
    """Each request's port tokens against the reference's: equal up to the
    first divergence, which passes only at a reference near tie."""
    jmodel, jparams, _, _ = pair
    base = jax.random.PRNGKey(seed)
    prompts = {i: p for i, p, _, _ in traffic}
    assert sorted(got) == sorted(want)
    for rid, toks in got.items():
        assert_sampled_match(toks, want[rid],
                             _gap_at(jmodel, jparams, prompts[rid], want[rid], rid, temp, base),
                             f"{what} request {rid}", tie=NEAR_TIE[temp > 0])


def _bookkeeping(r):
    return dict(placements=r.placements, routed=r.n_routed, spills=r.n_spills,
                requeues=r.n_requeues,
                replicas=[{n: getattr(s, n) for n in REPLICA_COUNTERS} for s in r.replicas])


# ------------------------------------------------------- against the JAX router
@pytest.mark.parametrize("temp", [0.0, 0.8])
@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("n_replicas", [1, 2, 3])
def test_router_matches_jax_router(pair, n_replicas, pool, temp):
    """Six requests through both routers: tokens under the near-tie rule,
    the fleet's bookkeeping exactly, every pool drained. On the tight pool
    every request runs to ``MAX_NEW_CAP``, so two on one replica collide."""
    traffic = _traffic(6, seed=3, max_new=MAX_NEW_CAP if pool == "tight" else None)
    jr, tr = _routers(pair, n_replicas, seed=7, **POOLS[pool])
    jdone = jr.run(_reqs(JRequest, traffic, temp, 0.9))
    tdone = tr.run(_reqs(ServeRequest, traffic, temp, 0.9))
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    _assert_tokens(pair, traffic, {r.rid: r.tokens for r in tdone},
                   {r.rid: r.tokens for r in jdone}, temp, 7, f"x{n_replicas} {pool}")
    assert _bookkeeping(tr) == _bookkeeping(jr)
    assert sorted(tr.placements) == list(range(6)) and tr.n_routed >= 6
    if pool == "tight":
        assert tr.n_preemptions >= 1 and tr.n_requeues == tr.n_preemptions
    for s in tr.replicas:
        assert s.pool.n_free == SLOTS and not s.has_work and s.busy_s > 0
        if s.paged:
            assert s.pool.n_free_blocks == s.pool.num_blocks - 1


# ------------------------------------------------------- against one pool
@pytest.mark.parametrize("pool", ["contiguous", "paged"])
@pytest.mark.parametrize("n_replicas", [1, 2, 3])
def test_router_greedy_identical_to_single_pool(pair, n_replicas, pool):
    """Greedy tokens do not depend on the replica count or the pool kind:
    the router schedules, it computes nothing. Same numerics, so exact."""
    _, _, model, params = pair
    traffic = _traffic(6)
    single = Scheduler(model, params, slots=SLOTS, pad_to=PAD_TO, max_new_cap=MAX_NEW_CAP,
                       device="cpu", **POOLS[pool])
    want = {r.rid: r.tokens for r in single.run(_reqs(ServeRequest, traffic))}
    _, tr = _routers(pair, n_replicas, **POOLS[pool])
    got = {r.rid: r.tokens for r in tr.run(_reqs(ServeRequest, traffic))}
    assert got == want
    assert tr.n_routed >= 6 and sorted(tr.placements) == list(range(6))


def test_router_preemption_replay_identical(pair):
    """A tight replica pool preempts mid-decode; the replay, requeued at the
    shared queue's front, lands where there is room and gives the roomy
    single pool's sampled tokens, as the reference's does."""
    jmodel, jparams, model, params = pair
    traffic = _traffic(4, seed=9, max_new=MAX_NEW_CAP)
    single = Scheduler(model, params, slots=SLOTS, pad_to=PAD_TO, max_new_cap=MAX_NEW_CAP,
                       device="cpu", base_key=prng.PRNGKey(9), **POOLS["paged"])
    want = {r.rid: r.tokens for r in single.run(_reqs(ServeRequest, traffic, 0.8, 0.9))}
    jr, tr = _routers(pair, 2, seed=9, **POOLS["tight"])
    got = {r.rid: r.tokens for r in tr.run(_reqs(ServeRequest, traffic, 0.8, 0.9))}
    jdone = jr.run(_reqs(JRequest, traffic, 0.8, 0.9))
    assert tr.n_preemptions >= 1 and tr.n_requeues >= 1
    assert got == want
    assert any(len(p) > 1 for p in tr.placements.values())
    assert _bookkeeping(tr) == _bookkeeping(jr)
    _assert_tokens(pair, traffic, got, {r.rid: r.tokens for r in jdone}, 0.8, 9, "replay")


# ------------------------------------------------------- placement and accounting
class _Tick:
    """A deterministic clock both routers read: ``now`` advances only when
    the loop says so."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _dense_mirror(r) -> None:
    """Each replica's free slots and blocks recounted from its residents
    and tables, the slow way, against the pool's counters."""
    for s in r.replicas:
        resident = len(s.active) + sum(len(g.slots) for g in s.groups.values())
        if s.chunk_mgr is not None:
            resident += len(s.chunk_mgr)
        assert s.pool.n_free == s.pool.slots - resident
        if s.paged:
            held = np.unique(s.pool.block_tables)
            assert s.pool.n_free_blocks == (s.pool.num_blocks - 1) - len(held[held != 0])


def _drive(routers, reqs, tick, check):
    """Both routers' loops by hand in lockstep: place, check, one round,
    reclaim, harvest; the clock advances 1 ms a turn (no sleeping)."""
    for r, rs in zip(routers, reqs):
        r.submit(rs)
        r._t0 = tick()
        for s in r.replicas:
            s.rebase(r._t0)
    turns = 0
    with torch.inference_mode():
        while any(r.waiting or any(s.has_work for s in r.replicas) for r in routers):
            turns += 1
            assert turns < 2000, "router failed to drain"
            for r in routers:
                now = r._now()
                r._place(now)
                check(r, now)
                live = [s for s in r.replicas if s.has_work]
                if live:
                    r._round(live)
                    for s in live:
                        if s.waiting:
                            r._reclaim(s)
                    r._harvest()
            tick.t += 1e-3


def _no_stall(r, now) -> None:
    """Whoever is still queued and arrived is inadmissible everywhere
    (head-of-line blocking only)."""
    _dense_mirror(r)
    _, cand = r._next_candidate(now)
    if cand is not None:
        assert not any(s.admissible(cand) for s in r.replicas)


def test_router_load_aware_placement_and_spill(pair):
    """A long prompt with a long decode pins replica 0's blocks; the short
    requests after it go to replica 1 (most free capacity first), at least
    one admission spills past a refusing top choice, and placement never
    stalls while a replica could admit the head of the queue. Both routers
    place identically."""
    rng = np.random.default_rng(0)
    traffic = [(0, rng.integers(0, 512, 8), MAX_NEW_CAP, 0.0)]
    traffic += [(i, rng.integers(0, 512, 2), 4, 0.0) for i in range(1, 6)]
    tick = _Tick()
    jr, tr = _routers(pair, 2, clock=tick, paged=True, block_size=BLOCK_SIZE, num_blocks=10)
    _drive([jr, tr], [_reqs(JRequest, traffic), _reqs(ServeRequest, traffic)], tick, _no_stall)
    assert tr.placements[0] == [0]
    assert len([rid for rid, p in tr.placements.items() if rid and p[-1] == 1]) >= 2
    assert tr.n_spills >= 1
    assert len(tr.finished) == len(traffic)
    assert _bookkeeping(tr) == _bookkeeping(jr)


def _property_trace(pair, seed: int) -> None:
    """A random trace, pool kind, replica count and block budget through
    both routers under one clock: every round the dense mirror holds and
    nothing stalls; every request is served exactly once (admissions =
    requests + requeues); every pool ends empty; the bookkeeping equals the
    reference's."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 8))
    paged = bool(rng.integers(0, 2))
    n_replicas = int(rng.integers(1, 4))
    pool = dict(paged=True, block_size=BLOCK_SIZE, num_blocks=int(rng.integers(8, 14))) \
        if paged else {}
    traffic = _traffic(n, seed=seed, arrival_rate=float(rng.choice([0.0, 300.0])))
    tick = _Tick()
    jr, tr = _routers(pair, n_replicas, seed=seed, clock=tick, **pool)
    _drive([jr, tr], [_reqs(JRequest, traffic, 0.8, 0.9), _reqs(ServeRequest, traffic, 0.8, 0.9)],
           tick, _no_stall)
    assert sorted(r.rid for r in tr.finished) == list(range(n))
    assert sorted(tr.placements) == list(range(n))
    assert tr.n_routed == n + tr.n_requeues
    for s in tr.replicas:
        assert s.pool.n_free == s.pool.slots
        if s.paged:
            assert s.pool.n_free_blocks == s.pool.num_blocks - 1
    assert _bookkeeping(tr) == _bookkeeping(jr)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_router_accounting_fixed_seeds(pair, seed):
    _property_trace(pair, seed)


@settings(max_examples=4)
@given(seed=hst.integers(4, 2 ** 16))
def test_router_accounting_property(pair, seed):
    _property_trace(pair, seed)


# ------------------------------------------------------- priority aging
def test_age_waiting_matches_jax():
    """One queue through both functions: boosts for every full interval
    waited, none twice at the same instant, none for a future arrival or
    with aging off."""
    def queue(cls):
        return [cls(rid=0, prompt=np.array([1]), max_new=1, t_arrival=0.0),
                cls(rid=1, prompt=np.array([1]), max_new=1, t_arrival=0.04, priority=2),
                cls(rid=2, prompt=np.array([1]), max_new=1, t_arrival=9.0)]

    mine, ref = queue(ServeRequest), queue(JRequest)
    for now, after, granted in ((0.05, None, 0), (0.05, 0.02, 2), (0.05, 0.02, 0),
                                (0.09, 0.02, 4), (0.09, 0.0, 0)):
        assert age_waiting(mine, now, after) == jage_waiting(ref, now, after) == granted
        assert [(r.priority, r.n_boosts) for r in mine] == [(r.priority, r.n_boosts)
                                                             for r in ref]
    assert [r.priority for r in mine] == [4, 4, 0]


def test_aging_prevents_starvation_as_the_reference(pair):
    """A priority-0 request against a stream of priority-2 arrivals 2 ms
    apart, one slot, each scheduler on a clock of 1 ms a program run
    (prefill or step): without aging it finishes last; aged every 2 ms it
    finishes at position 4 or earlier. The port's finish order and boosts
    equal the reference's under the same clock."""
    jmodel, jparams, model, params = pair
    rng = np.random.default_rng(11)
    traffic = [(0, rng.integers(0, 512, size=4), 4, 0.0)]
    traffic += [(i, rng.integers(0, 512, size=4), 4, 0.002 * (i - 1)) for i in range(1, 11)]

    def run(cls, sched_cls, m, p, boost, **kw):
        held = {}

        def clock():
            s = held.get("s")
            return 0.0 if s is None else 1e-3 * (s.n_decode_steps + s.n_prefills)

        s = sched_cls(m, p, slots=1, pad_to=PAD_TO, max_new_cap=4,
                      priority_boost_after=boost, clock=clock, **kw)
        held["s"] = s
        reqs = [cls(rid=i, prompt=pr, max_new=mn, t_arrival=t, priority=0 if i == 0 else 2)
                for i, pr, mn, t in traffic]
        return [r.rid for r in s.run(reqs)], s.n_priority_boosts

    for boost in (None, 0.002):
        got = run(ServeRequest, Scheduler, model, params, boost, device="cpu")
        want = run(JRequest, JScheduler, jmodel, jparams, boost)
        assert got == want
        order, boosts = got
        if boost is None:
            assert order[-1] == 0 and boosts == 0
        else:
            assert order.index(0) <= 4 and boosts > 0


def test_router_ages_at_the_shared_queue(pair):
    """The same starvation trace through one-replica routers under one
    clock: the router's aging gives the reference router's order and
    boosts, and breaks the starvation."""
    rng = np.random.default_rng(11)
    traffic = [(0, rng.integers(0, 512, size=4), 4, 0.0)]
    traffic += [(i, rng.integers(0, 512, size=4), 4, 0.002 * (i - 1)) for i in range(1, 11)]
    tick = _Tick()
    jr, tr = _routers(pair, 1, clock=tick, slots=1, max_new_cap=4, priority_boost_after=0.002)
    reqs = [[cls(rid=i, prompt=pr, max_new=mn, t_arrival=t, priority=0 if i == 0 else 2)
             for i, pr, mn, t in traffic] for cls in (JRequest, ServeRequest)]
    _drive([jr, tr], reqs, tick, lambda r, now: None)
    order = [r.rid for r in tr.finished]
    assert order == [r.rid for r in jr.finished]
    assert tr.n_priority_boosts == jr.n_priority_boosts > 0
    assert order.index(0) < len(order) - 1


# ------------------------------------------------------- the two-phase step
STEP_KINDS = {
    "decode": (dict(), 0.8, None),
    "mixed": (dict(paged=True, chunked=True, block_size=BLOCK_SIZE, num_blocks=16,
                   prefill_budget=4), 0.0, None),
    "speculative": (dict(), 0.8, "spec"),
}


@pytest.mark.parametrize("kind", list(STEP_KINDS))
def test_interleaved_two_phase_steps_equal_step(pair, kind):
    """Two schedulers stepped begin, begin, finish, finish give the tokens
    and counters each gives alone through ``step()`` (exact: the same
    numerics), and the reference's schedulers interleaved so give the same
    counters and, up to a near tie, the same tokens."""
    jmodel, jparams, model, params = pair
    geo, temp, spec = STEP_KINDS[kind]
    traffic = [_traffic(4, seed=20), _traffic(4, seed=21)]

    def reqs(cls, mod, tr):
        kw = {} if spec is None else dict(profile=mod.SpeculativeProfile(
            temperature=temp, top_p=0.9, exit_layer=1, n_draft=3))
        return _reqs(cls, tr, temp, 0.9, **kw)

    def interleave(scheds, rss):
        for s, rs in zip(scheds, rss):
            s.submit(rs)
            s._t0 = s.clock()
        with torch.inference_mode():
            while any(s.waiting or s.has_work for s in scheds):
                for s in scheds:
                    s._admit(s._now())
                pend = [(s, s.step_begin()) for s in scheds if s.has_work]
                for s, p in pend:
                    s.step_finish(p)

    mk = dict(slots=SLOTS, pad_to=PAD_TO, max_new_cap=MAX_NEW_CAP, **geo)
    alone = []
    for tr in traffic:
        s = Scheduler(model, params, device="cpu", base_key=prng.PRNGKey(5), **mk)
        alone.append((s, {r.rid: r.tokens for r in s.run(reqs(ServeRequest, profiles, tr))}))
    both = [Scheduler(model, params, device="cpu", base_key=prng.PRNGKey(5), **mk)
            for _ in traffic]
    interleave(both, [reqs(ServeRequest, profiles, tr) for tr in traffic])
    jboth = [JScheduler(jmodel, jparams, base_key=jax.random.PRNGKey(5), **mk) for _ in traffic]
    interleave(jboth, [reqs(JRequest, jprofiles, tr) for tr in traffic])
    names = ("n_decode_steps", "n_prefills", "n_mixed_steps", "n_chunks", "n_spec_steps",
             "n_spec_accepted", "n_preemptions", "occupancy_trace")
    for (s1, want), s2, js, tr in zip(alone, both, jboth, traffic):
        got = {r.rid: r.tokens for r in s2.finished}
        assert got == want
        for n in names:
            assert getattr(s2, n) == getattr(s1, n) == getattr(js, n), n
        _assert_tokens(pair, tr, got, {r.rid: r.tokens for r in js.finished}, temp, 5, kind)
        assert s2.busy_s > 0
    if kind == "mixed":
        assert both[0].n_mixed_steps >= 1
    if kind == "speculative":
        assert both[0].n_spec_steps >= 1


# ------------------------------------------------------- launcher and entry points
def test_batch_server_matches_jax(pair):
    """Five requests through two-slot fixed batches (the last one partial,
    its dead row masked): greedy and nucleus-sampled outputs equal the
    reference's ``BatchServer``'s."""
    jmodel, jparams, model, params = pair
    traffic = _traffic(5, seed=4)
    for jsamp, samp in ((jsampling.greedy, sampling.greedy),
                        (jsampling.top_p(0.9, 0.8), sampling.top_p(0.9, 0.8))):
        want = jserve.BatchServer(jmodel, jparams, slots=2, sampler=jsamp).serve(
            [jserve.Request(rid=i, prompt=p, max_new=m) for i, p, m, _ in traffic],
            pad_to=PAD_TO, max_new=MAX_NEW_CAP)
        got = serve.BatchServer(model, params, slots=2, sampler=samp).serve(
            [serve.Request(rid=i, prompt=p, max_new=m) for i, p, m, _ in traffic],
            pad_to=PAD_TO, max_new=MAX_NEW_CAP)
        assert [r.rid for r in got] == [r.rid for r in want]
        for g, w in zip(got, want):
            assert g.output.shape == (g.max_new,) and g.t_done is not None
            np.testing.assert_array_equal(g.output, np.asarray(w.output))


def test_padded_output_matches_jax():
    for eos in (None, 7):
        mine = ServeRequest(rid=0, prompt=np.arange(3), max_new=6, tokens=[4, 5])
        ref = JRequest(rid=0, prompt=np.arange(3), max_new=6, tokens=[4, 5])
        np.testing.assert_array_equal(mine.padded_output(eos), np.asarray(ref.padded_output(eos)))


def test_run_scheduler_fleet_metrics_match_jax(pair):
    """``run_scheduler(replicas=2)``: every metric the reference reports
    (the per-class rows, the fleet's spills, requeues, busy-max rate and
    per-replica entries); the counts equal the reference's, aging on."""
    jmodel, jparams, model, params = pair
    traffic = _traffic(4, seed=2)
    kw = dict(slots=SLOTS, pad_to=PAD_TO, max_new_cap=MAX_NEW_CAP, replicas=2,
              priority_boost_after=10.0, paged=True, block_size=BLOCK_SIZE, num_blocks=16)
    jm = jserve.run_scheduler(jmodel, jparams, _reqs(JRequest, traffic), devices=[None, None],
                              **kw)
    m = serve.run_scheduler(model, params, _reqs(ServeRequest, traffic), device="cpu", **kw)
    assert set(jm) <= set(m)
    for k in ("n_requests", "total_tokens", "replicas", "decode_steps", "steps_max",
              "prefills", "spills", "requeues", "n_preemptions", "priority_boosts"):
        assert m[k] == jm[k], k
    assert [set(e) for e in m["per_replica"]] == [set(e) for e in jm["per_replica"]]
    assert m["aggregate_tokens_per_s"] > 0 and m["busy_max_s"] > 0
    assert m["leaked_blocks"] == 0 and m["device"] == "cpu"
    assert [e["device"] for e in m["per_replica"]] == ["cpu", "cpu"]


def test_serve_main_replicas_on_cpu_prints_fleet_lines(capsys):
    m = serve.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--n-requests", "4",
                    "--batch-slots", "2", "--max-new", "4", "--replicas", "2",
                    "--boost-after", "0.05"])
    out = capsys.readouterr().out
    assert re.search(r"\[serve/continuous\+x2\] 4 requests in .* tok/s", out)
    assert re.search(r"\[serve/continuous\+x2\] priority boosts=\d+", out)
    assert re.search(r"spills=\d+ \| requeues=\d+ \| steps max=\d+ \| aggregate=", out)
    assert len(re.findall(r"\[serve/continuous\+x2\]   replica \d: ", out)) == 2
    assert m["replicas"] == 2 and len(m["per_replica"]) == 2


def test_no_card_no_fallback(pair):
    """Without a card ``devices='auto'`` and ``--replicas`` raise unless the
    CPU is asked for, a tensor-parallel fleet's too."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the refusal is for hosts without one")
    _, _, model, params = pair
    geo = dict(slots=SLOTS, pad_to=PAD_TO, max_new_cap=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        router.ReplicaRouter(model, params, replicas=2, **geo)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "llama3.2-1b", "--smoke", "--replicas", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        router.ReplicaRouter(model, params, replicas=2, tp=2, **geo)
    with pytest.raises(ValueError):
        router.ReplicaRouter(model, params, replicas=0, devices=[], **geo)
    with pytest.raises(ValueError):
        router.ReplicaRouter(model, params, replicas=2, devices=["cpu"], **geo)


def test_replica_devices_and_placement():
    """Round-robin over the given devices (the reference's
    ``replica_devices``), and params already on a replica's device are
    shared, not copied."""
    devs = ["cpu", "meta", "cpu"]
    assert router._replica_devices(5, devs) == [torch.device(d) for d in devs + devs[:2]]
    with pytest.raises(ValueError):
        router._replica_devices(2, [])
    tree = {"w": torch.ones(2, 2), "layers": [{"b": torch.zeros(3)}]}
    assert router._place_replica(tree, torch.device("cpu")) is tree
    moved = router._place_replica(tree, torch.device("meta"))
    assert moved["w"].device.type == "meta" and moved["layers"][0]["b"].device.type == "meta"
