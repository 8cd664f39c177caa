"""Port's chunked prefill against the JAX package: the chunk packer, the
mixed step and the chunked scheduler, and ``benchmarks/BENCH_serve.json``'s
workload replayed through both packages.

- ``ChunkedPrefill.plan`` / ``advance`` / ``remove`` against
  ``repro.core.prefill`` on the same cursors, decode lanes and block-starved
  ``skip`` sets: every plan (lane tokens, ``t_new``, chunk spans) identical;
- ``engine.mixed_step`` against the reference's on one paged pool whose
  device counters drifted: last-lane logits at f32 tolerance (atol 2e-5,
  rtol 2e-4), ``lengths`` pinned and advanced by ``t_new``;
- ``Scheduler(paged=True, chunked=True)`` against the JAX scheduler with
  every arrival at t = 0: tokens under the near-tie rule, and preemptions,
  decode, mixed and chunk counts and peak used blocks exactly; mid-prefill
  preemption replay and late admission into a drifted slot;
- the benchmark workload (llama3.2-1b smoke, ``seamless_s2t``, seed 0, 24
  requests, 4 slots, block 16, 14 blocks, ``pad_to`` 16, ``max_new_cap``
  64, budget 4, 200 requests/s): its arrivals run on each package's wall
  clock, so only tokens are compared; the port's chunked and unchunked
  paged runs agree as the reference's ``chunked_vs_paged`` does."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import prefill as jprefill
from repro.core.scheduler import Scheduler as JScheduler
from repro.core.scheduler import ServeRequest as JRequest
from repro.launch import serve as jserve
from repro_torch.core import engine
from repro_torch.core.prefill import ChunkCursor, ChunkedPrefill
from repro_torch.core.scheduler import Scheduler, ServeRequest
from repro_torch.launch import serve
from tests._hyp import given, hst, settings
from tests.test_torch_paged import one_torch_thread, pair, run_both  # noqa: F401 (fixtures)
from tests.test_torch_serve import _ref_gap, assert_tokens_match

PAD_TO = 8


# -------------------------------------------------------------- the packer
def _drive_packers(slots, budget, prompt_lens, seed):
    """Both packers through one random schedule of decode lanes and skip
    sets until every cursor drains; every plan must be identical."""
    rng = np.random.default_rng(seed)
    mine, ref = ChunkedPrefill(slots, budget), jprefill.ChunkedPrefill(slots, budget)
    prompts = {}
    for i, n in enumerate(prompt_lens):
        prompts[i] = rng.integers(1, 1000, size=n).astype(np.int32)
        mine.add(ChunkCursor(req=None, slot=i, prompt=prompts[i], admit_seq=i))
        ref.add(jprefill.ChunkCursor(req=None, slot=i, prompt=prompts[i], admit_seq=i))
    covered = {i: 0 for i in prompts}
    for _ in range(sum(prompt_lens) + slots + 10):
        if not len(ref):
            break
        decode_tokens = rng.integers(0, 1000, size=slots).astype(np.int32)
        free = [s for s in range(slots) if s not in ref.cursors]
        decode = [s for s in free if rng.random() < 0.5]
        pending = list(ref.cursors)
        skip = [s for s in pending if rng.random() < 0.3] if len(pending) > 1 else []
        got = mine.plan(decode_tokens, decode, skip=skip)
        want = ref.plan(decode_tokens, decode, skip=skip)
        np.testing.assert_array_equal(got.tokens, want.tokens)
        np.testing.assert_array_equal(got.t_new, want.t_new)
        assert [(c.slot, c.start, c.t) for c in got.chunks] == [
            (c.slot, c.start, c.t) for c in want.chunks]
        assert sum(c.t for c in got.chunks) <= budget
        for gc, wc in zip(got.chunks, want.chunks):
            assert gc.start == covered[gc.slot], "chunk spans must be contiguous"
            covered[gc.slot] += gc.t
            a, b = mine.advance(gc), ref.advance(wc)
            assert (a.pos, a.done) == (b.pos, b.done)
            if a.done:
                mine.remove(gc.slot)
                ref.remove(wc.slot)
        assert list(mine.cursors) == list(ref.cursors)
    assert not len(mine) and not len(ref), "packer failed to drain"
    assert covered == {i: len(p) for i, p in prompts.items()}


@pytest.mark.parametrize("slots,budget,lens,seed", [
    (3, 4, [5, 1, 9], 0),  # partial final chunks and a one-token prompt
    (2, 16, [16, 3], 1),  # one-shot chunk and budget sharing
    (4, 3, [7, 7, 7, 7], 2),  # budget contention, FIFO drain
])
def test_packer_fixed_sequences_match_jax(slots, budget, lens, seed):
    _drive_packers(slots, budget, lens, seed)


@settings(max_examples=20, deadline=None)
@given(hst.integers(min_value=1, max_value=17),
       hst.lists(hst.integers(min_value=1, max_value=23), min_size=1, max_size=4),
       hst.integers(min_value=0, max_value=2**31 - 1))
def test_packer_property_matches_jax(budget, lens, seed):
    _drive_packers(len(lens), budget, lens, seed)


def test_packer_skip_redistributes_budget():
    """A block-starved head cursor must not hoard the budget: its share goes
    to the next cursor, decode lanes keep lane 0."""
    mgr = ChunkedPrefill(3, 4)
    mgr.add(ChunkCursor(req=None, slot=0, prompt=np.arange(1, 9), admit_seq=0))
    mgr.add(ChunkCursor(req=None, slot=2, prompt=np.arange(1, 7), admit_seq=1))
    plan = mgr.plan(np.asarray([0, 9, 0], np.int32), decode_slots=[1], skip=[0])
    assert [(c.slot, c.start, c.t) for c in plan.chunks] == [(2, 0, 4)]
    np.testing.assert_array_equal(plan.t_new, [0, 1, 4])
    assert plan.tokens[1, 0] == 9


def test_cursor_rejects_empty_prompt():
    with pytest.raises(ValueError):
        ChunkCursor(req=None, slot=0, prompt=np.zeros((0,), np.int32))


# ---------------------------------------------------------- mixed step
def test_mixed_step_matches_jax_on_drifted_pool(pair):  # noqa: F811
    """A decode row, a chunk row and an idle row over one paged pool whose
    device counters drifted: the host base wins, the last-lane logits
    match the reference's, and ``lengths`` ends at base + t_new."""
    jmodel, jparams, model, params = pair
    kw = dict(slots=3, pad_to=PAD_TO, max_new_cap=4, paged=True, block_size=4,
              num_blocks=13, chunked=True)
    js = JScheduler(jmodel, jparams, **kw)
    ts = Scheduler(model, params, device="cpu", **kw)
    rng = np.random.default_rng(5)
    for slot, n in ((0, 3), (1, 4)):  # blocks for the rows' write spans
        for pool in (js.pool, ts.pool):
            assert pool.acquire() == slot and pool.ensure(slot, n)
    for i, layer in enumerate(ts.pool.cache["layers"]):
        for key in ("k", "v"):  # prior K/V the decode row attends to
            vals = rng.normal(size=tuple(layer[key].shape)).astype(np.float32)
            layer[key].copy_(torch.from_numpy(vals))
            js.pool.cache["layers"][i][key] = jnp.asarray(vals)
    js.pool.cache["lengths"] = jnp.asarray([9, 8, 7], jnp.int32)
    ts.pool.cache["lengths"] = torch.tensor([9, 8, 7], dtype=torch.int32)
    js.pool.sync()
    ts.pool.sync()
    tokens = rng.integers(0, 512, size=(3, 4)).astype(np.int32)
    t_new = np.array([1, 3, 0], np.int32)
    base = np.array([3, 2, 0], np.int32)
    jl, jcache = jengine.mixed_step(jmodel, jparams, js.pool.cache, jnp.asarray(tokens),
                                    jnp.asarray(t_new), jnp.asarray(base))
    lengths_before = ts.pool.cache["lengths"]
    tl, tcache = engine.mixed_step(model, params, ts.pool.cache, torch.from_numpy(tokens),
                                   torch.from_numpy(t_new), torch.from_numpy(base))
    assert tuple(tl.shape) == (3, model.config.vocab_size)
    assert lengths_before.tolist() == [3, 2, 0]  # pinned in place
    np.testing.assert_array_equal(tcache["lengths"].numpy(), [4, 5, 0])
    np.testing.assert_array_equal(np.asarray(jcache["lengths"]), [4, 5, 0])
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], atol=2e-5, rtol=2e-4)


# ------------------------------------------------------ chunked scheduler
def _traffic(seed, n, max_news, size=None):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 512, size=size or int(rng.integers(3, PAD_TO + 1))),
             max_news[i % len(max_news)]) for i in range(n)]


@pytest.mark.parametrize("budget,nb,size", [
    (3, 12, None),  # budget 3 across block size 4: chunks cross block edges
    (4, 8, PAD_TO),  # 7 usable blocks: exhaustion, preemption and recovery
    (8, 8, None),  # one-shot chunks under pressure
])
def test_chunked_scheduler_matches_jax_scheduler(pair, budget, nb, size):  # noqa: F811
    ts = run_both(pair, _traffic(3, 6, [16, 5, 12, 9], size=size), slots=2, pad_to=PAD_TO,
                  max_new_cap=16, paged=True, block_size=4, num_blocks=nb, chunked=True,
                  prefill_budget=budget)
    assert ts.n_prefills == 0 and ts.n_mixed_steps > 0
    if nb == 8 and size:
        assert ts.n_preemptions >= 1


def _ref_tokens(pair, traffic):  # noqa: F811
    """Each request's tokens from the JAX contiguous scheduler."""
    jmodel, jparams, _, _ = pair
    js = JScheduler(jmodel, jparams, slots=2, pad_to=PAD_TO, max_new_cap=16)
    return {r.rid: r.tokens for r in js.run([JRequest(rid=i, prompt=p, max_new=m)
                                             for i, p, m in traffic])}


def _check_tokens(pair, traffic, done):  # noqa: F811
    jmodel, jparams, _, _ = pair
    want = _ref_tokens(pair, traffic)
    assert sorted(r.rid for r in done) == sorted(want)
    for r in done:
        assert_tokens_match(
            r.tokens, want[r.rid],
            lambda k, p=traffic[r.rid][1], w=want[r.rid]: _ref_gap(jmodel, jparams, p, w[:k]),
            f"request {r.rid}")


def test_chunked_mid_prefill_preemption_replays(pair):  # noqa: F811
    """A half-prefilled request preempted mid-stream replays from chunk zero
    and still emits the reference's tokens."""
    _, _, model, params = pair
    traffic = _traffic(3, 3, [6], size=PAD_TO)
    sched = Scheduler(model, params, slots=2, pad_to=PAD_TO, max_new_cap=16, device="cpu",
                      paged=True, block_size=4, num_blocks=12, chunked=True,
                      prefill_budget=4)
    sched.submit([ServeRequest(rid=i, prompt=p, max_new=m) for i, p, m in traffic])
    sched._t0 = 0.0
    sched._admit(0.0)
    sched.step()  # the first chunk lands (4 of 8 prompt tokens)
    slot, cur = next(iter(sched.chunk_mgr.cursors.items()))
    assert 0 < cur.pos < cur.n_prompt
    sched._preempt(cur)
    assert sched.n_preemptions == 1 and slot not in sched.chunk_mgr.cursors
    assert sched.waiting[0] is cur.req  # requeued at the front
    while sched.waiting or sched.has_work:
        sched._admit(sched._now())
        sched.step()
    _check_tokens(pair, traffic, sched.finished)


def test_chunked_late_admission_into_drifted_slot(pair):  # noqa: F811
    """Plain decode steps drift a freed slot's device counter; a request
    admitted there later must still write its chunks at 0: every mixed step
    pins each row's counter to the host's (decode kv length, cursor
    position, 0 for free rows)."""
    _, _, model, params = pair
    rng = np.random.default_rng(7)
    traffic = [(0, rng.integers(0, 512, size=6), 2), (1, rng.integers(0, 512, size=6), 12),
               (2, rng.integers(0, 512, size=7), 6)]
    reqs = [ServeRequest(rid=i, prompt=p, max_new=m) for i, p, m in traffic]
    sched = Scheduler(model, params, slots=2, pad_to=PAD_TO, max_new_cap=16, device="cpu",
                      paged=True, block_size=4, num_blocks=12, chunked=True)
    sched.submit(reqs[:2])
    sched._t0 = 0.0
    sched._admit(0.0)
    while not any(r.rid == 0 for r in sched.finished):
        sched.step()  # drain request 0; request 1 keeps decoding
    for _ in range(3):
        sched.step()  # no cursor: plain decode steps drift the freed row
    sched.submit(reqs[2:])
    sched._admit(sched._now())
    slot = next(iter(sched.chunk_mgr.cursors))
    assert int(sched.pool.cache["lengths"][slot]) > 0, "the freed row should have drifted"
    while sched.waiting or sched.has_work:
        sched._admit(sched._now())
        mixed = sched.n_mixed_steps
        sched.step()
        if sched.n_mixed_steps > mixed:
            lengths = sched.pool.cache["lengths"]
            for s, cur in sched.chunk_mgr.cursors.items():
                assert int(lengths[s]) == cur.pos
            for s, st in sched.active.items():
                assert int(lengths[s]) == st.kv_len
    _check_tokens(pair, traffic, sched.finished)


def test_scheduler_rejects_bad_chunked_geometry(pair):  # noqa: F811
    _, _, model, params = pair
    kw = dict(slots=2, pad_to=PAD_TO, max_new_cap=4, device="cpu")
    with pytest.raises(ValueError):
        Scheduler(model, params, chunked=True, **kw)
    with pytest.raises(ValueError):
        Scheduler(model, params, paged=True, chunked=True, policy="fixed", **kw)


# ------------------------------------------------ the benchmark workload
def test_bench_serve_workload_through_both_packages(pair):  # noqa: F811
    """``BENCH_serve.json``'s paged and chunked arms through both packages
    (tokens only: arrivals follow each run's own clock); within the port
    the chunked run gives the unchunked paged run's tokens."""
    jmodel, jparams, model, params = pair
    w = dict(pad_to=16, max_new_cap=64, arrival_rate=200.0, seed=0)
    geo = dict(slots=4, pad_to=16, max_new_cap=64, paged=True, block_size=16, num_blocks=14)
    arms = {"paged": {}, "chunked": dict(chunked=True, prefill_budget=4)}
    prof = serve.data_mod.PAPER_PROFILES["seamless_s2t"]
    jprof = jserve.data_mod.PAPER_PROFILES["seamless_s2t"]
    traces = {}
    toks, jtoks = {}, {}
    for arm, extra in arms.items():
        jreqs = jserve.poisson_trace(jprof, 24, vocab_size=512, **w)
        _, jdone = jserve.run_scheduler(jmodel, jparams, jreqs, **geo, **extra,
                                        return_requests=True)
        reqs = serve.poisson_trace(prof, 24, vocab_size=512, **w)
        traces[arm] = {r.rid: r.prompt for r in reqs}
        m, done = serve.run_scheduler(model, params, reqs, device="cpu", **geo, **extra,
                                      return_requests=True)
        assert m["n_requests"] == 24 and m["leaked_blocks"] == 0
        if arm == "chunked":
            assert m["full_prefills"] == 0 and m["mixed_steps"] > 0
        toks[arm] = {r.rid: r.tokens for r in done}
        jtoks[arm] = {r.rid: r.tokens for r in jdone}
    assert sum(len(t) for t in toks["paged"].values()) == sum(
        len(t) for t in jtoks["paged"].values())

    def gap(prompt, prefix):
        return _ref_gap(jmodel, jparams, prompt, prefix)

    for arm in arms:
        for rid, want in jtoks[arm].items():
            assert_tokens_match(toks[arm][rid], want,
                                lambda k, p=traces[arm][rid], w=want: gap(p, w[:k]),
                                f"{arm} request {rid}")
    for rid, want in toks["paged"].items():
        assert_tokens_match(toks["chunked"][rid], want,
                            lambda k, p=traces["paged"][rid], w=want: gap(p, w[:k]),
                            f"chunked vs paged request {rid}")
