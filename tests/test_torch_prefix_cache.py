"""The port's cross-request prefix cache against the JAX package
(``core/prefix_cache.py`` and the scheduler's ``prefix_cache=True``, f32
llama3.2-1b smoke params bridged from the reference's ``init(PRNGKey(0))``,
traces from a numpy seed).

- The trie on a refcount-only pool: the match cap that always leaves a
  suffix token, insert's dedup and refcount handoff, least recently used
  leaf-first reclaim that stops at slot-held blocks, reset; and one op
  sequence through the port's and the reference's tries, every result and
  every refcount equal.
- Serving: warm tokens equal cold ones exactly at t = 0 and t = 0.8 (keys
  are per request, stream and token index), through preemption replay under
  tight blocks; reclaim relieves block pressure; zero new device bytes; on
  ``shared_prefix_trace`` the hits, lookups, skipped tokens, reclaimed
  blocks, preemptions, steps and chunks equal the JAX scheduler's, and the
  tokens its tokens.
- The launcher: ``shared_prefix_trace`` field for field against the
  reference's, and the CLI with ``--prefix-cache --shared-prefix 2``."""
import collections
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.prefix_cache import PrefixCache as JPrefixCache
from repro.core.scheduler import Scheduler as JScheduler
from repro.core.scheduler import ServeRequest as JRequest
from repro.launch import serve as jserve
from repro_torch.core.prefix_cache import PrefixCache
from repro_torch.core.scheduler import Scheduler, ServeRequest
from repro_torch.launch import serve
from tests.test_torch_groups import _bridged

BS = 4  # the trie's and the pools' block size


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while the module runs (many tiny eager ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def llama():
    return _bridged("llama3.2-1b")


class _FakePool:
    """Refcounts only: the surface the trie calls (``cache_ref``,
    ``cache_unref``, ``is_sole_cached_ref``); extra counts stand for slots
    that adopted a block."""

    def __init__(self):
        self.ref = collections.Counter()

    def cache_ref(self, phys):
        self.ref[phys] += 1

    def cache_unref(self, phys):
        self.ref[phys] -= 1
        assert self.ref[phys] >= 0

    def is_sole_cached_ref(self, phys):
        return self.ref[phys] == 1


def _prompt(*tokens):
    return np.asarray(tokens, np.int32)


# ------------------------------------------------------------ trie units
def test_match_always_leaves_a_suffix_token():
    cache, pool = PrefixCache(BS), _FakePool()
    p8 = _prompt(*range(8))
    assert cache.insert(p8, [10, 11], pool) == 2
    assert cache.match(p8) == [10]  # cap (8 - 1) // 4 = 1
    assert cache.match(_prompt(*range(8), 99)) == [10, 11]
    assert cache.match(_prompt(*range(4))) == []  # one block: cap 0
    assert cache.match(_prompt(0, 1, 2, 3, 7, 7, 7, 7, 9)) == [10]


def test_insert_dedup_keeps_incumbent_block():
    cache, pool = PrefixCache(BS), _FakePool()
    p = _prompt(*range(8), 1)
    assert cache.insert(p, [10, 11], pool) == 2
    # a twin (or a replay re-inserting the blocks it adopted) is a no-op
    assert cache.insert(p, [20, 21], pool) == 0
    assert cache.match(p) == [10, 11]
    assert pool.ref[10] == pool.ref[11] == 1 and pool.ref[20] == pool.ref[21] == 0
    q = _prompt(0, 1, 2, 3, 8, 8, 8, 8, 1)
    assert cache.insert(q, [10, 30], pool) == 1  # only the diverging span is new
    assert len(cache) == 3 and pool.ref[30] == 1


def test_reclaim_is_lru_and_leaf_first():
    cache, pool = PrefixCache(BS), _FakePool()
    chain, lone = _prompt(*range(8), 1), _prompt(*range(50, 54), 1)
    cache.insert(chain, [1, 2], pool)
    cache.insert(lone, [3], pool)
    cache.match(chain)  # the chain is now the most recently used
    assert cache.reclaim(pool, 1) == 1
    assert pool.ref[3] == 0 and cache.match(lone) == []
    assert cache.reclaim(pool, 2) == 2  # leaf 2 first exposes 1
    assert pool.ref[1] == pool.ref[2] == 0 and len(cache) == 0


def test_reclaim_skips_slot_referenced_blocks():
    cache, pool = PrefixCache(BS), _FakePool()
    cache.insert(_prompt(*range(8), 1), [1, 2], pool)
    pool.ref[2] += 1  # a slot adopted the leaf (and so pins its root path)
    assert cache.reclaim(pool, 5) == 0 and len(cache) == 2
    pool.ref[2] -= 1
    assert cache.reclaim(pool, 5) == 2
    assert len(cache) == 0 and cache.n_reclaimed_blocks == 2


def test_reset_releases_every_cached_block():
    cache, pool = PrefixCache(BS), _FakePool()
    cache.insert(_prompt(*range(12), 1), [1, 2, 3], pool)
    cache.insert(_prompt(*range(40, 44), 1), [4], pool)
    assert len(cache) == 4
    cache.reset(pool)
    assert len(cache) == 0 and all(v == 0 for v in pool.ref.values())


@pytest.mark.parametrize("seed", [0, 1])
def test_trie_op_sequence_matches_reference(seed):
    """Random inserts, matches, pins and reclaims through both tries: every
    return value, length, counter and refcount equal after every op."""
    rng = np.random.default_rng(seed)
    mine, ref = PrefixCache(BS), JPrefixCache(BS)
    pools = (_FakePool(), _FakePool())
    stems = [rng.integers(0, 4, size=3 * BS) for _ in range(3)]
    next_block = 1
    for _ in range(40):
        op = int(rng.integers(0, 4))
        stem = stems[int(rng.integers(0, 3))]
        prompt = np.concatenate([stem[:int(rng.integers(1, 3 * BS + 1))],
                                 rng.integers(0, 4, size=int(rng.integers(0, 3)))])
        if op == 0:
            n = len(prompt) // BS
            blocks = list(range(next_block, next_block + n))
            next_block += n
            got = (mine.insert(prompt, blocks, pools[0]), ref.insert(prompt, blocks, pools[1]))
        elif op == 1:
            got = (mine.match(prompt), ref.match(prompt))
        elif op == 2:  # a slot adopts (or lets go of) whatever matched
            delta = 1 if rng.random() < 0.5 else -1
            for pool, trie in zip(pools, (mine, ref)):
                for b in trie.match(prompt):
                    if pool.ref[b] + delta >= 1:
                        pool.ref[b] += delta
            got = (0, 0)
        else:
            k = int(rng.integers(1, 4))
            got = (mine.reclaim(pools[0], k), ref.reclaim(pools[1], k))
        assert got[0] == got[1]
        assert len(mine) == len(ref) and mine.n_inserted_blocks == ref.n_inserted_blocks
        assert mine.n_reclaimed_blocks == ref.n_reclaimed_blocks
        assert +pools[0].ref == +pools[1].ref


# ------------------------------------------------------------ serving
def _sched(model, params, *, prefix_cache, num_blocks, pad_to, slots=2):
    return Scheduler(model, params, slots=slots, pad_to=pad_to, max_new_cap=6, device="cpu",
                     paged=True, block_size=BS, num_blocks=num_blocks, chunked=True,
                     prefill_budget=8, prefix_cache=prefix_cache)


def _shared_trace(vocab, *, pad_to, n=6, seed=3, temperature=0.0):
    """n requests sharing a 2-block prefix, each with its own suffix."""
    r = np.random.default_rng(seed)
    shared = r.integers(0, vocab, size=2 * BS)
    return [ServeRequest(rid=i, prompt=np.concatenate(
                [shared, r.integers(0, vocab, size=pad_to - 2 * BS)]),
                max_new=int(r.integers(2, 7)), temperature=temperature,
                top_p=0.9 if temperature else 1.0)
            for i in range(n)]


def _tokens(done):
    return {d.rid: list(d.tokens) for d in done}


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_warm_hits_are_token_identical_to_cold(llama, temperature):
    _, _, model, params = llama
    vocab, pad_to = model.config.vocab_size, 12
    cold = _sched(model, params, prefix_cache=False, num_blocks=24, pad_to=pad_to)
    ref = _tokens(cold.run(_shared_trace(vocab, pad_to=pad_to, temperature=temperature)))
    warm = _sched(model, params, prefix_cache=True, num_blocks=24, pad_to=pad_to)
    reserved = warm.pool.reserved_bytes
    warm.run(_shared_trace(vocab, pad_to=pad_to, temperature=temperature))  # fills the trie
    got = _tokens(warm.run(_shared_trace(vocab, pad_to=pad_to, temperature=temperature)))
    assert got == ref, "cache hits must give the cold prefill's tokens"
    assert warm.n_prefix_hits >= 6 and warm.n_prefix_tokens_skipped >= 6 * 2 * BS
    assert warm.pool.reserved_bytes == reserved == cold.pool.reserved_bytes


def test_preemption_replay_stays_identical_under_tight_blocks(llama):
    """Growth preempts warm requests, whose replay may adopt the very
    blocks they inserted before: the tokens stay the cache-less arm's."""
    _, _, model, params = llama
    vocab, pad_to, nb = model.config.vocab_size, 16, 10

    def trace():
        return _shared_trace(vocab, pad_to=pad_to, n=6, seed=5, temperature=0.8)

    cold = _sched(model, params, prefix_cache=False, num_blocks=nb, pad_to=pad_to)
    ref = _tokens(cold.run(trace()))
    warm = _sched(model, params, prefix_cache=True, num_blocks=nb, pad_to=pad_to)
    warm.run(trace())
    assert _tokens(warm.run(trace())) == ref
    assert warm.n_preemptions > 0, "the geometry must preempt"


def test_reclaim_relieves_block_pressure(llama):
    """Distinct prompts fill the trie with blocks nobody reads; later
    admissions reclaim them least recently used first and every request
    completes; every block is free, owned or cached, exactly once."""
    _, _, model, params = llama
    vocab, pad_to, nb = model.config.vocab_size, 12, 14
    r = np.random.default_rng(9)

    def batch(rids):
        return [ServeRequest(rid=i, prompt=r.integers(0, vocab, size=pad_to), max_new=3)
                for i in rids]

    sched = _sched(model, params, prefix_cache=True, num_blocks=nb, pad_to=pad_to)
    assert len(sched.run(batch(range(4)))) == 4
    assert sched.pool.n_reclaimable_blocks > 0
    done = [d for d in sched.run(batch(range(4, 8))) if d.rid >= 4]
    assert len(done) == 4 and all(len(d.tokens) == 3 for d in done)
    assert sched.n_prefix_reclaimed > 0
    pool = sched.pool
    assert pool.n_cached_blocks == len(sched._pcache)
    assert pool.n_used_blocks == pool.n_cached_blocks  # nothing owned at the end


def test_shared_prefix_trace_hits_match_jax_scheduler(llama):
    """``shared_prefix_trace`` (bursty, Zipf prefixes) through both packages'
    chunked schedulers with the prefix cache, under a pool tight enough to
    reclaim: the same hits, lookups, tokens skipped, reclaims, preemptions,
    steps, mixed steps and chunks, and the same tokens."""
    jmodel, jparams, model, params = llama
    kw = dict(n_prefixes=3, prefix_len=8, pad_to=14, max_new_cap=5,
              vocab_size=model.config.vocab_size, arrival_rate=0.0, seed=2)
    trace = serve.shared_prefix_trace(10, **kw)
    geometry = dict(slots=3, pad_to=14, max_new_cap=5, paged=True, block_size=BS,
                    num_blocks=12, chunked=True, prefill_budget=6, prefix_cache=True)
    mine = Scheduler(model, params, device="cpu", **geometry)
    jref = JScheduler(jmodel, jparams, **geometry)
    got = _tokens(mine.run([dataclasses.replace(r) for r in trace]))
    want = _tokens(jref.run([JRequest(rid=r.rid, prompt=r.prompt, max_new=r.max_new)
                             for r in trace]))
    assert got == {k: [int(t) for t in v] for k, v in want.items()}

    def counters(s):
        return (s.n_prefix_lookups, s.n_prefix_hits, s.n_prefix_tokens_skipped,
                s.n_prefix_reclaimed, s.n_preemptions, s.n_decode_steps, s.n_mixed_steps,
                s.n_chunks, s.pool.n_cached_blocks, s.cached_block_trace)

    assert counters(mine) == counters(jref)
    assert mine.n_prefix_hits >= 1 and mine.n_prefix_reclaimed >= 1 and mine.n_preemptions >= 1
    assert mine.prefix_hit_rate == pytest.approx(jref.prefix_hit_rate)
    assert mine.mean_cached_blocks == pytest.approx(jref.mean_cached_blocks)


# ------------------------------------------------------------ launcher
def test_shared_prefix_trace_matches_reference():
    kw = dict(n_prefixes=3, prefix_len=16, pad_to=40, max_new_cap=8, vocab_size=300,
              arrival_rate=25.0, zipf_a=1.3, burst_size=3, seed=4, temperature=0.7,
              top_p=0.95)
    mine, ref = serve.shared_prefix_trace(12, **kw), jserve.shared_prefix_trace(12, **kw)
    for a, b in zip(mine, ref):
        assert (a.rid, a.max_new, a.t_arrival, a.temperature, a.top_p) == (
            b.rid, b.max_new, b.t_arrival, b.temperature, b.top_p)
        np.testing.assert_array_equal(a.prompt, b.prompt)
    for bad in (dict(prefix_len=40), dict(n_prefixes=0)):
        with pytest.raises(ValueError):
            serve.shared_prefix_trace(2, **{**kw, **bad})


def test_serve_cli_prefix_cache_on_cpu(capsys):
    m = serve.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--n-requests",
                    "8", "--batch-slots", "4", "--max-new", "4", "--paged", "--chunked",
                    "--block-size", "16", "--prefix-cache", "--shared-prefix", "2",
                    "--prefix-len", "32"])
    out = capsys.readouterr().out
    assert "prefix hits=" in out and "prefill tokens skipped=" in out
    assert m["prefix_lookups"] == 8 and m["prefix_hits"] >= 1
    assert m["prefill_tokens_skipped"] == 32 * m["prefix_hits"]
    assert m["leaked_blocks"] == 0 and m["full_prefills"] == 0
    with pytest.raises(SystemExit):  # the reference's flag rules
        serve.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--paged",
                    "--prefix-cache"])
