"""The port's slot groups against the JAX package: beam and contrastive
requests served by the scheduler as groups of slots, on the contiguous pool
and on the paged one (f32 smoke configs, params bridged from the
reference's ``init(PRNGKey(0))``; prompts, frames and op sequences from a
numpy seed).

- ``BlockPool``'s refcounted sharing: one op sequence (assign, share,
  ``ensure_writable``, pool-wide writes, ``permute_group``, evict, the prefix
  cache's insert / adopt / reclaim) runs on the port's pool, on a dense
  mirror and on the reference's pool: tables, free-lists, refcounts, cached
  flags and ``n_cow_copies`` equal after every op, every changed K/V
  position a live target or the sink block 0, every read through the table
  the mirror's.
- Beam groups: whisper-smoke, two concurrent 4-beam requests with their own
  frames on the contiguous pool, against the JAX scheduler (tokens exact,
  scores within 1e-4: XLA's and PyTorch's ``exp``/``log`` round apart, row
  gathers equal) and the port's ``generate_beam``; llama-smoke beams on the
  paged pool against the JAX scheduler (tokens, score within 1e-4, table
  permutations and copy-on-write copies exact, no row gather, no new device
  buffer, the pool drained).
- Contrastive groups on both pools (chameleon-smoke, image mask) against
  ``generate_contrastive``; group preemption replay and a mixed
  greedy / beam / contrastive / speculative trace under a tight pool; the
  group feasibility checks and slot-placement-independent stream keys.
- The launcher: ``mix_class_trace`` and ``request_class`` / ``per_class``
  against the reference's, and the CLI serving a profile mix."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_CONFIGS
from repro.core import profiles as jprofiles
from repro.core.prefix_cache import PrefixCache as JPrefixCache
from repro.core.scheduler import Scheduler as JScheduler
from repro.core.scheduler import ServeRequest as JRequest
from repro.core.slot_pool import BlockPool as JBlockPool
from repro.launch import serve as jserve
from repro.models import attention as JA
from repro.models import get_model as jget_model
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core import engine, profiles, sampling
from repro_torch.core.prefix_cache import PrefixCache
from repro_torch.core.scheduler import Scheduler, ServeRequest
from repro_torch.core.slot_pool import BlockPool
from repro_torch.launch import serve
from repro_torch.models import attention as A
from repro_torch.models import get_model
from tests.test_torch_paged import _FakeModel, _JFakeModel, _rows

PAD_TO = 8
SCORE_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while the module runs: its serving loops are many
    tiny eager ops, which a thread pool only slows beside other test
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bridged(arch):
    jcfg = SMOKE_CONFIGS[arch].replace(dtype="float32")
    jmodel = jget_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = get_smoke_config(arch).replace(dtype="float32")
    tparams = bridge.params_to_torch(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, get_model(tcfg), tparams


@pytest.fixture(scope="module")
def llama():
    return _bridged("llama3.2-1b")


def _jprofile(p):
    """The reference's profile of the same kind and fields."""
    if p is None:
        return None
    if isinstance(p, profiles.BeamProfile):
        return jprofiles.BeamProfile(n_beams=p.n_beams, eos_id=p.eos_id)
    if isinstance(p, profiles.ContrastiveProfile):
        return jprofiles.ContrastiveProfile(uncond_token=p.uncond_token, guidance=p.guidance,
                                            mask_offset=p.mask_offset)
    return jprofiles.SpeculativeProfile(temperature=p.temperature, top_p=p.top_p,
                                        exit_layer=p.exit_layer, n_draft=p.n_draft)


def _both_run(pair, reqs, **geometry):
    """Serve fresh copies of ``reqs`` on the port's and the reference's
    scheduler of one geometry; returns both schedulers and their requests by
    rid."""
    jmodel, jparams, model, params = pair
    mine = Scheduler(model, params, device="cpu", **geometry)
    ref = JScheduler(jmodel, jparams, **geometry)
    got = mine.run([dataclasses.replace(r, tokens=[], t_tokens=[]) for r in reqs])
    want = ref.run([JRequest(rid=r.rid, prompt=r.prompt, max_new=r.max_new,
                             t_arrival=r.t_arrival, temperature=r.temperature, top_p=r.top_p,
                             profile=_jprofile(r.profile), extra_inputs=r.extra_inputs)
                    for r in reqs])
    return mine, ref, {r.rid: r for r in got}, {r.rid: r for r in want}


def _same_requests(got, want):
    assert sorted(got) == sorted(want)
    for rid, r in got.items():
        assert r.tokens == [int(t) for t in want[rid].tokens], f"request {rid}"
        if want[rid].score is None:
            assert r.score is None
        else:
            assert abs(r.score - want[rid].score) <= SCORE_TOL, f"request {rid}"


def _counters(s):
    return (s.n_preemptions, s.n_decode_steps, s.n_mixed_steps, s.n_chunks, s.n_prefills,
            s.n_group_admissions, s.n_cache_reorders, s.n_block_permutes,
            getattr(s.pool, "n_cow_copies", None))


# ------------------------------------------ block sharing, three ways
class _Pools:
    """The port's and the reference's ``BlockPool`` (and each one's prefix
    cache) driven by one op sequence, with a dense mirror of every live
    slot's logical K/V."""

    SLOTS, MAX_LEN, BS, NB = 4, 12, 4, 14

    def __init__(self):
        kw = dict(block_size=self.BS, num_blocks=self.NB)
        self.pool = BlockPool(_FakeModel(), self.SLOTS, self.MAX_LEN, "cpu", **kw)
        self.ref = JBlockPool(_JFakeModel(), self.SLOTS, self.MAX_LEN, **kw)
        self.trie, self.jtrie = PrefixCache(self.BS), JPrefixCache(self.BS)
        self.dense = np.zeros((self.SLOTS, self.pool.max_blocks * self.BS, 1, 2), np.float32)
        self.kv_len = {}  # live slot -> tokens written

    def both(self, name, *args):
        got, want = getattr(self.pool, name)(*args), getattr(self.ref, name)(*args)
        assert got == want, f"{name}{args}: {got} vs the reference's {want}"
        return got

    def write(self, rng):
        """A pool-wide decode write at every live slot's ``kv_len`` (free
        slots at 0: their table rows send it to the sink block)."""
        lengths = np.zeros((self.SLOTS,), np.int32)
        for s, n in self.kv_len.items():
            lengths[s] = n
        new = rng.normal(size=(self.SLOTS, 1, 2)).astype(np.float32)
        for p in (self.pool, self.ref):
            p.sync()
        k = self.pool.cache["layers"][0]["k"]
        before = k.clone()
        A.paged_write_token(k, torch.from_numpy(new), self.pool.cache["block_tables"],
                            torch.from_numpy(lengths))
        layer = self.ref.cache["layers"][0]
        layer["k"] = JA.paged_write_token(layer["k"], jnp.asarray(new),
                                          self.ref.cache["block_tables"], jnp.asarray(lengths))
        changed = (k != before).any(-1).any(-1).nonzero().tolist()
        allowed = {(int(self.pool.block_tables[s, n // self.BS]), n % self.BS)
                   for s, n in self.kv_len.items()}
        stray = [tuple(c) for c in changed if c[0] != 0 and tuple(c) not in allowed]
        assert not stray, f"writes outside live targets and the sink block: {stray}"
        for s, n in self.kv_len.items():
            self.dense[s, n] = new[s]
            self.kv_len[s] = n + 1

    def check(self):
        pool, ref = self.pool, self.ref
        np.testing.assert_array_equal(pool.block_tables, ref.block_tables)
        assert pool._free_blocks == ref._free_blocks and pool._free == ref._free
        np.testing.assert_array_equal(pool._ref, np.asarray(ref._ref))
        np.testing.assert_array_equal(pool._cached, np.asarray(ref._cached))
        assert pool.n_cow_copies == ref.n_cow_copies
        assert (pool.n_cached_blocks, pool.n_reclaimable_blocks) == (
            ref.n_cached_blocks, ref.n_reclaimable_blocks)
        assert len(self.trie) == len(self.jtrie)
        holders = np.zeros((pool.num_blocks,), np.int32)
        for s in range(self.SLOTS):
            for b in pool.owned_blocks(s):
                assert b != 0, "sink block handed out"
                holders[b] += 1
        holders += pool._cached
        np.testing.assert_array_equal(holders, pool._ref)
        assert sorted(pool._free_blocks) == [
            b for b in range(1, pool.num_blocks) if holders[b] == 0]
        pool.sync()
        gathered = A.paged_gather(pool.cache["layers"][0]["k"],
                                  pool.cache["block_tables"]).numpy()
        for s, n in self.kv_len.items():
            np.testing.assert_array_equal(gathered[s, :n], self.dense[s, :n])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_block_sharing_matches_reference_and_mirror(seed):
    """A 3-beam group beside a single: share, copy-on-write, writes and
    random permutations; then the group's prompt blocks go to both prefix
    caches, a new slot adopts them, and reclaim drains the pool."""
    rng = np.random.default_rng(seed)
    pools = _Pools()
    bs = pools.BS
    n_prompt = int(rng.integers(bs + 1, 2 * bs))  # the write cursor in a shared block
    k = rng.normal(size=(1, pools.MAX_LEN, 1, 2)).astype(np.float32)
    trow, jrow = _rows(k, n_prompt)
    group = [pools.both("acquire") for _ in range(3)]
    pools.pool.assign(group[0], trow, n_prompt)
    pools.ref.assign(group[0], jrow, n_prompt)
    for s in group[1:]:
        pools.both("share", s, group[0])
    assert pools.pool.n_used_blocks == pools.pool.blocks_for(n_prompt)  # copy-free
    single = pools.both("acquire")
    pools.pool.assign(single, trow, 3)
    pools.ref.assign(single, jrow, 3)
    for s in group:
        pools.dense[s, :n_prompt] = k[0, :n_prompt]
        pools.kv_len[s] = n_prompt
    pools.dense[single, :3] = k[0, :3]
    pools.kv_len[single] = 3
    pools.check()
    for _ in range(pools.MAX_LEN - n_prompt - 1):
        for s in group:
            assert pools.both("ensure_writable", s, pools.kv_len[s])
        assert pools.both("ensure", single, pools.kv_len[single])
        pools.check()
        pools.write(rng)
        perm = rng.integers(0, len(group), size=len(group))
        pools.both("permute_group", group, perm)
        pools.dense[group] = pools.dense[[group[p] for p in perm]]
        pools.check()
    assert pools.pool.n_cow_copies >= 1
    # the group's stream 0 hands its full blocks to both tries, then the
    # whole group and the single leave
    n_full = pools.kv_len[group[0]] // bs
    tokens = rng.integers(0, 50, size=pools.kv_len[group[0]])
    assert pools.trie.insert(tokens, pools.pool.owned_blocks(group[0])[:n_full],
                             pools.pool) == pools.jtrie.insert(
        tokens, pools.ref.owned_blocks(group[0])[:n_full], pools.ref) == n_full
    kept = pools.dense[group[0], :n_full * bs].copy()
    for s in group + [single]:
        pools.both("evict", s)
        del pools.kv_len[s]
    pools.check()
    # a new slot adopts the cached span (the match leaves one token)
    blocks = pools.trie.match(tokens)
    assert blocks == pools.jtrie.match(tokens) and len(blocks) >= 1
    slot = pools.both("acquire")
    pools.both("adopt", slot, blocks, len(blocks) * bs)
    pools.dense[slot, :len(blocks) * bs] = kept[:len(blocks) * bs]
    pools.kv_len[slot] = len(blocks) * bs
    pools.check()
    pools.both("evict", slot)
    del pools.kv_len[slot]
    assert all(pools.both("is_sole_cached_ref", b) for b in blocks)
    assert pools.trie.reclaim(pools.pool, 99) == pools.jtrie.reclaim(pools.ref, 99) == n_full
    pools.check()
    assert sorted(pools.pool._free_blocks) == list(range(1, pools.NB))
    assert not pools.pool._ref.any() and not pools.pool._cached.any()


def test_copy_block_copies_every_leaf_in_place():
    pool = BlockPool(_FakeModel(), 2, 8, "cpu", block_size=4, num_blocks=5)
    layer = pool.cache["layers"][0]
    for x in (layer["k"], layer["v"]):
        x.copy_(torch.arange(x.numel(), dtype=x.dtype).reshape(x.shape))
    ptrs = [layer["k"].data_ptr(), layer["v"].data_ptr()]
    before = [layer["k"].clone(), layer["v"].clone()]
    from repro_torch.core import kv_cache

    kv_cache.copy_block(pool.cache["layers"], 3, 1)
    for x, b in zip((layer["k"], layer["v"]), before):
        assert torch.equal(x[1], b[3])
        assert torch.equal(x[[0, 2, 3, 4]], b[[0, 2, 3, 4]])
    assert [layer["k"].data_ptr(), layer["v"].data_ptr()] == ptrs


# ---------------------------------------------------------- beam groups
def test_beam_groups_whisper_match_jax_scheduler_and_generate_beam():
    """Two concurrent 4-beam enc-dec requests on the contiguous pool, each
    with its own frames in its slots' cross rows: the reference scheduler's
    tokens, scores and row gathers, and the port's batch ``generate_beam``."""
    pair = _bridged("whisper-base")
    _, _, model, params = pair
    cfg = model.config
    rng = np.random.default_rng(1)
    frames = rng.standard_normal((2, cfg.encdec.n_frames, cfg.d_model)).astype(np.float32)
    flens = np.asarray([cfg.encdec.n_frames - 9, cfg.encdec.n_frames], np.int32)
    reqs = [ServeRequest(rid=i, prompt=np.asarray([1]), max_new=8,
                         profile=profiles.BeamProfile(n_beams=4, eos_id=2),
                         extra_inputs={"frames": frames[i:i + 1],
                                       "frame_lengths": flens[i:i + 1]})
            for i in range(2)]
    mine, ref, got, want = _both_run(pair, reqs, slots=8, pad_to=4, max_new_cap=8)
    _same_requests(got, want)
    assert mine.n_cache_reorders == ref.n_cache_reorders >= 1
    assert _counters(mine)[:6] == _counters(ref)[:6]
    batch = engine.generate_beam(model, params, batch=2, n_beams=4, bos_id=1, eos_id=2,
                                 max_new_tokens=8,
                                 extra_inputs={"frames": torch.from_numpy(frames),
                                               "frame_lengths": torch.from_numpy(flens)})
    for i, r in got.items():
        assert r.tokens == batch["tokens"][i, :len(r.tokens)].tolist()
        assert abs(r.score - float(batch["scores"][i])) <= SCORE_TOL


def test_paged_beam_group_permutes_tables_as_the_reference(llama):
    """Paged beams: the reorder is a host table permutation plus
    copy-on-write copies, as many of each as the reference takes; no row
    gather, no new device buffer, and every block home at the end."""
    _, _, model, _ = llama
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, model.config.vocab_size, size=5)
    req = ServeRequest(rid=0, prompt=prompt, max_new=10,
                       profile=profiles.BeamProfile(n_beams=3, eos_id=2))
    geometry = dict(slots=3, pad_to=PAD_TO, max_new_cap=10, paged=True, block_size=4,
                    num_blocks=22)
    reserved = BlockPool(model, 3, PAD_TO + 11, "cpu", block_size=4,
                         num_blocks=22).reserved_bytes
    mine, ref, got, want = _both_run(llama, [req], **geometry)
    _same_requests(got, want)
    assert mine.n_cache_reorders == 0 and mine.n_block_permutes >= 1
    assert _counters(mine) == _counters(ref)
    assert mine.pool.reserved_bytes == reserved
    assert sorted(mine.pool._free_blocks) == list(range(1, 22))
    assert not mine.pool._ref.any()
    batch = engine.generate_beam(model, llama[3], n_beams=3, eos_id=2, max_new_tokens=10,
                                 prompt_tokens=torch.from_numpy(prompt[None]))
    assert got[0].tokens == batch["tokens"][0, :len(got[0].tokens)].tolist()


# --------------------------------------------------- contrastive groups
@pytest.fixture(scope="module")
def chameleon():
    return _bridged("chameleon-34b")


@pytest.mark.parametrize("paged", [False, True])
def test_contrastive_group_respects_image_mask(chameleon, paged):
    """A VLM contrastive pair on either pool: only image-range tokens, and
    ``generate_contrastive``'s tokens exactly."""
    from repro_torch.models import vlm

    _, _, model, params = chameleon
    off = vlm.image_token_offset(model.config)
    prompt = np.random.default_rng(0).integers(0, off, size=5)
    want = engine.generate_contrastive(model, params, torch.from_numpy(prompt[None]),
                                       uncond_token=0, n_image_tokens=6, guidance=3.0)
    sched = Scheduler(model, params, slots=2, pad_to=PAD_TO, max_new_cap=6, device="cpu",
                      paged=paged, block_size=4, num_blocks=22 if paged else None)
    done = sched.run([ServeRequest(
        rid=0, prompt=prompt, max_new=6,
        profile=profiles.ContrastiveProfile(uncond_token=0, guidance=3.0, mask_offset=off))])
    assert done[0].tokens == want["tokens"][0].tolist()
    assert all(t >= off for t in done[0].tokens)
    assert sched.n_prefills == 2  # cond and uncond prefill apart
    if paged:
        assert sched.pool.n_used_blocks == 0 and sched.pool.n_cow_copies == 0


# ------------------------------------------------- preemption and mixes
def _preempt_trace(vocab):
    rng = np.random.default_rng(4)
    beam = profiles.BeamProfile(n_beams=2, eos_id=2)
    sizes = [6, 8, 5, 7]
    return [ServeRequest(rid=i, prompt=rng.integers(0, vocab, size=n), max_new=12,
                         profile=dataclasses.replace(beam) if i % 2 == 0 else None)
            for i, n in enumerate(sizes)]


def test_group_preemption_replay_matches_jax(llama):
    """A block-starved chunked pool preempts whole groups and replays them:
    its tokens and scores equal a roomy pool's (which never preempts) and
    the reference scheduler's, with the reference's preemptions, steps,
    mixed steps, chunks, table permutations and copy-on-write copies."""
    _, _, model, params = llama
    trace = _preempt_trace(model.config.vocab_size)
    # max_len 21, block 4: max_blocks 6, a 2-beam group may need 12 blocks;
    # 13 usable blocks serve one group alone but preempt under concurrency
    geometry = dict(slots=6, pad_to=PAD_TO, max_new_cap=12, paged=True, block_size=4,
                    chunked=True, prefill_budget=4)
    mine, ref, got, want = _both_run(llama, trace, num_blocks=14, **geometry)
    _same_requests(got, want)
    assert mine.n_preemptions >= 1
    assert _counters(mine) == _counters(ref)
    roomy = Scheduler(model, params, device="cpu", num_blocks=41, **geometry)
    done = {r.rid: r for r in roomy.run(
        [dataclasses.replace(r, tokens=[], t_tokens=[]) for r in trace])}
    assert roomy.n_preemptions == 0
    assert {i: (r.tokens, r.score) for i, r in done.items()} == {
        i: (r.tokens, r.score) for i, r in got.items()}


def test_mixed_profile_trace_tight_pool(llama):
    """greedy / beam / contrastive / speculative cycled over a Poisson trace
    through the paged, chunked pool under a tight block budget: groups
    admit, decode, preempt and replay beside chunk cursors, and every
    request gives its batch engine's tokens (a speculative request its plain
    greedy tokens, stepped plainly while a group is resident)."""
    _, _, model, params = llama
    cfg = model.config
    reqs = serve.poisson_trace(serve.data_mod.PAPER_PROFILES["seamless_s2t"], 8,
                               pad_to=PAD_TO, max_new_cap=10, vocab_size=cfg.vocab_size,
                               arrival_rate=300.0, seed=11)
    serve.apply_profile_mix(reqs, "greedy,beam,contrastive,speculative", n_beams=2,
                            beam_eos_id=2, guidance=2.0, exit_layer=1, n_draft=3)
    # max_len 19, block 4: max_blocks 5; a 2-beam group needs <= 10 of 12
    sched = Scheduler(model, params, slots=5, pad_to=PAD_TO, max_new_cap=10, device="cpu",
                      paged=True, block_size=4, num_blocks=13, chunked=True,
                      prefill_budget=4)
    done = {r.rid: r for r in sched.run(reqs)}
    assert len(done) == len(reqs) and sched.n_group_admissions >= 4
    assert sched.n_cache_reorders == 0 and sched.pool.n_used_blocks == 0
    for r in reqs:
        prompt = torch.from_numpy(np.asarray(r.prompt, np.int32)[None])
        if isinstance(r.profile, profiles.BeamProfile):
            want = engine.generate_beam(model, params, n_beams=2, eos_id=2,
                                        max_new_tokens=r.max_new, prompt_tokens=prompt)
        elif isinstance(r.profile, profiles.ContrastiveProfile):
            want = engine.generate_contrastive(model, params, prompt, uncond_token=0,
                                               n_image_tokens=r.max_new, guidance=2.0)
        else:
            want = engine.generate(model, params, prompt, max_new_tokens=r.max_new)
        got = done[r.rid].tokens
        assert got == want["tokens"][0, :len(got)].tolist(), \
            f"request {r.rid} ({type(r.profile).__name__})"


# ---------------------------------------------- feasibility and keys
@pytest.mark.parametrize("geometry", [
    dict(slots=2),  # a group wider than the pool
    dict(slots=4, paged=True, block_size=4, num_blocks=9),  # 4 x 3 blocks > 8
])
def test_group_feasibility_checks(llama, geometry):
    _, _, model, params = llama
    sched = Scheduler(model, params, pad_to=4, max_new_cap=4, device="cpu", **geometry)
    with pytest.raises(ValueError):
        sched.submit([ServeRequest(rid=0, prompt=np.asarray([1]), max_new=4,
                                   profile=profiles.BeamProfile(n_beams=4, eos_id=2))])


def test_group_slot_reuse_keeps_stream_keys_slot_independent(llama):
    """A slot a group stream left (a stale stream index) samples a later
    single request under stream 0's keys: two sampled requests give the
    same tokens with and without a beam group before them."""
    _, _, model, params = llama
    rng = np.random.default_rng(8)
    v = model.config.vocab_size
    # the smoke model's logit gaps are large: only a high temperature makes
    # the key decide the token
    stoch = [ServeRequest(rid=5 + i, prompt=rng.integers(0, v, size=6), max_new=8,
                          temperature=50.0) for i in range(2)]
    pin = ServeRequest(rid=9, prompt=rng.integers(0, v, size=5), max_new=8)
    beam_prompt = rng.integers(0, v, size=4)

    def run(with_beam):
        reqs = [dataclasses.replace(pin, tokens=[], t_tokens=[])]
        if with_beam:
            reqs.append(ServeRequest(rid=0, prompt=beam_prompt, max_new=3,
                                     profile=profiles.BeamProfile(n_beams=3, eos_id=2)))
        reqs += [dataclasses.replace(r, tokens=[], t_tokens=[]) for r in stoch]
        sched = Scheduler(model, params, slots=4, pad_to=PAD_TO, max_new_cap=8, device="cpu",
                          base_key=torch.tensor([0, 4]))
        return {d.rid: d.tokens for d in sched.run(reqs) if d.rid in (5, 6)}

    assert run(True) == run(False)
    keys = sampling.slot_step_keys(np.asarray([0, 4]), [7, 7, 7], [4, 4, 4], [0, 1, 2])
    assert len({tuple(k) for k in keys}) == 3  # a group's streams never share a key


# ------------------------------------------------------------ launcher
def test_mix_class_trace_and_per_class_match_reference():
    prof = serve.data_mod.PAPER_PROFILES["llama_humaneval"]
    kw = dict(pad_to=64, max_new_cap=16, vocab_size=512, arrival_rate=40.0, seed=5,
              burst_size=3, n_beams=3, guidance=2.5, mask_offset=9, exit_layer=2, n_draft=3)
    mine = serve.mix_class_trace(prof, 12, **kw)
    ref = jserve.mix_class_trace(jserve.data_mod.PAPER_PROFILES["llama_humaneval"], 12, **kw)
    fields = ("n_beams", "eos_id", "uncond_token", "guidance", "mask_offset", "temperature",
              "top_p", "exit_layer", "n_draft")
    for a, b in zip(mine, ref):
        assert (a.rid, a.max_new, a.t_arrival, a.temperature, a.top_p) == (
            b.rid, b.max_new, b.t_arrival, b.temperature, b.top_p)
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert type(a.profile).__name__ == type(b.profile).__name__
        assert {f: getattr(a.profile, f, None) for f in fields} == {
            f: getattr(b.profile, f, None) for f in fields}
        assert serve.request_class(a) == jserve.request_class(b)
    assert {serve.request_class(r) for r in mine} == {
        "greedy", "sampling", "beam", "contrastive", "speculative"}
    with pytest.raises(ValueError, match="unknown request class"):
        serve.mix_class_trace(prof, 2, pad_to=8, max_new_cap=4, vocab_size=8,
                              arrival_rate=0.0, classes=("nope",))
    # per_class over made-up timings, field for field
    for i, (a, b) in enumerate(zip(mine, ref)):
        for r in (a, b):
            r.tokens = list(range(1 + i % 3))
            r.t_first, r.t_done = r.t_arrival + 0.01 * (i + 1), r.t_arrival + 0.05 * (i + 2)
    got, want = serve.serve_metrics(mine, 2.0), jserve.serve_metrics(ref, 2.0)
    assert got["per_class"].keys() == want["per_class"].keys()
    for cls, row in want["per_class"].items():
        assert got["per_class"][cls] == pytest.approx(row, rel=1e-12)


def test_serve_cli_profile_mix_on_cpu(capsys):
    m = serve.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--n-requests",
                    "6", "--batch-slots", "4", "--max-new", "6", "--paged", "--chunked",
                    "--block-size", "16", "--prefill-budget", "16", "--profile-mix",
                    "greedy,beam,contrastive", "--n-beams", "2", "--guidance", "2.5"])
    out = capsys.readouterr().out
    assert "slot groups=4" in out and "cow copies=" in out and "class beam:" in out
    assert m["group_admissions"] == 4 and m["cache_reorders"] == 0
    assert m["leaked_blocks"] == 0 and m["n_requests"] == 6
    assert set(m["per_class"]) == {"beam", "contrastive", "greedy"}
