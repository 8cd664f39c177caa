"""LayerSkip self-speculative serving in the port against the JAX package —
the port of ``tests/test_speculative.py`` and ``tests/test_layerskip.py`` —
on the f32 llama3.2-1b smoke config (2 layers, exit layer 1), params bridged
from the reference's init with the embedding table scaled by 0.1 (so drafts
are sometimes rejected: at full scale the random model repeats its input
and every window is accepted whole).

The port's ``Scheduler`` and the JAX one serve the same requests on the
contiguous pool, the paged pool and paged + chunked prefill, greedy and at
t = 0.8 / top-p 0.9, the paged pools too tight for two full requests (they
preempt mid-window): tokens and every counter (steps, preemptions, chunks,
speculative slot-steps, drafted, accepted, committed, the commit histogram,
occupancy) must match exactly. A token may differ only at a reference near
tie (top-1/top-2 gap below 1e-4 greedy; perturbed top-two gap below 1e-5
sampled), reported. The speculative port run must also give the port's
plain run's tokens. Then: EOS inside a window, ``max_new`` straddling a
window, speculative and plain requests in one pool, submit-time refusals,
the verify attention layer against the reference's, ``early_exit_forward``
against a truncated model and the reference's, ``draft_window`` and
``verify_step`` against the reference's, and ``layerskip_generate`` against
the reference's and plain greedy decoding."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import layerskip as jlayerskip
from repro.core import profiles as jprofiles
from repro.core import sampling as jsampling
from repro.core.scheduler import Scheduler as JScheduler
from repro.core.scheduler import ServeRequest as JRequest
from repro.models import attention as JA
from repro_torch.configs import get_smoke_config
from repro_torch.core import engine, kv_cache, layerskip, prng, profiles
from repro_torch.core.scheduler import Scheduler, ServeRequest
from repro_torch.core.slot_pool import BlockPool, SlotPool
from repro_torch.models import attention as A
from repro_torch.models import get_model
from tests.test_torch_sampling import (EMBED_SCALE, assert_sampled_match, bridged_pair,
                                       perturbed_gap)

PAD_TO = 8
NEAR_TIE = {False: 1e-4, True: 1e-5}  # greedy, sampled
F32 = dict(atol=2e-5, rtol=2e-4)
LOGITS = dict(atol=1e-4, rtol=1e-3)
COUNTERS = ("n_preemptions", "n_decode_steps", "n_prefills", "n_mixed_steps", "n_chunks",
            "n_chunk_tokens", "n_spec_steps", "n_spec_slot_steps", "n_spec_drafted",
            "n_spec_accepted", "n_spec_committed", "spec_commit_hist", "peak_used_blocks",
            "occupancy_trace", "block_occupancy_trace")
#: max_len 8 + 16 + 1 = 25 at block 4 is 7 blocks a request: 7 usable blocks
#: cannot hold two full requests, so the paged pools preempt
POOLS = {"contiguous": {},
         "paged": dict(paged=True, block_size=4, num_blocks=8),
         "chunked": dict(paged=True, chunked=True, block_size=4, num_blocks=8,
                         prefill_budget=4)}


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


def _traffic(seed, n, max_news):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 512, size=int(rng.integers(3, PAD_TO + 1))),
             max_news[i % len(max_news)]) for i in range(n)]


def _profiles(temp, spec_every=1, eos_id=None):
    """(JAX profile, port profile) makers by request index: speculative on
    every ``spec_every``-th request, plain sampling at ``temp`` otherwise."""
    def make(i, mod):
        if i % spec_every:
            return mod.SamplingProfile(temperature=temp, top_p=0.9, eos_id=eos_id)
        return mod.SpeculativeProfile(temperature=temp, top_p=0.9, eos_id=eos_id, exit_layer=1,
                                      n_draft=4)
    return (lambda i: make(i, jprofiles)), (lambda i: make(i, profiles))


def _gap_at(jmodel, jparams, prompt, tokens, rid, temp, base):
    """The reference's deciding gap for token ``k`` of request ``rid``."""
    def gap(k):
        seq = np.concatenate([np.asarray(prompt, np.int32), np.asarray(tokens[:k], np.int32)])
        logits, _ = jengine.prefill(jmodel, jparams, jnp.asarray(seq[None]),
                                    jnp.asarray([len(seq)], jnp.int32), len(seq) + 1, None)
        if temp <= 0:
            top2 = np.sort(np.asarray(logits[0]))[-2:]
            return float(top2[1] - top2[0])
        key = jsampling.slot_step_keys(base, jnp.asarray([rid]), jnp.asarray([k]))[0]
        return perturbed_gap(np.asarray(logits[0]), key, temp, 0.9)
    return gap


def run_both(pair, traffic, make_j, make_t, *, temp=0.0, seed=9, **kw):
    """One trace (every arrival at t = 0) through the JAX scheduler and the
    port's: tokens under the near-tie rule, finish order and every counter
    exactly, no block left owned. Returns (port scheduler, port requests by
    rid)."""
    jmodel, jparams, model, params = pair
    base = jax.random.PRNGKey(seed)
    js = JScheduler(jmodel, jparams, base_key=base, **kw)
    ts = Scheduler(model, params, device="cpu", base_key=prng.PRNGKey(seed), **kw)
    jdone = js.run([JRequest(rid=i, prompt=p, max_new=m, profile=make_j(i))
                    for i, p, m in traffic])
    tdone = ts.run([ServeRequest(rid=i, prompt=p, max_new=m, profile=make_t(i))
                    for i, p, m in traffic])
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    jtok = {r.rid: r.tokens for r in jdone}
    for r in tdone:
        assert 1 <= len(r.tokens) <= r.max_new
        assert_sampled_match(r.tokens, jtok[r.rid],
                             _gap_at(jmodel, jparams, traffic[r.rid][1], jtok[r.rid], r.rid,
                                     temp, base), f"request {r.rid}", tie=NEAR_TIE[temp > 0])
    for name in COUNTERS:
        assert getattr(ts, name) == getattr(js, name), name
    if kw.get("paged"):
        assert ts.pool.n_used_blocks == 0
        assert sorted(ts.pool._free_blocks) == list(range(1, ts.pool.num_blocks))
    return ts, {r.rid: r for r in tdone}


def _consistent(ts) -> None:
    """Each speculative slot-step commits its accepted drafts plus one
    full-model token; the histogram sums to the slot-steps and commits."""
    assert ts.n_spec_committed == ts.n_spec_accepted + ts.n_spec_slot_steps
    assert 0 <= ts.n_spec_accepted <= ts.n_spec_drafted
    assert sum(ts.spec_commit_hist.values()) == ts.n_spec_slot_steps
    assert sum(k * v for k, v in ts.spec_commit_hist.items()) == ts.n_spec_committed


# ---------------------------------------------------------------- scheduler
@pytest.mark.parametrize("temp", [0.0, 0.8])
@pytest.mark.parametrize("pool", list(POOLS))
def test_speculative_scheduler_matches_jax(pair, pool, temp):
    """Six requests, two slots: the speculative scheduler against the
    reference's on each pool, greedy and sampled; the tight paged pools
    preempt mid-window and replay. The port's plain run gives the same
    tokens."""
    traffic = _traffic(4, 6, [16, 9, 12, 16])
    make_j, make_t = _profiles(temp)
    kw = dict(slots=2, pad_to=PAD_TO, max_new_cap=16, **POOLS[pool])
    ts, got = run_both(pair, traffic, make_j, make_t, temp=temp, **kw)
    assert ts.n_spec_steps >= 1 and ts.n_spec_accepted >= 1
    assert ts.n_spec_accepted < ts.n_spec_drafted  # some drafts were rejected
    _consistent(ts)
    if pool != "contiguous":
        assert ts.n_preemptions >= 1
    for r in got.values():
        assert len(r.tokens) == r.max_new
    _, _, model, params = pair
    plain = Scheduler(model, params, device="cpu", base_key=prng.PRNGKey(9), **kw)
    pdone = plain.run([ServeRequest(rid=i, prompt=p, max_new=m, temperature=temp, top_p=0.9)
                       for i, p, m in traffic])
    assert {r.rid: r.tokens for r in pdone} == {rid: r.tokens for rid, r in got.items()}
    assert plain.n_decode_steps > ts.n_decode_steps  # windows commit > 1 token a step


def test_speculative_eos_inside_window_truncates(pair):
    """An EOS inside an accepted window stops the request AT the EOS: no
    draft behind it commits."""
    _, _, model, params = pair
    traffic = _traffic(2, 5, [12, 9])
    probe = Scheduler(model, params, slots=1, pad_to=PAD_TO, max_new_cap=12, device="cpu")
    eos_id = probe.run([ServeRequest(rid=0, prompt=traffic[0][1], max_new=12)])[0].tokens[2]
    make_j, make_t = _profiles(0.0, eos_id=eos_id)
    ts, got = run_both(pair, traffic, make_j, make_t, slots=2, pad_to=PAD_TO, max_new_cap=12,
                       **POOLS["paged"])
    stopped = [r for r in got.values() if eos_id in r.tokens]
    assert stopped
    for r in stopped:
        assert r.tokens[-1] == eos_id and r.tokens.count(eos_id) == 1
    _consistent(ts)


def test_speculative_max_new_never_overshoots(pair):
    """Variable strides stop at ``max_new`` when the last window straddles
    it (7, 11, 3 and 1 are no multiples of n_draft + 1 = 5)."""
    traffic = _traffic(3, 4, [7, 11, 3, 1])
    make_j, make_t = _profiles(0.8)
    ts, got = run_both(pair, traffic, make_j, make_t, temp=0.8, slots=2, pad_to=PAD_TO,
                       max_new_cap=11, **POOLS["paged"])
    for i, _, m in traffic:
        assert len(got[i].tokens) == m
    _consistent(ts)


@pytest.mark.parametrize("pool", ["contiguous", "chunked"])
def test_speculative_and_plain_requests_share_a_pool(pair, pool):
    """Even requests speculative, odd ones plain, in one pool: plain slots
    ride the speculative steps with width-1 windows."""
    traffic = _traffic(5, 6, [12, 10])
    make_j, make_t = _profiles(0.8, spec_every=2)
    ts, _ = run_both(pair, traffic, make_j, make_t, temp=0.8, slots=3, pad_to=PAD_TO,
                     max_new_cap=12, **POOLS[pool])
    assert ts.n_spec_steps >= 1
    _consistent(ts)


def test_submit_refuses_what_the_port_cannot_serve(pair):
    _, _, model, params = pair
    n_layers = model.config.n_layers
    sched = Scheduler(model, params, slots=2, pad_to=PAD_TO, max_new_cap=4, device="cpu")
    prompt = np.zeros((4,), np.int64)

    def submit(profile):
        sched.submit([ServeRequest(rid=0, prompt=prompt, max_new=2, profile=profile)])

    for bad in (profiles.SpeculativeProfile(exit_layer=0),
                profiles.SpeculativeProfile(exit_layer=n_layers),
                profiles.SpeculativeProfile(n_draft=0),
                profiles.SamplingProfile(sampler=lambda logits, key: logits.argmax(-1))):
        with pytest.raises(ValueError):
            submit(bad)
    for group in (profiles.BeamProfile(n_beams=2, eos_id=2),
                  profiles.ContrastiveProfile(uncond_token=0)):
        submit(group)  # slot groups are admitted, their profile kept
        assert sched.waiting[-1].profile is group
    ssm = get_model(get_smoke_config("mamba2-130m"))
    ssm_sched = Scheduler(ssm, ssm.init(torch.Generator().manual_seed(0), "cpu"), slots=1,
                          pad_to=PAD_TO, max_new_cap=4, device="cpu")
    with pytest.raises(ValueError, match="rollback"):
        ssm_sched.submit([ServeRequest(rid=0, prompt=prompt, max_new=2,
                                       profile=profiles.SpeculativeProfile())])
    # a sampled single-stream profile collapses onto the per-slot fields
    r = sched.normalize(ServeRequest(rid=1, prompt=prompt, max_new=9, profile=(
        profiles.SpeculativeProfile(temperature=0.7, top_p=0.8, eos_id=5))))
    assert (r.temperature, r.top_p, r.eos_id, r.max_new) == (0.7, 0.8, 5, 4)


# ------------------------------------------------------------ model layers
@pytest.mark.parametrize("paged", [False, True])
def test_verify_attention_layer_matches_jax(pair, paged):
    """One verify attention layer: the output of every live lane and the
    cache it wrote against the reference's, slots of width 5, 1, 3 and 0;
    a contiguous window's dead lanes write nothing (not even clamped)."""
    jmodel, jparams, model, params = pair
    cfg, jcfg = model.config, jmodel.config
    rng = np.random.default_rng(6)
    b, c, s = 4, 5, 12
    x = rng.normal(size=(b, c, cfg.d_model)).astype(np.float32)
    lengths = np.array([0, 4, 9, 2], np.int32)  # slot 2's window would overhang S
    t_new = np.array([5, 1, 3, 0], np.int32)
    pos = lengths[:, None] + np.arange(c, dtype=np.int32)[None]
    if paged:
        bs, nb = 4, 14
        kv = [rng.normal(size=(nb, bs, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
              for _ in range(2)]
        bt = np.array([[3, 5, 7], [1, 2, 4], [6, 8, 9], [0, 0, 0]], np.int32)
        jc = {"k": jnp.asarray(kv[0]), "v": jnp.asarray(kv[1]), "bt": jnp.asarray(bt)}
        tc = {"k": torch.from_numpy(kv[0].copy()), "v": torch.from_numpy(kv[1].copy()),
              "bt": torch.from_numpy(bt)}
    else:
        kv = [rng.normal(size=(b, s, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
              for _ in range(2)]
        jc = {"k": jnp.asarray(kv[0]), "v": jnp.asarray(kv[1])}
        tc = {"k": torch.from_numpy(kv[0].copy()), "v": torch.from_numpy(kv[1].copy())}
    jout, jnew = JA.attention(jcfg, jparams["layers"][0]["attn"], jnp.asarray(x),
                              positions=jnp.asarray(pos), lengths=jnp.asarray(lengths),
                              cache=jc, mode="verify", t_new=jnp.asarray(t_new))
    with torch.inference_mode():
        out, new = A.attention(cfg, params["layers"][0]["attn"], torch.from_numpy(x),
                               positions=torch.from_numpy(pos),
                               lengths=torch.from_numpy(lengths), cache=tc, mode="verify",
                               t_new=torch.from_numpy(t_new))
    assert new["k"] is tc["k"]  # written in place
    for r in range(b):
        w = t_new[r]
        np.testing.assert_allclose(out.numpy()[r, :w], np.asarray(jout)[r, :w], **F32)
    lo = 1 if paged else 0  # the sink block takes the paged dead lanes' writes
    for key in ("k", "v"):
        np.testing.assert_allclose(new[key].numpy()[lo:], np.asarray(jnew[key])[lo:], **F32)
    if not paged:  # dead lanes dropped: everything past each window untouched
        for r in range(b):
            np.testing.assert_array_equal(new["k"].numpy()[r, lengths[r] + t_new[r]:],
                                          kv[0][r, lengths[r] + t_new[r]:])


def test_early_exit_forward_matches_truncated_model_and_jax(pair):
    jmodel, jparams, model, params = pair
    cfg = model.config
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, size=(2, 6)).astype(np.int32)
    got, _ = layerskip.early_exit_forward(cfg, params, {"tokens": torch.from_numpy(toks)},
                                          n_layers=1, mode="train")
    one = get_model(cfg.replace(n_layers=1))
    want, _, _ = one.forward({"embed": params["embed"], "final_norm": params["final_norm"],
                              "layers": params["layers"][:1]},
                             {"tokens": torch.from_numpy(toks)}, mode="train")
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    jlog, _ = jlayerskip.early_exit_forward(jmodel.config, jparams,
                                            {"tokens": jnp.asarray(toks)}, n_layers=1,
                                            mode="train")
    np.testing.assert_allclose(got.numpy(), np.asarray(jlog), **LOGITS)


@pytest.mark.parametrize("paged", [False, True])
def test_draft_window_and_verify_step_match_jax(pair, paged):
    """One draft window (slot widths 4, 2, 0: the last frozen) and the
    verify step over it, from the same prefilled pool: the drafts equal the
    reference's, the verify logits agree, and the lengths advance by the
    widths; a rewind then restores the committed lengths."""
    jmodel, jparams, model, params = pair
    rng = np.random.default_rng(8)
    b, max_len, k = 3, 20, 4
    prompts = [rng.integers(0, 512, size=n).astype(np.int32) for n in (6, 3, 8)]
    if paged:
        from repro.core.slot_pool import BlockPool as JBlockPool

        jpool = JBlockPool(jmodel, b, max_len, block_size=4)
        tpool = BlockPool(model, b, max_len, "cpu", block_size=4)
    else:
        from repro.core.slot_pool import SlotPool as JSlotPool

        jpool, tpool = JSlotPool(jmodel, b, max_len), SlotPool(model, b, max_len, "cpu")
    first = []
    for slot, p in enumerate(prompts):
        buf = np.zeros((1, 8), np.int32)
        buf[0, :len(p)] = p
        jl, jrow = jengine.prefill(jmodel, jparams, jnp.asarray(buf),
                                   jnp.asarray([len(p)], jnp.int32), max_len, None)
        _, trow = engine.prefill(model, params, torch.from_numpy(buf),
                                 torch.tensor([len(p)], dtype=torch.int32), max_len)
        jpool.acquire(), tpool.acquire()
        jpool.assign(slot, jrow, len(p))
        tpool.assign(slot, trow, len(p))
        first.append(int(np.argmax(np.asarray(jl[0]))))
        if paged:
            jpool.ensure(slot, len(p) + k)
            tpool.ensure(slot, len(p) + k)
    jpool.sync(), tpool.sync()
    lengths = np.array([len(p) for p in prompts], np.int32)
    n_live, w = np.array([4, 2, 0], np.int32), np.array([5, 3, 1], np.int32)
    jwin, jcache = jlayerskip.draft_window(jmodel, 1, k, jparams, jpool.cache,
                                           jnp.asarray(first, jnp.int32), jnp.asarray(n_live),
                                           jnp.asarray(lengths))
    twin, tcache = layerskip.draft_window(model, 1, k, params, tpool.cache,
                                          torch.tensor(first, dtype=torch.int32),
                                          torch.from_numpy(n_live), torch.from_numpy(lengths))
    np.testing.assert_array_equal(twin.numpy(), np.asarray(jwin))
    assert tcache["lengths"].tolist() == (lengths + n_live).tolist()
    jlog, _ = jengine.verify_step(jmodel, jparams, jcache, jwin, jnp.asarray(w),
                                  jnp.asarray(lengths))
    tlog, tcache = engine.verify_step(model, params, tcache, twin, torch.from_numpy(w),
                                      torch.from_numpy(lengths))
    assert tlog.shape == (b, k + 1, model.config.vocab_size)
    for r in range(b):
        np.testing.assert_allclose(tlog.numpy()[r, :w[r]], np.asarray(jlog)[r, :w[r]],
                                   **LOGITS)
    assert tcache["lengths"].tolist() == (lengths + w).tolist()
    back = kv_cache.rewind(tcache, torch.from_numpy(lengths + 1))
    assert back["lengths"].tolist() == (lengths + 1).tolist()


def test_block_pool_truncate_matches_jax(pair):
    """Grow a slot for a window, truncate back: the table, free-list and
    refcounts equal the reference's, freed entries point at the sink block,
    and the device table is marked for the next sync."""
    from repro.core.slot_pool import BlockPool as JBlockPool

    jmodel, _, model, _ = pair
    jpool = JBlockPool(jmodel, 2, 24, block_size=4)
    tpool = BlockPool(model, 2, 24, "cpu", block_size=4)
    for pool in (jpool, tpool):
        pool.acquire(), pool.acquire()
        pool.ensure(0, 3)
        pool.ensure(1, 6)
        pool.ensure(0, 3 + 9)  # a window's growth
        pool.sync()
        pool.truncate(0, 5)  # two commits kept
        pool.truncate(1, 6)  # nothing to drop
    np.testing.assert_array_equal(tpool.block_tables, np.asarray(jpool.block_tables))
    assert sorted(tpool._free_blocks) == sorted(jpool._free_blocks)
    np.testing.assert_array_equal(tpool._ref, np.asarray(jpool._ref))
    assert tpool.owned_blocks(0) == jpool.owned_blocks(0) and len(tpool.owned_blocks(0)) == 2
    assert tpool._bt_dirty
    tpool.sync()
    np.testing.assert_array_equal(tpool.cache["block_tables"].numpy(), tpool.block_tables)


# --------------------------------------------------------------- engine
@pytest.mark.parametrize("n_draft", [1, 3, 5])
def test_layerskip_generate_matches_jax_and_greedy(pair, n_draft):
    jmodel, jparams, model, params = pair
    prompts = np.random.default_rng(n_draft).integers(0, 512, size=(3, 8)).astype(np.int32)
    want = jlayerskip.layerskip_generate(jmodel, jparams, jnp.asarray(prompts), exit_layer=1,
                                         n_draft=n_draft, max_new_tokens=12)
    got = layerskip.layerskip_generate(model, params, torch.from_numpy(prompts), exit_layer=1,
                                       n_draft=n_draft, max_new_tokens=12)
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    assert (got["n_rounds"], got["acceptance"], got["tokens_per_round"]) == (
        want["n_rounds"], want["acceptance"], want["tokens_per_round"])
    greedy = engine.generate(model, params, torch.from_numpy(prompts), max_new_tokens=12)
    assert torch.equal(got["tokens"], greedy["tokens"])
    assert got["tokens_per_round"] <= 1 + n_draft and 0.0 <= got["acceptance"] <= 1.0


def test_layerskip_refuses_recurrent_families():
    ssm = get_model(get_smoke_config("mamba2-130m"))
    with pytest.raises(ValueError, match="rolls back"):
        layerskip.layerskip_generate(ssm, ssm.init(torch.Generator().manual_seed(0), "cpu"),
                                     torch.zeros((1, 4), dtype=torch.int32), exit_layer=1)


def test_run_profile_splits_its_key_as_the_reference(pair):
    """A speculative profile in the batch engine is its sampling base; the
    loop's key chain is the reference's: token for token at t = 0.8."""
    jmodel, jparams, model, params = pair
    prompts = np.random.default_rng(1).integers(0, 512, size=(2, 5)).astype(np.int32)
    jp = jprofiles.SpeculativeProfile(temperature=0.8, top_p=0.9)
    tp = profiles.SpeculativeProfile(temperature=0.8, top_p=0.9)
    want = jengine.run_profile(jmodel, jparams, jp, jnp.asarray(prompts), max_new_tokens=8,
                               key=jax.random.PRNGKey(3))
    got = engine.run_profile(model, params, tp, torch.from_numpy(prompts), max_new_tokens=8,
                             key=prng.PRNGKey(3))
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    assert dataclasses.is_dataclass(tp) and tp.n_streams == 1


# -------------------------------------------------------------- launcher
def test_launcher_traces_mixes_and_serves_speculatively(capsys):
    """``poisson_trace``'s temperature and top-p as the reference's;
    ``apply_profile_mix`` gives the reference's profile type, fields and
    temperature for every kind and refuses the kinds it refuses; the CLI's
    sampled speculative run prints its ``spec`` line."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    prof = serve.data_mod.PAPER_PROFILES["llama_humaneval"]
    kw = dict(pad_to=64, max_new_cap=16, vocab_size=512, arrival_rate=0.0, seed=3,
              temperature=0.8, top_p=0.9)
    mine = serve.poisson_trace(prof, 6, **kw)
    ref = jserve.poisson_trace(jserve.data_mod.PAPER_PROFILES["llama_humaneval"], 6, **kw)
    for a, b in zip(mine, ref):
        assert (a.rid, a.max_new, a.temperature, a.top_p) == (b.rid, b.max_new, b.temperature,
                                                               b.top_p)
    mix = "greedy,beam,contrastive,speculative"
    kw = dict(n_beams=3, beam_eos_id=5, guidance=2.5, uncond_token=1, mask_offset=7,
              exit_layer=1, n_draft=3)
    serve.apply_profile_mix(mine, mix, **kw)
    jserve.apply_profile_mix(ref, mix, **kw)
    fields = ("n_beams", "eos_id", "uncond_token", "guidance", "mask_offset", "temperature",
              "top_p", "exit_layer", "n_draft", "prefix_shared", "n_streams")
    for a, b in zip(mine, ref):
        assert type(a.profile).__name__ == type(b.profile).__name__
        assert (a.temperature, a.top_p) == (b.temperature, b.top_p)
        assert {f: getattr(a.profile, f, None) for f in fields} == {
            f: getattr(b.profile, f, None) for f in fields}
    assert mine[0].profile is None and mine[0].temperature == 0.8  # greedy keeps it
    assert (mine[3].profile.temperature, mine[3].profile.top_p) == (0.8, 0.9)
    for kind in ("sampling", "cfg"):
        for mod in (serve, jserve):
            with pytest.raises(ValueError, match="unknown profile kind"):
                mod.apply_profile_mix(mine, kind)
    m = serve.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--n-requests", "4",
                    "--batch-slots", "2", "--max-new", "8", "--profile-mix", "speculative",
                    "--exit-layer", "1", "--n-draft", "3", "--temperature", "0.8",
                    "--top-p", "0.9"])
    out = capsys.readouterr().out
    assert "spec steps=" in out and m["spec_steps"] >= 1
    assert m["spec_committed"] == m["spec_accepted"] + m["spec_slot_steps"]
