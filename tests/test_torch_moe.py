"""The port's MoE slice against the JAX package, on the f32
``qwen3-moe-smoke`` config (4 experts top-2, qk-norm) and, for the shared
experts, ``deepseek-v2-smoke``: params come from the reference's
``init(PRNGKey(0))`` through ``repro_torch.bridge``, inputs are made with
numpy and handed to both sides.

- ``moe_ffn`` at the published capacity, a tight one that drops and a
  dropless one (``capacity_factor = E / k``), under both ``dispatch_rank``s,
  output and aux loss at atol 2e-5 / rtol 2e-4; the ranks and capacities
  themselves exactly;
- the whole model's logits in every mode it serves (train, prefill,
  contiguous decode and verify, paged decode, mixed and verify) at atol
  1e-4 / rtol 1e-3;
- the served tokens through the port's and the reference's ``Scheduler``
  on one trace: contiguous, paged, chunked, chunked with the prefix cache,
  and speculative at t = 0 and 0.8. Tokens are exact up to a near tie: a
  divergence passes only where the reference's top-1/top-2 logit gap (the
  perturbed top-two gap when sampled), or the k-th/(k+1)-th router
  probability gap at a position of the replayed sequence, is below 1e-4,
  and it is reported. The host counts (steps, preemptions, chunks,
  speculative counters, prefix hits) are exact;
- across pools the tokens agree only under dropless capacity (at 1.25 an
  assignment's drop depends on what else shares its step), which the
  last test holds.

The helpers serve ``tests/test_torch_mla.py`` too."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import profiles as jprofiles
from repro.core import sampling as jsampling
from repro.core.scheduler import Scheduler as JScheduler
from repro.core.scheduler import ServeRequest as JRequest
from repro.models import moe as jM
from repro_torch import bridge
from repro_torch.core import engine, prng, profiles
from repro_torch.core.scheduler import Scheduler, ServeRequest
from repro_torch.models import get_model
from repro_torch.models import moe as M
from tests.test_torch_sampling import bridged_pair, perturbed_gap

F32 = dict(atol=2e-5, rtol=2e-4)
LOGITS = dict(atol=1e-4, rtol=1e-3)
NEAR_TIE = 1e-4
ARCH = "qwen3-moe-30b-a3b"
PAD_TO = 8
#: max_len 8 + 8 + 1 = 17 at block 4 is 5 blocks a request: 5 usable blocks
#: cannot hold two full requests, so the paged pools preempt
ARMS = {
    "contiguous": (0.0, False, {}),
    "paged": (0.0, False, dict(paged=True, block_size=4, num_blocks=6)),
    "chunked": (0.0, False, dict(paged=True, chunked=True, block_size=4, num_blocks=6,
                                 prefill_budget=4)),
    "prefix": (0.0, False, dict(paged=True, chunked=True, block_size=4, num_blocks=16,
                                prefill_budget=4, prefix_cache=True)),
    "spec t=0": (0.0, True, {}),
    "spec t=0.8": (0.8, True, dict(paged=True, chunked=True, block_size=4, num_blocks=6,
                                   prefill_budget=4)),
}
COUNTERS = ("n_preemptions", "n_decode_steps", "n_prefills", "n_mixed_steps", "n_chunks",
            "n_chunk_tokens", "n_spec_steps", "n_spec_slot_steps", "n_spec_drafted",
            "n_spec_accepted", "n_spec_committed", "spec_commit_hist", "peak_used_blocks",
            "n_prefix_hits", "n_prefix_tokens_skipped", "occupancy_trace")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while the module runs: its serving loops are
    many tiny eager ops, which a thread pool only slows beside other test
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PAIRS = {}


def pair_of(arch):
    """One bridged pair per arch for the whole session."""
    if arch not in _PAIRS:
        _PAIRS[arch] = bridged_pair(arch)
    return _PAIRS[arch]


@pytest.fixture(scope="module")
def pair():
    return pair_of(ARCH)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=LOGITS):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               **tol)


def with_capacity(cfg, factor, rank="cumsum"):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=factor,
                                               dispatch_rank=rank))


# -------------------------------------------------------------- moe_ffn
def test_expert_capacity_and_ranks_match_jax(pair):
    cfg = pair[2].config
    for n in (1, 7, 8, 60, 333, 4096):
        for factor in (0.5, 1.25, 2.0):
            c = with_capacity(cfg, factor)
            assert M.expert_capacity(n, c) == jM.expert_capacity(n, c)
    flat_e = np.random.default_rng(0).integers(0, 5, size=97).astype(np.int32)
    want = np.asarray(jM._position_in_expert(jnp.asarray(flat_e), 5, "cumsum"))
    for method in ("cumsum", "sort"):
        got = M.position_in_expert(torch.from_numpy(flat_e).long(), 5, method)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rank", ["cumsum", "sort"])
@pytest.mark.parametrize("capacity", ["published", "tight", "dropless"])
@pytest.mark.parametrize("arch", [ARCH, "deepseek-v2-236b"])
def test_moe_ffn_matches_jax(arch, capacity, rank):
    """The FFN of an MoE layer on [3, 20, d] inputs: the published 1.25, a
    tight 0.5 (assignments past capacity dropped, checked) and dropless
    capacity; deepseek's layer adds its shared expert."""
    jmodel, jparams, model, params = pair_of(arch)
    layer = model.config.moe.first_dense_layers
    factor = {"published": 1.25, "tight": 0.5,
              "dropless": model.config.moe.n_experts / model.config.moe.top_k}[capacity]
    jcfg = with_capacity(jmodel.config, factor, rank)
    tcfg = with_capacity(model.config, factor, rank)
    x = np.random.default_rng(1).standard_normal((3, 20, tcfg.d_model)).astype(np.float32)
    jout, jaux = jM.moe_ffn(jcfg, jparams["layers"][layer]["moe"], jnp.asarray(x))
    tout, taux = M.moe_ffn(tcfg, params["layers"][layer]["moe"], t(x))
    close(tout, jout, F32)
    np.testing.assert_allclose(float(taux), float(jaux), **F32)
    _, _, ids = M.route(tcfg, params["layers"][layer]["moe"], t(x).reshape(60, -1))
    pos = M.position_in_expert(ids.reshape(-1), tcfg.moe.n_experts, rank)
    dropped = int((pos >= M.expert_capacity(60, tcfg)).sum())
    assert (dropped > 0) == (capacity == "tight"), dropped


# ------------------------------------------------------------ the model
def _paged_cache(rng, model, jmodel, b, mb, bs, nb):
    """Random pool contents and tables for both packages (rows disjoint but
    for row 3, whose table is freed: all sink block 0)."""
    jc = jmodel.init_cache(nb, bs)
    leaves = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), jc)
    lengths = np.array([1, 5, 9, 0], np.int32)[:b]
    perm = rng.permutation(np.arange(1, nb))[: b * mb].reshape(b, mb).astype(np.int32)
    perm[3:] = 0
    jc = dict(jax.tree.map(jnp.asarray, leaves), lengths=jnp.asarray(lengths),
              block_tables=jnp.asarray(perm))
    tc = bridge.cache_to_torch(jax.tree.map(np.asarray, dict(leaves, lengths=lengths)), "cpu")
    tc["block_tables"] = torch.from_numpy(perm.copy())
    return jc, tc


MODES = ["prefill+decode", "verify", "paged decode", "paged mixed", "paged verify"]


def check_model_modes(pair_, mode, tol=LOGITS):
    """Train logits, then the mode's logits from both packages on one
    cache: a prefill of 10 tokens then two decode steps (contiguous), a
    verify window after that prefill, or one step over a random paged pool
    whose slot 3 is freed (decode) or idle (t_new 0). Logits of live lanes
    and rows only, within ``tol``."""
    jmodel, jparams, model, params = pair_
    rng = np.random.default_rng(2)
    toks = rng.integers(0, model.config.vocab_size, size=(4, 12)).astype(np.int32)
    if mode == "prefill+decode":
        jl, _, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)}, mode="train")
        tl, _, _ = model.forward(params, {"tokens": t(toks)}, mode="train")
        close(tl, jl, tol)
    if not mode.startswith("paged"):
        jc, tc = jmodel.init_cache(4, 18), model.init_cache(4, 18, "cpu")
        jl, jc, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks[:, :10])}, cache=jc,
                                   mode="prefill")
        tl, tc, _ = model.forward(params, {"tokens": t(toks[:, :10])}, cache=tc,
                                  mode="prefill")
        close(tl, jl, tol)
        if mode == "verify":
            t_new = np.array([2, 1, 2, 0], np.int32)
            batch = {"tokens": toks[:, 10:12], "t_new": t_new}
            jl, jc, _ = jmodel.forward(jparams, jax.tree.map(jnp.asarray, batch), cache=jc,
                                       mode="verify")
            tl, tc, _ = model.forward(params, {k: t(v) for k, v in batch.items()}, cache=tc,
                                      mode="verify")
            for r in range(4):
                close(tl[r, :t_new[r]], np.asarray(jl)[r, :t_new[r]], tol)
            assert tc["lengths"].tolist() == [12, 11, 12, 10]
            return
        for i in (10, 11):
            jl, jc, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks[:, i:i + 1])},
                                       cache=jc, mode="decode")
            tl, tc, _ = model.forward(params, {"tokens": t(toks[:, i:i + 1])}, cache=tc,
                                      mode="decode")
            close(tl, jl, tol)
        return
    jc, tc = _paged_cache(rng, model, jmodel, 4, 4, 4, 20)
    step = mode.split()[1]
    width = 1 if step == "decode" else 3
    batch = {"tokens": toks[:, :width]}
    if step != "decode":
        batch["t_new"] = np.array([3, 1, 2, 0], np.int32)
    jl, _, _ = jmodel.forward(jparams, jax.tree.map(jnp.asarray, batch), cache=jc, mode=step)
    with torch.inference_mode():
        tl, _, _ = model.forward(params, {k: t(v) for k, v in batch.items()}, cache=tc,
                                 mode=step)
    live = 4 if step == "decode" else 3
    if step == "verify":
        for r in range(live):
            w = batch["t_new"][r]
            close(tl[r, :w], np.asarray(jl)[r, :w], tol)
    else:
        close(tl[:live], np.asarray(jl)[:live], tol)


@pytest.mark.parametrize("mode", MODES)
def test_model_logits_match_jax(pair, mode):
    check_model_modes(pair, mode)


# ---------------------------------------------------------- served tokens
def _traffic(seed, n, max_news, vocab):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, size=int(rng.integers(3, PAD_TO + 1))),
             max_news[i % len(max_news)]) for i in range(n)]


def _prefix_traffic(seed, n, vocab):
    """n requests sharing a two-block prefix (block 4) with their own tails."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=PAD_TO)
    return [(i, np.concatenate([shared, rng.integers(0, vocab, size=4)])[:PAD_TO + 4],
             int(rng.integers(2, 7))) for i in range(n)]


def router_gap(model, params, seq) -> float:
    """The smallest k-th/(k+1)-th router probability gap over every MoE
    layer and position when ``seq`` is prefilled alone (the port's f32
    router, equal to the reference's up to rounding)."""
    gaps = []
    real = M.route

    def spy(cfg, p, xf):
        probs, w, ids = real(cfg, p, xf)
        top = torch.sort(probs, dim=-1, descending=True).values
        k = cfg.moe.top_k
        gaps.append(float((top[:, k - 1] - top[:, k]).min()))
        return probs, w, ids

    M.route = spy
    try:
        with torch.inference_mode():
            engine.prefill(model, params, t(np.asarray(seq, np.int32)[None]),
                           t(np.array([len(seq)], np.int32)), len(seq) + 1)
    finally:
        M.route = real
    return min(gaps)


def _gap_at(pair_, prompt, tokens, rid, temp, base):
    """The deciding gap of token ``k`` of request ``rid``: the smaller of
    the reference's logit gap (perturbed when sampled) and the router gap
    along the sequence."""
    jmodel, jparams, model, params = pair_

    def gap(k):
        seq = np.concatenate([np.asarray(prompt, np.int32), np.asarray(tokens[:k], np.int32)])
        logits, _ = jengine.prefill(jmodel, jparams, jnp.asarray(seq[None]),
                                    jnp.asarray([len(seq)], jnp.int32), len(seq) + 1, None)
        if temp <= 0:
            top2 = np.sort(np.asarray(logits[0]))[-2:]
            lg = float(top2[1] - top2[0])
        else:
            key = jsampling.slot_step_keys(base, jnp.asarray([rid]), jnp.asarray([k]))[0]
            lg = perturbed_gap(np.asarray(logits[0]), key, temp, 0.9)
        rg = router_gap(model, params, seq)
        print(f"request {rid} token {k}: logit gap {lg:.2e}, router gap {rg:.2e}")
        return min(lg, rg)
    return gap


def _match(got, want, gap_at, what):
    got, want = [int(x) for x in got], [int(x) for x in want]
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            gap = gap_at(i)
            assert gap < NEAR_TIE, f"{what}: token {i} is {g}, the reference's {w} (gap {gap})"
            print(f"{what}: near-tie divergence at token {i} (gap {gap:.2e})")
            return
    assert len(got) == len(want), f"{what}: {len(got)} tokens vs {len(want)}"


def serve_both(pair_, arm, seed=9):
    """The arm's trace (every arrival at t = 0) through the JAX scheduler
    and the port's: tokens under the near-tie rule, finish order and every
    counter exactly, no block left owned. Returns the port's tokens."""
    jmodel, jparams, model, params = pair_
    temp, spec, geometry = ARMS[arm]
    vocab = model.config.vocab_size
    kw = dict(slots=2, pad_to=PAD_TO + (4 if arm == "prefix" else 0), max_new_cap=8,
              **geometry)
    traffic = (_prefix_traffic(3, 6, vocab) if arm == "prefix"
               else _traffic(2, 6, [8, 3, 6, 5], vocab))

    def profile(i, mod):
        if spec:
            return mod.SpeculativeProfile(temperature=temp, top_p=0.9, exit_layer=1, n_draft=3)
        return mod.SamplingProfile(temperature=temp, top_p=0.9)

    base = jax.random.PRNGKey(seed)
    js = JScheduler(jmodel, jparams, base_key=base, **kw)
    ts = Scheduler(model, params, device="cpu", base_key=prng.PRNGKey(seed), **kw)
    runs = 2 if arm == "prefix" else 1  # the prefix arm's second run hits the trie
    for _ in range(runs):
        jdone = js.run([JRequest(rid=i, prompt=p, max_new=m, profile=profile(i, jprofiles))
                        for i, p, m in traffic])
        tdone = ts.run([ServeRequest(rid=i, prompt=p, max_new=m, profile=profile(i, profiles))
                        for i, p, m in traffic])
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    jtok = {r.rid: r.tokens for r in jdone}
    for r in tdone:
        assert len(r.tokens) == r.max_new
        _match(r.tokens, jtok[r.rid], _gap_at(pair_, traffic[r.rid][1], jtok[r.rid], r.rid,
                                              temp, base), f"{arm} request {r.rid}")
    for name in COUNTERS:
        assert getattr(ts, name) == getattr(js, name), name
    if geometry.get("paged"):
        assert ts.pool.n_used_blocks == ts.pool.n_cached_blocks
        if arm != "prefix":
            assert ts.n_preemptions >= 1
    if spec:
        assert ts.n_spec_steps >= 1
    if arm == "prefix":
        assert ts.n_prefix_hits >= 1
    return {r.rid: list(r.tokens) for r in tdone}


@pytest.mark.parametrize("arm", list(ARMS))
def test_served_tokens_match_jax_scheduler(pair, arm):
    serve_both(pair, arm)


def check_cross_pool(pair_):
    """Under dropless capacity a token's experts do not depend on what
    shares its step, so the contiguous, paged and chunked pools and the
    speculative windows give the same greedy tokens."""
    _, _, model, params = pair_
    cfg = model.config
    dropless = get_model(with_capacity(cfg, cfg.moe.n_experts / cfg.moe.top_k))
    traffic = _traffic(4, 6, [8, 3, 6, 5], cfg.vocab_size)
    out = {}
    for arm in ("contiguous", "paged", "chunked", "spec t=0"):
        _, spec, geometry = ARMS[arm]
        prof = (lambda: profiles.SpeculativeProfile(exit_layer=1, n_draft=3)) if spec else (
            lambda: None)
        sched = Scheduler(dropless, params, slots=2, pad_to=PAD_TO, max_new_cap=8,
                          device="cpu", **geometry)
        done = sched.run([ServeRequest(rid=i, prompt=p, max_new=m, profile=prof())
                          for i, p, m in traffic])
        out[arm] = {r.rid: list(r.tokens) for r in done}
    for arm in out:
        assert out[arm] == out["contiguous"], arm


def test_pools_agree_under_dropless_capacity(pair):
    check_cross_pool(pair)
