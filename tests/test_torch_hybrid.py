"""The port's hybrid slice vs the JAX package: the RG-LRU (against the
reference's ``_rg_lru`` and a sequential loop), the recurrent block, the
ring-buffer K/V caches (``write_prefill`` past the window,
``init_attention_cache(window=)``), the f32 ``recurrentgemma-2b`` smoke
model (params bridged from the reference's ``init(PRNGKey(0))``) in train,
prefill and decode modes with a prompt longer than the window 32 and
decode past the ring's wrap, greedy generation, the continuous and fixed
schedulers at ``pad_to`` below and above the window, the paged, chunked and
speculative refusals and the launcher. Also the dense sliding-window
variant (``llama3.2-1b`` ``CONFIG_SWA``), which runs on the same rings.

Tolerances: the RG-LRU at atol 1e-5 / rtol 1e-4 (``tests/test_property.py``:
the log-depth scan and the reference's associative scan sum in another
order), logits at atol 1e-4 / rtol 1e-3 (matmuls and the f32 unembed sum in
another order in XLA and PyTorch). Greedy tokens and the schedulers' host
bookkeeping must match exactly; a token divergence passes only where the
reference's top-1/top-2 gap is below 1e-4, and is reported. The
reference's pad-in-ring behaviour (a right-padded prompt longer than the
window keeps the padded row's last S entries, and the scan folds the pads
into the state) is reproduced and pinned, not fixed."""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_CONFIGS
from repro.configs import llama3_2_1b as jllama
from repro.core import engine as jengine
from repro.core import sampling as jsampling
from repro.core.scheduler import Scheduler as JScheduler
from repro.core.scheduler import ServeRequest as JRequest
from repro.models import attention as JA
from repro.models import get_model as jget_model
from repro.models import hybrid as JH
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.configs import llama3_2_1b as tllama
from repro_torch.core import engine, profiles
from repro_torch.core.scheduler import Scheduler, ServeRequest
from repro_torch.core.slot_pool import BlockPool
from repro_torch.launch import serve
from repro_torch.models import attention as A
from repro_torch.models import get_model
from repro_torch.models import hybrid as H

ARCH = "recurrentgemma-2b"
LRU = dict(atol=1e-5, rtol=1e-4)
LOGITS = dict(atol=1e-4, rtol=1e-3)
WINDOW = 32  # the smoke config's
NEAR_TIE = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while the module runs: its serving loops are
    thousands of tiny eager ops, which a thread pool only slows."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    jcfg = SMOKE_CONFIGS[ARCH].replace(dtype="float32")
    jmodel = jget_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = get_smoke_config(ARCH).replace(dtype="float32")
    tparams = bridge.params_to_torch(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jmodel, jparams, tcfg, get_model(tcfg), tparams


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               **tol)


def test_configs_are_the_reference():
    from repro.configs import CONFIGS as JCONFIGS
    from repro_torch.configs import get_config

    for port, ref in ((get_config(ARCH), JCONFIGS[ARCH]),
                      (get_smoke_config(ARCH), SMOKE_CONFIGS[ARCH])):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.n_params() == ref.n_params()
    smoke = get_smoke_config(ARCH)
    assert smoke.hybrid.window == WINDOW
    assert [smoke.hybrid.block_kind(i) for i in range(3)] == ["recurrent", "recurrent",
                                                               "attention"]


# ---------------------------------------------------------------- RG-LRU
def _lru_params(rng, w):
    return {"gate_a": {"w": rng.standard_normal((w, w)).astype(np.float32) * 0.3,
                       "b": rng.standard_normal(w).astype(np.float32) * 0.1},
            "gate_x": {"w": rng.standard_normal((w, w)).astype(np.float32) * 0.3,
                       "b": rng.standard_normal(w).astype(np.float32) * 0.1},
            "lam": rng.standard_normal(w).astype(np.float32)}


def _sequential(p, x, h0):
    """The recurrence one step at a time, in float64."""
    x = x.astype(np.float64)
    r = 1 / (1 + np.exp(-(x @ p["gate_a"]["w"] + p["gate_a"]["b"])))
    i = 1 / (1 + np.exp(-(x @ p["gate_x"]["w"] + p["gate_x"]["b"])))
    a = np.exp(-8.0 * np.log1p(np.exp(p["lam"].astype(np.float64)))[None, None] * r)
    gated = np.sqrt(np.maximum(1 - a * a, 1e-12)) * (i * x)
    h = np.zeros((x.shape[0], x.shape[2])) if h0 is None else h0.astype(np.float64)
    hs = []
    for j in range(x.shape[1]):
        h = a[:, j] * h + gated[:, j]
        hs.append(h)
    return np.stack(hs, axis=1)


@pytest.mark.parametrize("tt", [1, 2, 5, 37])
@pytest.mark.parametrize("carried", [False, True])
def test_rg_lru_matches_jax_and_a_loop(tt, carried):
    rng = np.random.default_rng(tt + 100 * carried)
    b, w = 2, 16
    p = _lru_params(rng, w)
    x = rng.standard_normal((b, tt, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32) if carried else None
    jh, jlast = JH._rg_lru(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                           None if h0 is None else jnp.asarray(h0))
    th, tlast = H._rg_lru(jax.tree.map(t, p), t(x), None if h0 is None else t(h0))
    assert th.dtype == torch.float32 and th.shape == (b, tt, w)
    close(th, jh, LRU)
    close(tlast, jlast, LRU)
    close(th, _sequential(p, x, h0), LRU)


def test_linear_scan_leaves_its_inputs_and_takes_log_depth(monkeypatch):
    """The scan keeps a and b; it runs ceil(log2 T) rounds."""
    rng = np.random.default_rng(0)
    a, b = (t(rng.random((2, 37, 4)).astype(np.float32)) for _ in range(2))
    a0, b0 = a.clone(), b.clone()
    got = H.linear_scan(a, b)
    assert torch.equal(a, a0) and torch.equal(b, b0)
    want = np.zeros((2, 4))
    for j in range(37):
        want = a0[:, j].double().numpy() * want + b0[:, j].double().numpy()
    close(got[:, -1], want, LRU)
    rounds = []
    real_mul = torch.Tensor.__mul__
    monkeypatch.setattr(torch.Tensor, "__mul__",
                        lambda x, y: rounds.append(1) or real_mul(x, y))
    H.linear_scan(a, b)
    assert len(rounds) == 2 * 6  # two products a round, ceil(log2 37) = 6 rounds


def test_lam_is_the_reference_deterministic_init(pair):
    jcfg = pair[0]
    want = np.asarray(JH.init_recurrent_block(jax.random.PRNGKey(3), jcfg)["lam"])
    got = H.lam_init(jcfg.hybrid.lru_width, "cpu")
    assert got.dtype == torch.float32
    close(got, want, dict(atol=1e-6, rtol=1e-5))


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_recurrent_block_matches_jax(pair, mode):
    """Layer 0's recurrent block on its own: prefill (conv from zeros, the
    state from none) and a decode step from a random carried state and conv
    tail: outputs, new state and new tail."""
    jcfg, _, jparams, tcfg, _, tparams = pair
    rng = np.random.default_rng(7)
    b, tt = (2, 9) if mode == "prefill" else (2, 1)
    x = rng.standard_normal((b, tt, jcfg.d_model)).astype(np.float32)
    w = jcfg.hybrid.lru_width
    cache = {"state": rng.standard_normal((b, w)).astype(np.float32),
             "conv": rng.standard_normal((b, jcfg.hybrid.conv_width - 1, w)).astype(np.float32)}
    jout, jc = JH.recurrent_block_forward(jcfg, jparams["layers"][0]["rec"], jnp.asarray(x),
                                          cache=jax.tree.map(jnp.asarray, cache), mode=mode)
    tout, tc = H.recurrent_block_forward(tcfg, tparams["layers"][0]["rec"], t(x),
                                         cache=jax.tree.map(t, cache), mode=mode)
    close(tout, jout, LOGITS)
    close(tc["state"], jc["state"], LRU)
    close(tc["conv"], jc["conv"], LOGITS)


# ------------------------------------------------------------ ring caches
@pytest.mark.parametrize("tt,s", [(5, 8), (8, 8), (13, 8), (16, 8), (29, 8)])
def test_write_prefill_ring_matches_jax(tt, s):
    """T <= S: the row written at offset 0, the rest zeroed; T > S: the
    last S tokens, token t at row t % S."""
    rng = np.random.default_rng(tt)
    buf = rng.standard_normal((2, s, 1, 4)).astype(np.float32)
    new = rng.standard_normal((2, tt, 1, 4)).astype(np.float32)
    want = np.asarray(JA.write_prefill(jnp.asarray(buf), jnp.asarray(new)))
    got = A.write_prefill(t(buf), t(new))
    np.testing.assert_array_equal(got.numpy(), want)
    if tt > s:
        for pos in range(tt - s, tt):
            np.testing.assert_array_equal(got[:, pos % s].numpy(), new[:, pos])


@pytest.mark.parametrize("max_len,window", [(20, 32), (40, 32), (40, None)])
def test_init_attention_cache_window_matches_jax(pair, max_len, window):
    jcfg, tcfg = pair[0], pair[3]
    jc = JA.init_attention_cache(jcfg, 3, max_len, window=window)
    tc = A.init_attention_cache(tcfg, 3, max_len, "cpu", window=window)
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == jc[name].shape
        assert tc[name].shape[1] == (min(max_len, window) if window else max_len)


@pytest.mark.parametrize("mode,paged", [("verify", False), ("mixed", True), ("decode", True)])
def test_window_refused_before_any_write(pair, mode, paged):
    """Verify, mixed and paged caches keep refusing a window (as the
    reference's ``attention``), before anything is written."""
    _, _, _, tcfg, _, tparams = pair
    p = tparams["layers"][2]["attn"]
    b, c = 2, 3 if mode != "decode" else 1
    x = torch.randn(b, c, tcfg.d_model)
    if paged:
        cache = {"k": torch.randn(6, 4, 1, tcfg.head_dim), "v": torch.randn(6, 4, 1, tcfg.head_dim),
                 "bt": torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)}
    else:
        cache = A.init_attention_cache(tcfg, b, 16, "cpu", window=WINDOW)
        cache["k"].normal_()
    before = {k: v.clone() for k, v in cache.items()}
    lengths = torch.tensor([3, 5], dtype=torch.int32)
    pos = lengths[:, None] + torch.arange(c)[None]
    with pytest.raises(NotImplementedError, match="ring/window"):
        A.attention(tcfg, p, x, positions=pos, lengths=lengths, cache=cache, mode=mode,
                    window=WINDOW, t_new=torch.full((b,), c, dtype=torch.int32))
    for k, v in cache.items():
        assert torch.equal(v, before[k]), k


# ------------------------------------------------------------------ model
def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _paths(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _paths(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_and_init_agree_on_names_shapes_dtypes(dtype):
    """Bridged reference params, the port's own init and the reference
    tree name the same leaves with the same shapes and types (``lam`` and
    the recurrent state f32 in a bf16 model); the caches too."""
    jcfg = SMOKE_CONFIGS[ARCH].replace(dtype=dtype)
    tcfg = get_smoke_config(ARCH).replace(dtype=dtype)
    jmodel = jget_model(jcfg)
    np_params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(1)))
    bridged = _paths(bridge.params_to_torch(tcfg, np_params, "cpu"))
    own_tree = get_model(tcfg).init(torch.Generator().manual_seed(0), "cpu")
    own = _paths(own_tree)
    ref_paths = _paths(np_params)
    extra = {"/embed/table_f32"} if dtype == "bfloat16" else set()
    assert set(bridged) == set(own) == set(ref_paths) | extra
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    for name, a in ref_paths.items():
        want = torch.float32 if name.endswith("/lam") else tdt
        assert bridged[name].dtype == own[name].dtype == want, name
        assert tuple(bridged[name].shape) == a.shape == tuple(own[name].shape), name
    for i, lp in enumerate(own_tree["layers"]):
        assert ("attn" in lp) == (tcfg.hybrid.block_kind(i) == "attention")
    jcache = _paths(bridge.cache_to_torch(jax.tree.map(np.asarray, jmodel.init_cache(2, 50)),
                                          "cpu"))
    own_cache = _paths(get_model(tcfg).init_cache(2, 50, "cpu"))
    assert set(jcache) == set(own_cache)
    for name, a in jcache.items():
        assert a.shape == own_cache[name].shape and a.dtype == own_cache[name].dtype, name
    assert own_cache["/layers/2/k"].shape[1] == WINDOW  # the ring, not max_len


@pytest.mark.parametrize("tp,plen,n_dec", [(40, (40, 23), 30), (12, (12, 7), 30)])
def test_forward_train_prefill_decode_match_jax(pair, tp, plen, n_dec):
    """Train logits; prefill (cache) logits, rings, states, conv tails and
    lengths; then decode steps past the ring's wrap (40 + 30 and 12 + 30
    positions over a ring of 32), every step's logits and cache against the
    reference."""
    jcfg, jmodel, jparams, _, tmodel, tparams = pair
    rng = np.random.default_rng(tp)
    b = 2
    toks = rng.integers(0, jcfg.vocab_size, size=(b, tp)).astype(np.int32)
    jlog, _, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)}, mode="train")
    with torch.inference_mode():
        tlog, _, _ = tmodel.forward(tparams, {"tokens": t(toks)}, mode="train")
    close(tlog, jlog, LOGITS)

    plen = np.array(plen, np.int32)
    max_len = tp + n_dec + 1
    jc = jmodel.init_cache(b, max_len)
    tc = tmodel.init_cache(b, max_len, "cpu")
    batch = {"tokens": toks, "prompt_lengths": plen}
    jlog, jc, _ = jmodel.forward(jparams, jax.tree.map(jnp.asarray, batch), cache=jc,
                                 mode="prefill")
    with torch.inference_mode():
        tlog, tc, _ = tmodel.forward(tparams, jax.tree.map(t, batch), cache=tc, mode="prefill")
    close(tlog, jlog, LOGITS)

    def same_cache():
        np.testing.assert_array_equal(tc["lengths"].numpy(), np.asarray(jc["lengths"]))
        for tl, jl in zip(tc["layers"], jc["layers"]):
            assert set(tl) == set(jl)
            for name in tl:
                close(tl[name], jl[name], LRU if name == "state" else LOGITS)

    same_cache()
    for _ in range(n_dec):
        nxt = rng.integers(0, jcfg.vocab_size, size=(b, 1)).astype(np.int32)
        jlog, jc, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(nxt)}, cache=jc,
                                     mode="decode")
        with torch.inference_mode():
            tlog, tc, _ = tmodel.forward(tparams, {"tokens": t(nxt)}, cache=tc, mode="decode")
        close(tlog, jlog, LOGITS)
        same_cache()
    assert int(tc["lengths"].max()) > WINDOW


def test_prefill_then_decode_equals_full_forward(pair):
    """The port alone: prefill of 20 tokens and 30 decode steps over a ring
    of 32 give the windowed full forward's logits at those positions."""
    _, _, _, tcfg, tmodel, tparams = pair
    toks = t(np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, 50)).astype(np.int32))
    with torch.inference_mode():
        full, _, _ = tmodel.forward(tparams, {"tokens": toks}, mode="train")
        cache = tmodel.init_cache(2, 51, "cpu")
        pf, cache, _ = tmodel.forward(tparams, {"tokens": toks[:, :20]}, cache=cache,
                                      mode="prefill")
        atol = 2e-4 * max(float(full.abs().max()), 1.0)
        close(pf, full[:, :20].numpy(), dict(atol=atol, rtol=0))
        for i in range(30):
            dl, cache, _ = tmodel.forward(tparams, {"tokens": toks[:, 20 + i:21 + i]},
                                          cache=cache, mode="decode")
            close(dl[:, 0], full[:, 20 + i].numpy(), dict(atol=atol, rtol=0))
    assert cache["layers"][2]["k"].shape[1] == WINDOW and int(cache["lengths"][0]) == 50


# ------------------------------------------------------------- serving
def _ref_gap(jmodel, jparams, prompt, prefix, pad_to) -> float:
    """The reference's top-1/top-2 gap for the token after prompt + prefix,
    the prompt right-padded to ``pad_to`` as the scheduler pads it (the
    pads enter the state and, past the window, the ring)."""
    buf = np.zeros((1, pad_to), np.int32)
    buf[0, : len(prompt)] = prompt
    logits, cache = jengine.prefill(jmodel, jparams, jnp.asarray(buf),
                                    jnp.asarray([len(prompt)], jnp.int32),
                                    pad_to + len(prefix) + 2, None)
    for tok in prefix:
        logits, cache = jengine.decode_step(jmodel, jparams, cache,
                                            jnp.asarray([int(tok)], jnp.int32))
    top2 = np.sort(np.asarray(logits[0]))[-2:]
    return float(top2[1] - top2[0])


def assert_tokens_match(got, want, gap_at, what: str) -> None:
    got, want = [int(x) for x in got], [int(x) for x in want]
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            gap = gap_at(i)
            assert gap < NEAR_TIE, f"{what}: token {i} is {g}, the reference's {w} (gap {gap})"
            print(f"{what}: near-tie divergence at token {i} (gap {gap:.2e})")
            return
    assert len(got) == len(want), f"{what}: {len(got)} tokens vs {len(want)}"


def _prompts(n, seed, vocab, pad_to):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(3, pad_to + 1))) for _ in range(n)]


def test_generate_greedy_matches_jax(pair):
    """Three prompts right-padded to 40 (past the window), 24 new tokens."""
    _, jmodel, jparams, _, model, params = pair
    pad = 40
    prompts = _prompts(3, 5, 512, pad)
    buf = np.zeros((3, pad), np.int32)
    for i, p in enumerate(prompts):
        buf[i, : len(p)] = p
    plen = np.array([len(p) for p in prompts], np.int32)
    want = jengine.generate(jmodel, jparams, jnp.asarray(buf),
                            prompt_lengths=jnp.asarray(plen), max_new_tokens=24,
                            sampler=jsampling.greedy)
    got = engine.generate(model, params, torch.from_numpy(buf),
                          prompt_lengths=torch.from_numpy(plen), max_new_tokens=24)
    assert got["tokens"].shape == (3, 24) and got["n_steps"] == want["n_steps"]
    wt = np.asarray(want["tokens"])
    for i in range(3):
        assert_tokens_match(got["tokens"][i].numpy(), wt[i],
                            lambda k, i=i: _ref_gap(jmodel, jparams, prompts[i], wt[i][:k], pad),
                            f"generate row {i}")


@pytest.mark.parametrize("pad_to", [16, 48])
@pytest.mark.parametrize("policy", ["continuous", "fixed"])
def test_scheduler_matches_jax_scheduler(pair, policy, pad_to):
    """Six right-padded prompts through both schedulers with 2 slots, up to
    24 new tokens: at ``pad_to`` 16 the ring wraps while decoding, at 48
    (> window 32) the prefill is a ring write and keeps the padded row's
    last 32 entries. Tokens, finish order, prefills, decode steps and the
    occupancy trace agree."""
    _, jmodel, jparams, _, model, params = pair
    prompts = _prompts(6, 11 + pad_to, 512, pad_to)
    max_news = [5, 24, 3, 17]
    traffic = [(i, p, max_news[i % 4]) for i, p in enumerate(prompts)]
    js = JScheduler(jmodel, jparams, slots=2, pad_to=pad_to, max_new_cap=24, policy=policy)
    ts = Scheduler(model, params, slots=2, pad_to=pad_to, max_new_cap=24, policy=policy,
                   device="cpu")
    jdone = js.run([JRequest(rid=i, prompt=p, max_new=m) for i, p, m in traffic])
    tdone = ts.run([ServeRequest(rid=i, prompt=p, max_new=m) for i, p, m in traffic])
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    jtok = {r.rid: r.tokens for r in jdone}
    for r in tdone:
        prompt = traffic[r.rid][1]
        assert_tokens_match(
            r.tokens, jtok[r.rid],
            lambda k, p=prompt, w=jtok[r.rid]: _ref_gap(jmodel, jparams, p, w[:k], pad_to),
            f"{policy} pad {pad_to} request {r.rid}")
    assert (ts.n_prefills, ts.n_decode_steps) == (js.n_prefills, js.n_decode_steps)
    assert ts.occupancy_trace == js.occupancy_trace
    assert ts.pool.cache["layers"][2]["k"].shape[1] == min(WINDOW, ts.max_len)


def test_pad_past_the_window_stays_in_the_ring(pair):
    """Kept on purpose (the reference's behaviour): a 5-token prompt padded
    to 48 > window 32 keeps the padded row's positions 16..47 in the ring,
    so its decode reads pad keys and misses the real ones. The first token
    (read in flight) equals the pad-16 prefill's; the next one's logits do
    not, and the port's ring and state equal the reference's."""
    _, jmodel, jparams, _, model, params = pair
    prompt = np.array([5, 9, 13, 200, 7], np.int32)
    first, second, caches = {}, {}, {}
    for pad in (16, 48):
        buf = np.zeros((1, pad), np.int32)
        buf[0, :5] = prompt
        with torch.inference_mode():
            lg, cache = engine.prefill(model, params, torch.from_numpy(buf),
                                       torch.tensor([5], dtype=torch.int32), pad + 4)
            first[pad] = lg
            nxt, cache = engine.decode_step(model, params, cache, torch.tensor([11]))
        second[pad] = nxt
        caches[pad] = cache
        jlg, jc = jengine.prefill(jmodel, jparams, jnp.asarray(buf), jnp.asarray([5], jnp.int32),
                                  pad + 4, None)
        jnxt, jc = jengine.decode_step(jmodel, jparams, jc, jnp.asarray([11], jnp.int32))
        close(nxt, jnxt, LOGITS)
        for tl, jl in zip(cache["layers"], jc["layers"]):
            for name in tl:
                close(tl[name], jl[name], LRU if name == "state" else LOGITS)
    torch.testing.assert_close(first[16], first[48])
    assert not torch.allclose(second[16], second[48], atol=1e-3)
    assert not torch.allclose(caches[16]["layers"][0]["state"], caches[48]["layers"][0]["state"])


def test_paged_chunked_and_speculative_are_refused(pair):
    """The paged pool refuses the family (hence chunked prefill, which
    needs it), and a speculative request is refused at submit, with the
    reference's ``ValueError``, before any step."""
    _, jmodel, jparams, _, model, params = pair
    with pytest.raises(NotImplementedError, match="paged pool"):
        BlockPool(model, 2, 40, "cpu")
    with pytest.raises(NotImplementedError, match="paged pool"):
        Scheduler(model, params, slots=2, pad_to=16, max_new_cap=8, paged=True, device="cpu")
    with pytest.raises(NotImplementedError, match="paged pool"):
        Scheduler(model, params, slots=2, pad_to=16, max_new_cap=8, paged=True, chunked=True,
                  device="cpu")
    with pytest.raises(ValueError, match="chunked prefill requires the paged"):
        Scheduler(model, params, slots=2, pad_to=16, max_new_cap=8, chunked=True, device="cpu")
    from repro.core import profiles as jprofiles

    ts = Scheduler(model, params, slots=2, pad_to=16, max_new_cap=8, device="cpu")
    js = JScheduler(jmodel, jparams, slots=2, pad_to=16, max_new_cap=8)
    prompt = np.arange(1, 6, dtype=np.int32)
    with pytest.raises(ValueError, match="rollback-able"):
        ts.submit([ServeRequest(rid=0, prompt=prompt, max_new=4,
                                profile=profiles.SpeculativeProfile(exit_layer=1))])
    with pytest.raises(ValueError, match="rollback-able"):
        js.submit([JRequest(rid=0, prompt=prompt, max_new=4,
                            profile=jprofiles.SpeculativeProfile(exit_layer=1))])
    assert ts.n_decode_steps == 0 and not ts.waiting


def test_serve_main_hybrid_on_cpu(capsys):
    m = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--n-requests", "4",
                    "--batch-slots", "2", "--max-new", "4"])
    out = capsys.readouterr().out
    assert re.search(r"\[serve/continuous\] 4 requests in .* tok/s \| occupancy=", out)
    assert m["n_requests"] == 4 and m["total_tokens"] == 16 and m["device"] == "cpu"


def test_serve_main_hybrid_paged_exits_with_the_refusal():
    with pytest.raises(SystemExit, match="paged pool"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--n-requests", "2",
                    "--batch-slots", "2", "--max-new", "2", "--paged"])


# ------------------------------------------- dense sliding-window variant
def test_swa_config_is_the_reference():
    assert dataclasses.asdict(tllama.CONFIG_SWA) == dataclasses.asdict(jllama.CONFIG_SWA)
    assert tllama.CONFIG_SWA.sliding_window == 8192


@pytest.mark.parametrize("tp,plen", [(24, (24, 17)), (10, (10, 6))])
def test_swa_smoke_matches_jax_through_the_wrap(tp, plen):
    """The llama smoke config with ``sliding_window`` 16: train, prefill (24
    > 16: a ring write) and 20 decode steps past the wrap, logits and rings
    against the reference's ``transformer.forward`` with the same window."""
    jcfg = SMOKE_CONFIGS["llama3.2-1b"].replace(dtype="float32", sliding_window=16)
    tcfg = get_smoke_config("llama3.2-1b").replace(dtype="float32", sliding_window=16)
    jmodel = jget_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = get_model(tcfg)
    tparams = bridge.params_to_torch(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(tp)
    b = 2
    toks = rng.integers(0, jcfg.vocab_size, size=(b, tp)).astype(np.int32)
    jlog, _, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)}, mode="train")
    with torch.inference_mode():
        tlog, _, _ = tmodel.forward(tparams, {"tokens": t(toks)}, mode="train")
    close(tlog, jlog, LOGITS)
    batch = {"tokens": toks, "prompt_lengths": np.array(plen, np.int32)}
    jc = jmodel.init_cache(b, tp + 21)
    tc = tmodel.init_cache(b, tp + 21, "cpu")
    assert tc["layers"][0]["k"].shape[1] == 16
    jlog, jc, _ = jmodel.forward(jparams, jax.tree.map(jnp.asarray, batch), cache=jc,
                                 mode="prefill")
    with torch.inference_mode():
        tlog, tc, _ = tmodel.forward(tparams, jax.tree.map(t, batch), cache=tc, mode="prefill")
    close(tlog, jlog, LOGITS)
    for _ in range(20):
        nxt = rng.integers(0, jcfg.vocab_size, size=(b, 1)).astype(np.int32)
        jlog, jc, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(nxt)}, cache=jc,
                                     mode="decode")
        with torch.inference_mode():
            tlog, tc, _ = tmodel.forward(tparams, {"tokens": t(nxt)}, cache=tc, mode="decode")
        close(tlog, jlog, LOGITS)
        for tl, jl in zip(tc["layers"], jc["layers"]):
            close(tl["k"], jl["k"], LOGITS)
            close(tl["v"], jl["v"], LOGITS)
