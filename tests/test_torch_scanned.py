"""The port's one-program decode loop and the rest of its ``kv_cache``
against the JAX package.

- ``engine.generate_scanned`` (a prefill, then one static decode step run
  once a token) against the reference's ``generate_scanned`` (``lax.scan``)
  on the f32 smoke configs of ``llama3.2-1b``, ``deepseek-v2-236b`` (MLA +
  MoE) and ``recurrentgemma-2b`` (RG-LRU blocks and local attention over a
  ring that the decode wraps), params bridged from the reference's init:
  greedy and ``top_p(0.9, 0.8)`` under the same key, the tokens identical
  up to a reference near tie (greedy: top-1/top-2 logit gap below 1e-4;
  sampled: the top-two perturbed scores, nucleus-filtered logits / T plus
  the step's Gumbel draw, below 1e-5, ``core/prng.py``'s note on
  ``gumbel``); and equal to the port's ``engine.generate`` (greedy);
- ``cache_token_bytes``, ``DynamicCache``, ``reorder`` and ``free_blocks``
  against the reference's.

The CPU runs the scanned step eagerly. The ``cuda``-marked test captures the
decode step as a CUDA graph and replays it; it skips itself without a card
and imports no JAX (the card's machine has none): ``PYTHONPATH=src python
-m pytest -q -m cuda tests/test_torch_scanned.py``."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import engine, kv_cache, prng, sampling
from repro_torch.core.slot_pool import BlockPool
from repro_torch.kernels import counts
from repro_torch.models import get_model

NEAR_TIE = {"greedy": 1e-4, "top_p": 1e-5}
ARCHS = ("llama3.2-1b", "deepseek-v2-236b", "recurrentgemma-2b")
#: prompt width and new tokens: the recurrentgemma smoke config's ring of 32
#: rows wraps at position 32, so its decode runs past the wrap
TP, NEW = 8, 30


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while the module runs: the decode loops are
    many tiny eager ops, which a thread pool only slows."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PAIRS = {}


def pair_of(arch):
    """(JAX model, JAX params, port model, port params) of ``arch``'s f32
    smoke config, the reference's init bridged, the embedding table scaled
    by ``EMBED_SCALE`` on both sides (at unit scale the random models repeat
    one token, and a sampled run would draw nearly nothing); one per arch."""
    if arch not in _PAIRS:
        from tests.test_torch_sampling import EMBED_SCALE, bridged_pair

        _PAIRS[arch] = bridged_pair(arch, EMBED_SCALE)
    return _PAIRS[arch]


def _samplers(kind):
    from repro.core import sampling as jsampling

    if kind == "greedy":
        return jsampling.greedy, sampling.greedy
    return jsampling.top_p(0.9, 0.8), sampling.top_p(0.9, 0.8)


def _ref_gaps(jmodel, jparams, prompts, want, kind, seed):
    """The reference's deciding gap of every row at every step [B, NEW]:
    its own logits, teacher-forced on its own tokens (a batch prefill, then
    batch decode steps), greedy the top-1/top-2 gap, sampled the perturbed
    top-two gap under that step's key (the key itself first, then
    ``split(key, NEW - 1)``)."""
    import jax
    import jax.numpy as jnp

    from repro.core import engine as jengine
    from tests.test_torch_sampling import batch_gaps

    b = prompts.shape[0]
    key = jax.random.PRNGKey(seed)
    keys = [key] + list(jax.random.split(key, NEW - 1))
    logits, cache = jengine.prefill(jmodel, jparams, jnp.asarray(prompts),
                                    jnp.full((b,), TP, jnp.int32), TP + NEW + 1, None)
    gaps = np.zeros((b, NEW))
    for i in range(NEW):
        if kind == "greedy":
            top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
            gaps[:, i] = top2[:, 1] - top2[:, 0]
        else:
            gaps[:, i] = batch_gaps(logits, keys[i], 0.8, 0.9)
        if i + 1 < NEW:
            logits, cache = jengine.decode_step(jmodel, jparams, cache,
                                                jnp.asarray(want[:, i], jnp.int32))
    return gaps


def _match(got, want, gaps, tie, what):
    from tests.test_torch_sampling import assert_sampled_match

    for r in range(got.shape[0]):
        assert_sampled_match(got[r], want[r], lambda k, r=r: float(gaps[r, k]),
                             f"{what} row {r}", tie=tie)


@pytest.mark.parametrize("kind", ["greedy", "top_p"])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_scanned_matches_jax(arch, kind):
    import jax
    import jax.numpy as jnp

    from repro.core import engine as jengine

    jmodel, jparams, model, params = pair_of(arch)
    rng = np.random.default_rng(11)
    prompts = rng.integers(0, model.config.vocab_size, size=(3, TP)).astype(np.int32)
    jsampler, sampler = _samplers(kind)
    want = np.asarray(jengine.generate_scanned(jmodel, jparams, jnp.asarray(prompts),
                                               max_new_tokens=NEW, sampler=jsampler,
                                               key=jax.random.PRNGKey(7)))
    got = engine.generate_scanned(model, params, torch.from_numpy(prompts),
                                  max_new_tokens=NEW, sampler=sampler, key=prng.PRNGKey(7))
    assert got.shape == (3, NEW) and got.dtype == torch.int32
    got = got.numpy()
    if kind == "top_p":
        assert len(set(want.ravel().tolist())) > 5  # the samples do vary
    if not np.array_equal(got, want):
        _match(got, want, _ref_gaps(jmodel, jparams, prompts, want, kind, 7), NEAR_TIE[kind],
               f"{arch} {kind}")


def test_generate_scanned_equals_generate_and_counts_nothing_on_cpu():
    """The counterpart of ``tests/test_system.py``'s scanned-vs-loop test: the
    scanned loop's greedy tokens are ``generate``'s, bit for bit (the same
    step on the same weights); on the CPU no kernel counter moves."""
    _, _, model, params = pair_of("llama3.2-1b")
    rng = np.random.default_rng(3)
    prompts = torch.from_numpy(rng.integers(0, 512, size=(2, 6)).astype(np.int32))
    before = counts.snapshot()
    got = engine.generate_scanned(model, params, prompts, max_new_tokens=9)
    want = engine.generate(model, params, prompts, max_new_tokens=9)["tokens"]
    assert torch.equal(got, want)
    assert counts.since(before) == dict.fromkeys(before, 0)
    one = engine.generate_scanned(model, params, prompts, max_new_tokens=1)
    assert torch.equal(one, want[:, :1])


# --------------------------------------------------------------------------
# kv_cache
# --------------------------------------------------------------------------

def _jcache_np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("which", ["contiguous", "paged", "mla", "empty", "lengths"])
def test_cache_token_bytes_matches_jax(which):
    from repro.configs import SMOKE_CONFIGS
    from repro.core import kv_cache as jkv
    from repro.core.slot_pool import BlockPool as JBlockPool
    from repro.models import get_model as jget_model

    arch = "deepseek-v2-236b" if which == "mla" else "llama3.2-1b"
    jmodel = jget_model(SMOKE_CONFIGS[arch])
    model = get_model(get_smoke_config(arch))
    if which == "paged":
        jc = JBlockPool(jmodel, 3, 20, block_size=4, num_blocks=9).cache
        tc = BlockPool(model, 3, 20, "cpu", block_size=4, num_blocks=9).cache
    else:
        jc, tc = jmodel.init_cache(2, 16), model.init_cache(2, 16, "cpu")
    if which == "empty":
        jc, tc = {}, {}
    elif which == "lengths":
        jc, tc = {"lengths": jc["lengths"]}, {"lengths": tc["lengths"]}
    want = jkv.cache_token_bytes(jc)
    assert kv_cache.cache_token_bytes(tc) == want
    assert kv_cache.cache_bytes(tc) == jkv.cache_bytes(jc)
    if which in ("empty", "lengths"):
        assert want == 0.0


def test_dynamic_cache_matches_jax():
    import jax.numpy as jnp

    from repro.core import kv_cache as jkv

    rng = np.random.default_rng(0)
    jd, td = jkv.DynamicCache(), kv_cache.DynamicCache()
    assert td.seq_len == jd.seq_len == 0
    for step, t in enumerate((5, 1, 1, 3)):
        for layer in (0, 1):
            k = rng.standard_normal((2, t, 2, 4)).astype(np.float32)
            v = rng.standard_normal((2, t, 2, 4)).astype(np.float32)
            jk, jv = jd.append(layer, jnp.asarray(k), jnp.asarray(v))
            tk, tv = td.append(layer, torch.from_numpy(k), torch.from_numpy(v))
            np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert td.seq_len == jd.seq_len == 5 + step + (2 if step == 3 else 0)


def test_reorder_matches_jax_and_keeps_the_input():
    import jax.numpy as jnp

    from repro.core import kv_cache as jkv

    rng = np.random.default_rng(1)
    cache = {"lengths": rng.integers(0, 9, size=4).astype(np.int32),
             "layers": [{"k": rng.standard_normal((4, 6, 2, 3)).astype(np.float32),
                         "v": rng.standard_normal((4, 6, 2, 3)).astype(np.float32)}]}
    idx = np.array([2, 2, 0, 3], np.int32)
    tc = kv_cache._map(torch.from_numpy, cache)
    got = kv_cache.reorder(tc, torch.from_numpy(idx))
    want = jkv.reorder(_jcache_np(cache), jnp.asarray(idx))
    for g, w in zip(kv_cache.sorted_leaves(got), kv_cache.sorted_leaves(_jcache_np(want))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # functional: the input cache is untouched
    np.testing.assert_array_equal(tc["layers"][0]["k"].numpy(), cache["layers"][0]["k"])
    assert got["layers"][0]["k"].data_ptr() != tc["layers"][0]["k"].data_ptr()


def test_free_blocks_matches_jax_in_place():
    import jax.numpy as jnp

    from repro.core import kv_cache as jkv

    lengths = np.array([5, 7, 0, 3], np.int32)
    mask = np.array([True, False, True, True])
    pool = {"lengths": torch.from_numpy(lengths.copy())}
    ptr = pool["lengths"].data_ptr()
    got = kv_cache.free_blocks(pool, torch.from_numpy(mask))
    want = jkv.free_blocks({"lengths": jnp.asarray(lengths)}, jnp.asarray(mask))
    np.testing.assert_array_equal(got["lengths"].numpy(), np.asarray(want["lengths"]))
    assert got["lengths"].data_ptr() == ptr


# --------------------------------------------------------------------------
# on the card: the captured step replays bit for bit
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["greedy", "top_p"])
def test_captured_decode_step_replays_bit_equal_on_card(kind):
    """A small bf16 llama (D 64) on the card: ``generate_scanned``'s
    captured loop gives the tokens of the same ``ScannedStep`` run eagerly,
    the kernel counters advance by exactly the eager loop's launches, and a
    step with a host sync refuses to capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core import graphs

    dev = torch.device("cuda")
    cfg = get_smoke_config("llama3.2-1b").replace(n_heads=4, n_kv_heads=2, d_model=256,
                                                   n_layers=3)
    model = get_model(cfg)
    with torch.inference_mode():
        params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    prompts = torch.randint(0, cfg.vocab_size, (4, 12), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev, dtype=torch.int32)
    sampler = sampling.greedy if kind == "greedy" else sampling.top_p(0.9, 0.8)
    key = prng.PRNGKey(3)
    before = counts.snapshot()
    got = engine.generate_scanned(model, params, prompts, max_new_tokens=10, sampler=sampler,
                                  key=key)
    launched = counts.since(before)
    # the same step, run eagerly (no capture) from the same prefill
    with torch.inference_mode():
        logits, cache = engine.prefill(model, params, prompts,
                                       torch.full((4,), 12, dtype=torch.int32, device=dev), 23)
        out = torch.zeros((4, 10), dtype=torch.int32, device=dev)
        token = sampler(logits, key.to(dev)).to(torch.int32)
        out[:, 0] = token
        step = engine.ScannedStep(model, params, cache, token, out,
                                  prng.split(key, 9).to(dev), sampler, "auto")
        before = counts.snapshot()
        for _ in range(9):
            step()
    eager = counts.since(before)
    assert torch.equal(got, out), (got, out)
    assert eager["decode_attention"] == 9 * cfg.n_layers
    assert launched["decode_attention"] == eager["decode_attention"]
    assert launched["flash_attention"] == cfg.n_layers  # the prefill
    assert launched["rmsnorm"] == eager["rmsnorm"] + (2 * cfg.n_layers + 1)

    def bad():
        with torch.inference_mode():
            int(step.token.sum())  # a host sync: no graph can hold it
            step()

    with torch.inference_mode():
        step.i.zero_()  # the keys' first row again: the warm-up indexes them
    with pytest.raises(Exception):
        graphs.capture(bad)
    torch.cuda.synchronize()
    # the program goes on, on its own stream, and allocates outside the pool
    assert torch.cuda.current_stream() == torch.cuda.default_stream()
    assert torch.ones(1, device=dev).add(1).item() == 2.0
