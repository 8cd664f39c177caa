"""The port's ``extend`` mode against the JAX package, on the f32 smoke
configs of ``llama3.2-1b`` (contiguous K/V) and ``deepseek-v2-236b`` (the
MLA latent, under dropless MoE capacity): the reference's ``init(PRNGKey(0))``
bridged, a cache prefilled by the reference and bridged, then a window of
tokens made with numpy through both packages.

- extend equals the reference's extend on the same cache (logits, every
  cache leaf, lengths), per-slot lengths with one window overhanging the
  cache: the reference's ``dynamic_update_slice`` clamps its start to
  ``S - T``, so it lands on the last T rows, over committed ones;
- extend equals a chain of decodes (``tests/test_cache.py:74``) and a
  rewind after it leaves the next decode as if it had not run (``:158``);
- ``attention.write_extend``'s clamp against the reference's, row by row;
- a paged cache and a ring (``sliding_window``) raise in both packages,
  before anything is written."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_CONFIGS
from repro.core import kv_cache as jkv
from repro.models import attention as JA
from repro.models import get_model as jget_model
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core import kv_cache
from repro_torch.models import attention as A
from repro_torch.models import get_model

ARCHS = ["llama3.2-1b", "deepseek-v2-236b"]
LOGITS = dict(atol=1e-4, rtol=1e-3)
F32 = dict(atol=2e-5, rtol=2e-4)
B, T_PROMPT, S = 3, 10, 14


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while the module runs (the ops are tiny)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(cfg):
    """The f32 config, MoE at dropless capacity (``tests/test_cache.py:22``)."""
    cfg = cfg.replace(dtype="float32")
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    return cfg


_PAIRS = {}


def pair_of(arch):
    if arch not in _PAIRS:
        jmodel = jget_model(_f32(SMOKE_CONFIGS[arch]))
        jparams = jmodel.init(jax.random.PRNGKey(0))
        tcfg = _f32(get_smoke_config(arch))
        tparams = bridge.params_to_torch(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
        _PAIRS[arch] = (jmodel, jparams, get_model(tcfg), tparams)
    return _PAIRS[arch]


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=LOGITS):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               **tol)


def _prefilled(arch, lengths, seed=1):
    """A reference cache of S rows prefilled with T_PROMPT random tokens,
    its lengths set per slot (rows past them are stale entries, masked),
    and its port copy."""
    jmodel, jparams, _, _ = pair_of(arch)
    vocab = jmodel.config.vocab_size
    toks = np.random.default_rng(seed).integers(0, vocab, (B, T_PROMPT)).astype(np.int32)
    jcache = jmodel.init_cache(B, S)
    _, jcache, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)}, cache=jcache,
                                  mode="prefill")
    jcache = dict(jcache, lengths=jnp.asarray(lengths, jnp.int32))
    return jcache, bridge.cache_to_torch(jax.tree.map(np.asarray, jcache), "cpu")


def _window(arch, w, seed=2):
    vocab = pair_of(arch)[0].config.vocab_size
    return np.random.default_rng(seed).integers(0, vocab, (B, w)).astype(np.int32)


def _clone(cache):
    return kv_cache._map(lambda x: x.clone(), cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_extend_matches_jax_on_the_same_cache(arch):
    """Slots at 3, 8 and 12 rows take a 3-token window; the last overhangs
    S = 14 and is written at rows 11..13 in both packages."""
    jmodel, jparams, model, params = pair_of(arch)
    lengths = [3, 8, 12]
    jcache, cache = _prefilled(arch, lengths)
    win = _window(arch, 3)
    jlog, jnew, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(win)}, cache=jcache,
                                   mode="extend")
    tlog, tnew, _ = model.forward(params, {"tokens": t(win)}, cache=cache, mode="extend")
    close(tlog, jlog)
    np.testing.assert_array_equal(tnew["lengths"].numpy(), np.asarray(jnew["lengths"]))
    np.testing.assert_array_equal(tnew["lengths"].numpy(), np.array(lengths) + 3)
    for tl, jl in zip(tnew["layers"], jnew["layers"]):
        for name in tl:
            close(tl[name], jl[name], F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_extend_matches_a_chain_of_decodes(arch):
    """The counterpart of ``tests/test_cache.py:74`` on the port: one
    extend over a window == that many single-token decodes (logits and the
    rows written), the window inside the cache."""
    _, _, model, params = pair_of(arch)
    lengths, w = [T_PROMPT] * B, 3
    _, cache0 = _prefilled(arch, lengths)
    win = _window(arch, w)
    ca, outs = _clone(cache0), []
    for i in range(w):
        la, ca, _ = model.forward(params, {"tokens": t(win[:, i:i + 1])}, cache=ca,
                                  mode="decode")
        outs.append(la[:, 0])
    lb, cb, _ = model.forward(params, {"tokens": t(win)}, cache=_clone(cache0),
                              mode="extend")
    for i in range(w):
        np.testing.assert_allclose(lb[:, i].numpy(), outs[i].numpy(), atol=1e-4)
    assert cb["lengths"].tolist() == ca["lengths"].tolist()
    for la_, lb_ in zip(ca["layers"], cb["layers"]):
        for name in la_:
            close(lb_[name][:, : T_PROMPT + w], la_[name][:, : T_PROMPT + w], F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_rewind_after_extend(arch):
    """The counterpart of ``tests/test_cache.py:158``: two speculative
    tokens written by extend and rewound away leave the next decode's
    logits as without them."""
    _, _, model, params = pair_of(arch)
    _, cache = _prefilled(arch, [6] * B)
    spec = _window(arch, 2, seed=3)
    nxt = _window(arch, 1, seed=4)
    lb, _, _ = model.forward(params, {"tokens": t(nxt)}, cache=_clone(cache), mode="decode")
    _, spec_cache, _ = model.forward(params, {"tokens": t(spec)}, cache=_clone(cache),
                                     mode="extend")
    rewound = kv_cache.rewind(spec_cache, cache["lengths"].clone())
    la, _, _ = model.forward(params, {"tokens": t(nxt)}, cache=rewound, mode="decode")
    np.testing.assert_allclose(la.numpy(), lb.numpy(), atol=1e-5)
    # and the reference agrees on the rewound decode
    jmodel, jparams, _, _ = pair_of(arch)
    jcache, _ = _prefilled(arch, [6] * B)
    _, jspec, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(spec)}, cache=jcache,
                                 mode="extend")
    jla, _, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(nxt)},
                               cache=jkv.rewind(jspec, jcache["lengths"]), mode="decode")
    close(la, jla)


@pytest.mark.parametrize("lengths", [[0, 5, 9], [11, 12, 14], [14, 3, 13]])
def test_write_extend_clamps_as_the_reference(lengths):
    """Every start clamped to [0, S - T] (T = 3, S = 14): an overhanging
    window is written whole over the last T rows, rows before it keep their
    values, and no slot's write reaches another's."""
    rng = np.random.default_rng(7)
    buf = rng.standard_normal((B, S, 2, 4)).astype(np.float32)
    new = rng.standard_normal((B, 3, 2, 4)).astype(np.float32)
    idx = np.array(lengths, np.int32)
    want = np.asarray(JA.write_extend(jnp.asarray(buf), jnp.asarray(new), jnp.asarray(idx)))
    got = A.write_extend(t(buf), t(new), t(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    for b, n in enumerate(lengths):
        start = min(n, S - 3)
        np.testing.assert_array_equal(want[b, start:start + 3], new[b])
        np.testing.assert_array_equal(np.delete(want[b], range(start, start + 3), axis=0),
                                      np.delete(buf[b], range(start, start + 3), axis=0))


def _paged_cache(cfg, lib):
    """A one-layer paged cache of 4 blocks of 4 rows (K/V, or MLA's
    latent) with the shared block table, in ``lib`` (jnp or torch)."""
    if cfg.mla is not None:
        layer = {"latent": np.zeros((4, 4, cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim),
                                    np.float32)}
    else:
        shape = (4, 4, cfg.n_kv_heads, cfg.head_dim)
        layer = {"k": np.zeros(shape, np.float32), "v": np.zeros(shape, np.float32)}
    cache = {"lengths": np.zeros((B,), np.int32), "block_tables": np.zeros((B, 2), np.int32),
             "layers": [dict(layer) for _ in range(cfg.n_layers)]}
    conv = jnp.asarray if lib is jnp else t
    return jax.tree.map(conv, cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_extend_refuses_paged_caches(arch):
    jmodel, jparams, model, params = pair_of(arch)
    win = _window(arch, 2)
    with pytest.raises(NotImplementedError, match="paged"):
        jmodel.forward(jparams, {"tokens": jnp.asarray(win)}, cache=_paged_cache(
            jmodel.config, jnp), mode="extend")
    cache = _paged_cache(model.config, torch)
    before = kv_cache._map(lambda x: x.clone(), cache)
    with pytest.raises(NotImplementedError, match="paged"):
        model.forward(params, {"tokens": t(win)}, cache=cache, mode="extend")
    for a, b in zip(kv_cache.leaves(cache), kv_cache.leaves(before)):
        assert torch.equal(a, b)


def test_extend_refuses_ring_caches():
    """A sliding window's ring cache (``CONFIG_SWA``'s kind) raises in both
    packages, and the port writes nothing first."""
    jmodel, jparams, model, params = pair_of("llama3.2-1b")
    jswa = jget_model(jmodel.config.replace(sliding_window=8))
    swa = get_model(model.config.replace(sliding_window=8))
    win = _window("llama3.2-1b", 2)
    jcache = jswa.init_cache(B, S)
    with pytest.raises(NotImplementedError, match="ring/window"):
        jswa.forward(jparams, {"tokens": jnp.asarray(win)}, cache=jcache, mode="extend")
    cache = swa.init_cache(B, S, "cpu")
    assert cache["layers"][0]["k"].shape[1] == 8
    with pytest.raises(NotImplementedError, match="ring/window"):
        swa.forward(params, {"tokens": t(win)}, cache=cache, mode="extend")
    assert all(float(x.abs().sum()) == 0 for x in kv_cache.leaves(cache["layers"]))
