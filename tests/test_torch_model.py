"""Port layers, GQA attention and the dense transformer vs the JAX package
on the f32 llama3.2-1b smoke config: params come from the reference's
``init(PRNGKey(0))`` through ``repro_torch.bridge``; inputs are made with
numpy and handed to both sides.

Layer outputs are held at the f32 kernel tolerance (atol 2e-5 / rtol
2e-4). Whole-model logits are held at atol 1e-4 / rtol 1e-3: two layers of
matmuls plus the 512-way f32 unembed are summed in a different order by
XLA and by PyTorch, and the N(0, 1) tied embeddings make logits of size
~10-50, so the last-bit differences scale with them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_CONFIGS
from repro.models import attention as jA
from repro.models import get_model as jget_model
from repro.models import layers as jL
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention as A
from repro_torch.models import get_model
from repro_torch.models import layers as L

F32 = dict(atol=2e-5, rtol=2e-4)
LOGITS = dict(atol=1e-4, rtol=1e-3)
ARCH = "llama3.2-1b"


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


def close(got, want, tol=F32):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               **tol)


# ------------------------------------------------------------------ layers
def test_layers_match_jax(pair):
    jcfg, _, jparams, _, _, tparams = pair
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, jcfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, 7)).astype(np.int32)
    pos = (np.arange(7)[None] + np.array([[0], [5]])).astype(np.int32)
    jl, tl = jparams["layers"][0], tparams["layers"][0]

    close(L.dense(tl["attn"]["wq"], t(x)), jL.dense(jl["attn"]["wq"], jnp.asarray(x)))
    close(L.embed(tparams["embed"], t(tokens)), jL.embed(jparams["embed"], jnp.asarray(tokens)))
    close(L.unembed(tparams["embed"], t(x)), jL.unembed(jparams["embed"], jnp.asarray(x)))
    close(L.rmsnorm(tl["attn_norm"], t(x), jcfg.rmsnorm_eps),
          jL.rmsnorm(jl["attn_norm"], jnp.asarray(x), jcfg.rmsnorm_eps))
    close(L.ffn(tl["ffn"], t(x)), jL.ffn(jl["ffn"], jnp.asarray(x)))
    heads = x.reshape(2, 7, 8, 32)
    close(L.apply_rope(t(heads), t(pos), jcfg.rope_theta),
          jL.apply_rope(jnp.asarray(heads), jnp.asarray(pos), jcfg.rope_theta))
    close(L.rope_frequencies(32, jcfg.rope_theta), jL.rope_frequencies(32, jcfg.rope_theta))


# --------------------------------------------------------------- attention
def test_gqa_attention_prefill_then_decode_matches_jax(pair):
    jcfg, _, jparams, tcfg, _, tparams = pair
    rng = np.random.default_rng(1)
    b, tp, s = 2, 6, 12
    jl, tl = jparams["layers"][1]["attn"], tparams["layers"][1]["attn"]
    x = rng.standard_normal((b, tp, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(tp, dtype=np.int32)[None], (b, tp))
    zeros = np.zeros((b,), np.int32)

    jc = jA.init_attention_cache(jcfg, b, s)
    tc = A.init_attention_cache(tcfg, b, s, "cpu")
    jout, jc = jA.attention(jcfg, jl, jnp.asarray(x), positions=jnp.asarray(pos),
                            lengths=jnp.asarray(zeros), cache=jc, mode="prefill")
    tout, tc2 = A.attention(tcfg, tl, t(x), positions=t(pos), lengths=t(zeros),
                            cache=tc, mode="prefill")
    assert tc2["k"] is tc["k"]  # written in place
    close(tout, jout)
    close(tc2["k"], jc["k"])
    close(tc2["v"], jc["v"])

    lengths = np.array([4, 6], np.int32)  # ragged prompts: decode at 4 and 6
    for step in range(3):
        xd = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
        pd = lengths[:, None]
        jout, jc = jA.attention(jcfg, jl, jnp.asarray(xd), positions=jnp.asarray(pd),
                                lengths=jnp.asarray(lengths), cache=jc, mode="decode")
        tout, tc2 = A.attention(tcfg, tl, t(xd), positions=t(pd), lengths=t(lengths),
                                cache=tc2, mode="decode")
        close(tout, jout)
        close(tc2["k"], jc["k"])
        close(tc2["v"], jc["v"])
        lengths = lengths + 1


@pytest.mark.parametrize("mode", ["mixed", "verify", "extend"])
def test_unported_attention_modes_raise(pair, mode):
    """mixed runs over a paged cache only, and refuses a contiguous one as
    the reference does (ValueError); verify runs on either cache, and
    refuses a call without its per-slot widths; extend runs on a contiguous
    cache and refuses a paged one, as the reference does
    (NotImplementedError)."""
    _, _, _, tcfg, _, tparams = pair
    x = torch.zeros(1, 1, tcfg.d_model)
    kw = dict(positions=torch.zeros(1, 1, dtype=torch.int32),
              lengths=torch.zeros(1, dtype=torch.int32))
    cache = A.init_attention_cache(tcfg, 1, 4, "cpu")
    if mode == "extend":  # a paged layer cache carries its block table
        cache = dict(cache, bt=torch.zeros((1, 1), dtype=torch.int32))
    with pytest.raises(NotImplementedError if mode == "extend" else ValueError):
        A.attention(tcfg, tparams["layers"][0]["attn"], x, cache=cache, mode=mode, **kw)
    if mode == "extend":  # on the contiguous cache it writes the window and attends
        cache = A.init_attention_cache(tcfg, 1, 4, "cpu")
        out, new = A.attention(tcfg, tparams["layers"][0]["attn"], x + 1, cache=cache,
                               mode=mode, **kw)
        assert out.shape == x.shape and bool(new["k"][0, 0].abs().sum() > 0)
    if mode == "verify":  # with its widths it writes the window and attends
        cache = A.init_attention_cache(tcfg, 1, 4, "cpu")
        out, new = A.attention(tcfg, tparams["layers"][0]["attn"], x + 1, cache=cache,
                               mode=mode, t_new=torch.ones(1, dtype=torch.int32), **kw)
        assert out.shape == x.shape and bool(new["k"][0, 0].abs().sum() > 0)


# ------------------------------------------------------------- transformer
def test_forward_train_matches_jax(pair):
    jcfg, jmodel, jparams, _, tmodel, tparams = pair
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, size=(2, 9)).astype(np.int32)
    jlog, _, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)}, mode="train")
    tlog, _, aux = tmodel.forward(tparams, {"tokens": t(tokens)}, mode="train")
    assert tlog.dtype == torch.float32 and tlog.shape == (2, 9, jcfg.vocab_size)
    close(tlog, jlog, LOGITS)


def test_forward_prefill_ragged_then_decode_matches_jax(pair):
    """Prefill with ragged ``prompt_lengths`` (pad lanes written, masked
    later), then three decode steps: logits, K/V caches and lengths."""
    jcfg, jmodel, jparams, _, tmodel, tparams = pair
    rng = np.random.default_rng(3)
    b, tp, max_len = 3, 8, 14
    tokens = rng.integers(0, jcfg.vocab_size, size=(b, tp)).astype(np.int32)
    plen = np.array([8, 3, 5], np.int32)
    jc = jmodel.init_cache(b, max_len)
    tc = tmodel.init_cache(b, max_len, "cpu")
    jlog, jc, _ = jmodel.forward(
        jparams, {"tokens": jnp.asarray(tokens), "prompt_lengths": jnp.asarray(plen)},
        cache=jc, mode="prefill")
    with torch.inference_mode():
        tlog, tc, _ = tmodel.forward(
            tparams, {"tokens": t(tokens), "prompt_lengths": t(plen)}, cache=tc,
            mode="prefill")
    close(tlog, jlog, LOGITS)

    def same_cache():
        np.testing.assert_array_equal(tc["lengths"].numpy(), np.asarray(jc["lengths"]))
        for tl, jl in zip(tc["layers"], jc["layers"]):
            close(tl["k"], jl["k"])
            close(tl["v"], jl["v"])

    same_cache()
    for _ in range(3):
        nxt = rng.integers(0, jcfg.vocab_size, size=(b, 1)).astype(np.int32)
        jlog, jc, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(nxt)}, cache=jc,
                                     mode="decode")
        with torch.inference_mode():
            tlog, tc, _ = tmodel.forward(tparams, {"tokens": t(nxt)}, cache=tc,
                                         mode="decode")
        close(tlog, jlog, LOGITS)
        same_cache()


# ------------------------------------------------------------------ bridge
def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_paths(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_names_shapes_dtypes(dtype):
    jcfg = SMOKE_CONFIGS[ARCH].replace(dtype=dtype)
    tcfg = get_smoke_config(ARCH).replace(dtype=dtype)
    np_params = jax.tree.map(np.asarray, jget_model(jcfg).init(jax.random.PRNGKey(1)))
    bridged = _paths(bridge.params_to_torch(tcfg, np_params, "cpu"))
    own = _paths(get_model(tcfg).init(torch.Generator().manual_seed(0), "cpu"))
    ref = _paths(np_params)
    extra = {"/embed/table_f32"} if dtype == "bfloat16" else set()
    assert set(bridged) == set(own) == set(ref) | extra
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    for name, a in ref.items():
        assert tuple(bridged[name].shape) == a.shape == tuple(own[name].shape), name
        assert bridged[name].dtype == own[name].dtype == tdt, name
        np.testing.assert_array_equal(bridged[name].float().numpy(), a.astype(np.float32))
    if extra:
        assert bridged["/embed/table_f32"].dtype == torch.float32
        assert torch.equal(bridged["/embed/table_f32"], bridged["/embed/table"].float())
    jcache = jax.tree.map(np.asarray, jget_model(jcfg).init_cache(2, 5))
    tcache = _paths(bridge.cache_to_torch(jcache, "cpu"))
    own_cache = _paths(get_model(tcfg).init_cache(2, 5, "cpu"))
    assert set(tcache) == set(own_cache)
    for name, v in tcache.items():
        assert v.shape == own_cache[name].shape and v.dtype == own_cache[name].dtype


def test_bridge_unstacks_scanned_layers():
    """A ``scan_layers`` reference (params with a leading [L] axis) bridges
    to the unrolled layer list and gives the same logits."""
    jcfg = SMOKE_CONFIGS[ARCH].replace(dtype="float32", scan_layers=True)
    jmodel = jget_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(2))
    assert "scanned" in jparams
    tcfg = get_smoke_config(ARCH).replace(dtype="float32")
    tparams = bridge.params_to_torch(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    assert "scanned" not in tparams and len(tparams["layers"]) == jcfg.n_layers
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab_size, (1, 6)).astype(np.int32)
    jlog, _, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)}, mode="train")
    tlog, _, _ = get_model(tcfg).forward(tparams, {"tokens": t(tokens)}, mode="train")
    close(tlog, jlog, LOGITS)
