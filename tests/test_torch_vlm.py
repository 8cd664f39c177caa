"""The port's Chameleon slice vs the JAX package, on the f32
``chameleon-smoke`` config (qk-norm, GQA 8/2): params come from the
reference's ``init(PRNGKey(0))`` through ``repro_torch.bridge``; token ids
are made with numpy and handed to both sides.

Covered: qk-norm attention in train / prefill / decode, the model's
``forward`` in all three modes, I-T greedy ``generate`` over an
image-then-text prompt, T-I ``generate_contrastive`` (every token at or
above the image offset), ``contrastive_logits``, ``image_token_mask``, the
contrastive prompt interleave and the stub tokenizer.

Attention outputs at the f32 kernel tolerance (atol 2e-5 / rtol 2e-4);
logits at atol 1e-4 / rtol 1e-3 (matmuls sum in another order in XLA and
PyTorch). Greedy and contrastive tokens must match exactly; a divergence
passes only where the reference's deciding gap (its top-1/top-2 gap, on the
mixed and masked logits for T-I) is below 1e-4, and is reported."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_CONFIGS
from repro.core import engine as jengine
from repro.core import profiles as jprofiles
from repro.core import sampling as jsampling
from repro.models import attention as jA
from repro.models import get_model as jget_model
from repro.models import vlm as jvlm
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core import engine, profiles
from repro_torch.models import attention as A
from repro_torch.models import get_model, vlm
from tests.test_torch_serve import _ref_gap, assert_tokens_match

F32 = dict(atol=2e-5, rtol=2e-4)
LOGITS = dict(atol=1e-4, rtol=1e-3)
NEAR_TIE = 1e-4
ARCH = "chameleon-34b"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while the module runs: its decode loops are many
    tiny eager ops, which a thread pool only slows beside other test
    processes."""
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


def close(got, want, tol=LOGITS):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               **tol)


def _it_prompt(cfg, rng, b, n_text):
    """[image tokens ; text tokens] with image ids in the tail range."""
    off = cfg.vocab_size - cfg.vlm.image_vocab
    img = off + rng.integers(0, cfg.vlm.image_vocab, size=(b, cfg.vlm.n_image_tokens))
    txt = rng.integers(0, off, size=(b, n_text))
    return img.astype(np.int32), txt.astype(np.int32)


# ---------------------------------------------------------------- attention
def test_qk_norm_attention_matches_jax(pair):
    """One layer's attention with its q/k norm scales (set away from 1 so
    they count) in train, prefill into a cache, and two decode steps."""
    jcfg, _, jparams, tcfg, _, tparams = pair
    jp = dict(jparams["layers"][0]["attn"])
    rng = np.random.default_rng(0)
    for name in ("q_norm", "k_norm"):
        jp[name] = {"scale": jnp.asarray(rng.uniform(0.5, 1.5, tcfg.head_dim)
                                         .astype(np.float32))}
    tp = bridge.tree_to_torch(jax.tree.map(np.asarray, jp), "cpu")
    assert set(tparams["layers"][0]["attn"]) == set(tp) == {"wq", "wk", "wv", "wo", "q_norm",
                                                             "k_norm"}
    x = rng.standard_normal((2, 7, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7))
    jout, _ = jA.attention(jcfg, jp, jnp.asarray(x), positions=jnp.asarray(pos), lengths=None,
                           cache=None, mode="train")
    tout, _ = A.attention(tcfg, tp, t(x), positions=t(pos), lengths=None, cache=None,
                          mode="train")
    close(tout, jout, F32)

    jc = jA.init_attention_cache(jcfg, 2, 10)
    tc = A.init_attention_cache(tcfg, 2, 10, "cpu")
    lengths = np.zeros(2, np.int32)
    jout, jc = jA.attention(jcfg, jp, jnp.asarray(x[:, :5]), positions=jnp.asarray(pos[:, :5]),
                            lengths=jnp.asarray(lengths), cache=jc, mode="prefill")
    tout, tc = A.attention(tcfg, tp, t(x[:, :5]), positions=t(pos[:, :5]),
                           lengths=t(lengths), cache=tc, mode="prefill")
    close(tout, jout, F32)
    lengths = np.full(2, 5, np.int32)
    for i in (5, 6):
        p1 = np.full((2, 1), i, np.int32)
        jout, jc = jA.attention(jcfg, jp, jnp.asarray(x[:, i:i + 1]), positions=jnp.asarray(p1),
                                lengths=jnp.asarray(lengths), cache=jc, mode="decode")
        tout, tc = A.attention(tcfg, tp, t(x[:, i:i + 1]), positions=t(p1), lengths=t(lengths),
                               cache=tc, mode="decode")
        close(tout, jout, F32)
        close(tc["k"], jc["k"], F32)
        lengths = lengths + 1


# ------------------------------------------------------------------ forward
def test_forward_matches_jax_in_every_mode(pair):
    """train logits; prefill of the first 20 tokens of an image-then-text
    prompt into a cache, then two decode steps."""
    jcfg, jmodel, jparams, _, tmodel, tparams = pair
    img, txt = _it_prompt(jcfg, np.random.default_rng(1), 2, 6)
    toks = np.concatenate([img, txt], axis=1)
    jlog, _, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)}, mode="train")
    tlog, _, _ = tmodel.forward(tparams, {"tokens": t(toks)}, mode="train")
    close(tlog, jlog)

    jc, tc = jmodel.init_cache(2, 24), tmodel.init_cache(2, 24, "cpu")
    jlog, jc, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks[:, :20])}, cache=jc,
                                 mode="prefill")
    tlog, tc, _ = tmodel.forward(tparams, {"tokens": t(toks[:, :20])}, cache=tc,
                                 mode="prefill")
    close(tlog, jlog)
    for i in (20, 21):
        jlog, jc, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks[:, i:i + 1])},
                                     cache=jc, mode="decode")
        tlog, tc, _ = tmodel.forward(tparams, {"tokens": t(toks[:, i:i + 1])}, cache=tc,
                                     mode="decode")
        close(tlog, jlog)
    assert tc["lengths"].tolist() == [22, 22]


# --------------------------------------------------------------------- I-T
def test_it_generate_matches_jax(pair):
    """I-T: 16 image tokens + a 4-token prompt per row (right-padded to 6),
    then 10 greedy tokens through the profile loop."""
    jcfg, jmodel, jparams, _, tmodel, tparams = pair
    rng = np.random.default_rng(2)
    img, txt = _it_prompt(jcfg, rng, 3, 6)
    txt_lens = np.array([6, 4, 5])
    prompts = [np.concatenate([img[i], txt[i, :txt_lens[i]]]) for i in range(3)]
    buf = np.asarray(vlm.build_it_input(get_smoke_config(ARCH), t(img), t(txt)))
    np.testing.assert_array_equal(buf, np.asarray(jvlm.build_it_input(jcfg, jnp.asarray(img),
                                                                      jnp.asarray(txt))))
    plen = (img.shape[1] + txt_lens).astype(np.int32)
    want = jengine.generate(jmodel, jparams, jnp.asarray(buf), prompt_lengths=jnp.asarray(plen),
                            max_new_tokens=10, sampler=jsampling.greedy)
    got = engine.generate(tmodel, tparams, t(buf), prompt_lengths=t(plen), max_new_tokens=10)
    assert got["tokens"].shape == (3, 10) and got["n_steps"] == want["n_steps"] == 10
    wt = np.asarray(want["tokens"])
    for i in range(3):
        assert_tokens_match(got["tokens"][i].numpy(), wt[i],
                            lambda k, i=i: _ref_gap(jmodel, jparams, prompts[i], wt[i][:k]),
                            f"I-T row {i}")


# --------------------------------------------------------------------- T-I
class _Recording(jprofiles.ContrastiveProfile):
    """The reference's ContrastiveProfile, recording each step's deciding
    gap: the top-1/top-2 gap of the mixed, masked logits of each group."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.gaps = []

    def step(self, state, logits, key):
        mixed = jvlm.image_token_mask(self.mask_offset, jvlm.contrastive_logits(
            logits[0::2], logits[1::2], self.guidance))
        top2 = np.sort(np.asarray(mixed), axis=1)[:, -2:]
        self.gaps.append(top2[:, 1] - top2[:, 0])
        return super().step(state, logits, key)


def test_generate_contrastive_matches_jax(pair):
    """T-I: a 5-token text prompt per row, 16 image tokens under guidance 3:
    tokens equal the reference's (up to a reported near tie), all at or
    above the image offset."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = pair
    rng = np.random.default_rng(3)
    off = vlm.image_token_offset(tcfg)
    assert off == jvlm.image_token_offset(jcfg) == 512 - 64
    prompt = rng.integers(0, off, size=(2, 5)).astype(np.int32)
    kw = dict(uncond_token=0, n_image_tokens=jcfg.vlm.n_image_tokens, guidance=3.0)
    want = jengine.generate_contrastive(jmodel, jparams, jnp.asarray(prompt), **kw)
    got = engine.generate_contrastive(tmodel, tparams, t(prompt), **kw)
    assert got["tokens"].shape == (2, 16) and got["n_steps"] == want["n_steps"] == 16
    assert bool((got["tokens"] >= off).all())
    wt = np.asarray(want["tokens"])
    if got["tokens"].tolist() != wt.tolist():
        rec = _Recording(uncond_token=0, guidance=3.0, mask_offset=off)
        jengine.run_profile(jmodel, jparams, rec, jnp.asarray(prompt), max_new_tokens=16,
                            max_len=5 + 16 + 1)
        for g in range(2):
            assert_tokens_match(got["tokens"][g].numpy(), wt[g],
                                lambda k, g=g: float(rec.gaps[k][g]), f"T-I row {g}")


def test_contrastive_maths_match_jax():
    rng = np.random.default_rng(4)
    cond, uncond = (rng.standard_normal((3, 40)).astype(np.float32) for _ in range(2))
    for g in (0.0, 1.0, 3.0):
        close(vlm.contrastive_logits(t(cond), t(uncond), g),
              jvlm.contrastive_logits(jnp.asarray(cond), jnp.asarray(uncond), g), F32)
    got = vlm.image_token_mask(30, t(cond))
    want = np.asarray(jvlm.image_token_mask(30, jnp.asarray(cond)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert bool(torch.isinf(got[:, :30]).all()) and torch.equal(got[:, 30:], t(cond[:, 30:]))


def test_contrastive_prompts_interleave_as_jax():
    """[c0, u0, c1, u1, ...] with the null prompt, lengths repeated, extra
    inputs tiled; the serving-side stream prompts the same."""
    prompt = np.array([[5, 6, 7], [8, 9, 10]], np.int32)
    lens = np.array([3, 2], np.int32)
    extra = np.arange(4, dtype=np.float32).reshape(2, 2)
    jp = jprofiles.ContrastiveProfile(uncond_token=1)
    tp = profiles.ContrastiveProfile(uncond_token=1)
    want = jp.expand_prompts(jnp.asarray(prompt), jnp.asarray(lens), {"x": jnp.asarray(extra)})
    got = tp.expand_prompts(t(prompt), t(lens), {"x": t(extra)})
    for g, w in zip(got[:2], want[:2]):
        assert g.tolist() == np.asarray(w).tolist()
    assert got[2]["x"].tolist() == np.asarray(want[2]["x"]).tolist()
    assert [p.tolist() for p in tp.stream_prompts(prompt[0])] == [
        p.tolist() for p in jp.stream_prompts(prompt[0])]
    assert profiles.n_streams_of(tp) == 2 and profiles.n_streams_of(None) == 1


def test_image_stub_and_sampling_refusal(pair):
    _, _, _, tcfg, _, _ = pair
    gen = torch.Generator().manual_seed(7)
    ids = vlm.encode_image_stub(tcfg, gen, 3)
    off = vlm.image_token_offset(tcfg)
    assert ids.shape == (3, tcfg.vlm.n_image_tokens) and ids.dtype == torch.int32
    assert bool(((ids >= off) & (ids < tcfg.vocab_size)).all())
    assert torch.equal(ids, vlm.encode_image_stub(tcfg, torch.Generator().manual_seed(7), 3))
    # sampled profiles are served now (keyed sampling); a sampled step
    # without a key is refused
    logits = torch.randn(2, tcfg.vocab_size, generator=torch.Generator().manual_seed(1))
    for prof in (profiles.SamplingProfile(temperature=0.8),
                 profiles.ContrastiveProfile(uncond_token=0, temperature=0.5)):
        state = prof.init(1, 2)
        with pytest.raises(ValueError, match="key"):
            prof.step(state, logits[: prof.n_streams], None)
