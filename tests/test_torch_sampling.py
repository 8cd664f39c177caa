"""The port's keyed sampling (``repro_torch.core.sampling``) against the JAX
package: ``slot_step_keys`` and ``window_step_keys`` bit for bit;
``sample_slots``, ``sample_window`` and the ``temperature`` / ``top_k`` /
``top_p`` samplers on fixed logits; ``engine.generate`` with nucleus
sampling at t = 0.8 (llama3.2-1b smoke, f32) and
``engine.generate_contrastive`` sampled at t = 0.8 (chameleon smoke, f32),
params bridged from the reference's ``init(PRNGKey(0))``.

The llama params have their embedding table scaled by 0.1: with the
random init's unit-variance tied table, a token's own row dominates every
logit, the model repeats its input and every sampler returns that token; the
smaller table lets the layers move the logits, so the samples vary.

Keys must match exactly. A token may differ only where the reference's
top-two perturbed scores (filtered logits / T plus its Gumbel draw) are
within 1e-5 (the Gumbel noise differs from XLA's by an ulp or two; the
logits of the two packages by f32 summation order); each such case is
reported."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_CONFIGS
from repro.core import engine as jengine
from repro.core import profiles as jprofiles
from repro.core import sampling as jsampling
from repro.models import get_model as jget_model
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core import engine, prng, sampling
from repro_torch.models import get_model

NEAR_TIE = 1e-5
EMBED_SCALE = 0.1


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while the module runs: its decode loops are many
    tiny eager ops, which a thread pool only slows beside other test
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bridged_pair(arch: str, embed_scale: float = 1.0):
    """(JAX model, JAX params, port model, port params) of ``arch``'s f32
    smoke config, the reference's init bridged, the embedding table scaled
    by ``embed_scale`` on both sides."""
    jcfg = SMOKE_CONFIGS[arch].replace(dtype="float32")
    jmodel = jget_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    if embed_scale != 1.0:
        jparams = dict(jparams, embed={k: v * embed_scale for k, v in jparams["embed"].items()})
    tcfg = get_smoke_config(arch).replace(dtype="float32")
    tparams = bridge.params_to_torch(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, get_model(tcfg), tparams


@pytest.fixture(scope="module")
def llama():
    return bridged_pair("llama3.2-1b", EMBED_SCALE)


def batch_gaps(logits, key, temp: float, top_p: float) -> np.ndarray:
    """The reference's deciding gap of each row of one batch draw: the
    top-two scores of the nucleus-filtered logits / T plus the Gumbel draw
    of ``logits``' whole shape under ``key`` (a [V] row alone: that row's
    own key, as ``sample_slots`` draws)."""
    scaled = jnp.asarray(logits, jnp.float32) / max(temp, 1e-6)
    sl = jnp.sort(scaled, axis=-1)[..., ::-1]
    probs = jax.nn.softmax(sl, axis=-1)
    keep = jnp.cumsum(probs, axis=-1) - probs < top_p
    thr = jnp.min(jnp.where(keep, sl, jnp.inf), axis=-1, keepdims=True)
    scores = np.asarray(jnp.where(scaled >= thr, scaled, -jnp.inf)
                        + jax.random.gumbel(key, scaled.shape))
    top2 = np.sort(scores, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def perturbed_gap(logits, key, temp: float, top_p: float) -> float:
    """``batch_gaps`` of one slot's logits [V] under its own key."""
    return float(batch_gaps(logits, key, temp, top_p))


def assert_sampled_match(got, want, gap_at, what: str, tie: float = NEAR_TIE) -> None:
    """Equal token lists up to the first divergence, which passes only at a
    reference near tie (``gap_at(i)`` < ``tie``) and is reported."""
    got, want = [int(x) for x in got], [int(x) for x in want]
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            gap = gap_at(i)
            assert gap < tie, f"{what}: token {i} is {g}, the reference's {w} (gap {gap})"
            print(f"{what}: near-tie divergence at token {i} (gap {gap:.2e})")
            return
    assert len(got) == len(want), f"{what}: {len(got)} tokens vs {len(want)}"


def _j(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


SLOTS = dict(rids=np.array([0, 3, 7, 11, 2**20, 5]), steps=np.array([0, 1, 9, 2, 40, 17]),
             streams=np.array([0, 0, 1, 0, 2, 1]))
TEMP = np.array([0.0, 0.8, 1.0, 0.5, 0.8, 1.7], np.float32)
TOP_P = np.array([1.0, 0.9, 0.5, 1.0, 0.95, 0.9], np.float32)


@pytest.mark.parametrize("streams", [False, True])
def test_slot_and_window_keys_bit_exact(streams):
    base = jax.random.PRNGKey(7)
    st = SLOTS["streams"] if streams else None
    want = jsampling.slot_step_keys(base, jnp.asarray(SLOTS["rids"]), jnp.asarray(SLOTS["steps"]),
                                    None if st is None else jnp.asarray(st))
    got = sampling.slot_step_keys(prng.PRNGKey(7), SLOTS["rids"], SLOTS["steps"], st)
    np.testing.assert_array_equal(got.numpy(), _j(want))
    lanes = SLOTS["steps"][:, None] + np.arange(5)[None]
    want = jsampling.window_step_keys(base, jnp.asarray(SLOTS["rids"]), jnp.asarray(lanes),
                                      None if st is None else jnp.asarray(st))
    got = sampling.window_step_keys(prng.PRNGKey(7), SLOTS["rids"], lanes, st)
    np.testing.assert_array_equal(got.numpy(), _j(want))
    # a lane's key is the key plain decoding uses for that token index
    for j in range(5):
        np.testing.assert_array_equal(
            got[:, j].numpy(),
            sampling.slot_step_keys(prng.PRNGKey(7), SLOTS["rids"], lanes[:, j], st).numpy())
    np.testing.assert_array_equal(
        sampling.request_key(prng.PRNGKey(7), 3, 1).numpy(),
        _j(jsampling.request_key(base, 3, 1)))
    # a numpy serve key folds on the host (the scheduler's path) to the same keys
    host = sampling.window_step_keys(prng.PRNGKey(7).numpy(), SLOTS["rids"], lanes, st)
    assert isinstance(host, np.ndarray)
    np.testing.assert_array_equal(host, got.numpy())
    np.testing.assert_array_equal(
        sampling.slot_step_keys(prng.PRNGKey(7).numpy(), SLOTS["rids"], SLOTS["steps"], st),
        sampling.slot_step_keys(prng.PRNGKey(7), SLOTS["rids"], SLOTS["steps"], st).numpy())


@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_sample_slots_matches_jax(scale):
    rng = np.random.default_rng(int(scale))
    b, v = len(TEMP), 512
    for seed in range(8):
        logits = (rng.normal(size=(b, v)) * scale).astype(np.float32)
        jkeys = jsampling.slot_step_keys(jax.random.PRNGKey(seed), jnp.asarray(SLOTS["rids"]),
                                         jnp.asarray(SLOTS["steps"]))
        want = np.asarray(jsampling.sample_slots(jnp.asarray(logits), jkeys, jnp.asarray(TEMP),
                                                 jnp.asarray(TOP_P)))
        keys = sampling.slot_step_keys(prng.PRNGKey(seed), SLOTS["rids"], SLOTS["steps"])
        got = sampling.sample_slots(torch.from_numpy(logits), keys, torch.from_numpy(TEMP),
                                    torch.from_numpy(TOP_P))
        assert got.dtype == torch.int32
        got = got.numpy()
        assert got[0] == logits[0].argmax()  # temperature 0 is greedy
        for r in np.nonzero(got != want)[0]:
            gap = perturbed_gap(logits[r], jkeys[r], TEMP[r], TOP_P[r])
            assert gap < NEAR_TIE, f"seed {seed} slot {r}: {got[r]} vs {want[r]} (gap {gap})"
            print(f"sample_slots near tie: seed {seed} slot {r} (gap {gap:.2e})")


def test_sample_window_matches_jax_and_sample_slots():
    rng = np.random.default_rng(9)
    b, c, v = len(TEMP), 5, 300
    lanes = SLOTS["steps"][:, None] + np.arange(c)[None]
    for seed in range(4):
        logits = (rng.normal(size=(b, c, v)) * 2).astype(np.float32)
        jkeys = jsampling.window_step_keys(jax.random.PRNGKey(seed),
                                           jnp.asarray(SLOTS["rids"]), jnp.asarray(lanes))
        want = np.asarray(jsampling.sample_window(jnp.asarray(logits), jkeys,
                                                  jnp.asarray(TEMP), jnp.asarray(TOP_P)))
        keys = sampling.window_step_keys(prng.PRNGKey(seed), SLOTS["rids"], lanes)
        got = sampling.sample_window(torch.from_numpy(logits), keys, torch.from_numpy(TEMP),
                                     torch.from_numpy(TOP_P)).numpy()
        assert got.shape == (b, c)
        for r, j in zip(*np.nonzero(got != want)):
            gap = perturbed_gap(logits[r, j], jkeys[r, j], TEMP[r], TOP_P[r])
            assert gap < NEAR_TIE, f"seed {seed} lane ({r}, {j}): gap {gap}"
            print(f"sample_window near tie: seed {seed} lane ({r}, {j}) (gap {gap:.2e})")
        # every lane samples as sample_slots would at its token index
        for j in range(c):
            np.testing.assert_array_equal(got[:, j], sampling.sample_slots(
                torch.from_numpy(logits[:, j]), keys[:, j], torch.from_numpy(TEMP),
                torch.from_numpy(TOP_P)).numpy())


@pytest.mark.parametrize("which", ["temperature", "top_k", "top_p"])
def test_batch_samplers_match_jax(which):
    make = {"temperature": lambda m: m.temperature(0.7), "top_k": lambda m: m.top_k(20, 0.9),
            "top_p": lambda m: m.top_p(0.9, 0.8)}[which]
    rng = np.random.default_rng(2)
    for seed in range(6):
        logits = (rng.normal(size=(4, 512)) * 3).astype(np.float32)
        want = np.asarray(make(jsampling)(jnp.asarray(logits), jax.random.PRNGKey(seed)))
        got = make(sampling)(torch.from_numpy(logits), prng.PRNGKey(seed))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{which} seed {seed}")
    with pytest.raises(ValueError, match="key"):
        make(sampling)(torch.from_numpy(logits), None)


class _Gaps(jprofiles.SamplingProfile):
    """The reference's sampling profile, recording each step's deciding gap
    per row (``batch_gaps`` at ``temperature`` / ``top_p``)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.gaps = []

    def step(self, state, logits, key):
        self.gaps.append(batch_gaps(logits, key, self.temperature, self.top_p))
        return super().step(state, logits, key)


def test_generate_sampled_matches_jax(llama):
    """Nucleus sampling at t = 0.8, top-p 0.9, through both ``generate``s
    with the same key: every step's key split and every token agree."""
    jmodel, jparams, model, params = llama
    rng = np.random.default_rng(5)
    buf = rng.integers(0, 512, size=(3, 8)).astype(np.int32)
    plen = np.array([8, 5, 3], np.int32)
    want = jengine.generate(jmodel, jparams, jnp.asarray(buf), prompt_lengths=jnp.asarray(plen),
                            max_new_tokens=12, sampler=jsampling.top_p(0.9, 0.8),
                            key=jax.random.PRNGKey(7))
    got = engine.generate(model, params, torch.from_numpy(buf),
                          prompt_lengths=torch.from_numpy(plen), max_new_tokens=12,
                          sampler=sampling.top_p(0.9, 0.8), key=prng.PRNGKey(7))
    wt = np.asarray(want["tokens"])
    assert len({int(x) for x in wt.ravel()}) > 3  # the samples do vary
    if got["tokens"].tolist() != wt.tolist():
        rec = _Gaps(temperature=0.8, top_p=0.9, sampler=jsampling.top_p(0.9, 0.8))
        jengine.run_profile(jmodel, jparams, rec, jnp.asarray(buf),
                            prompt_lengths=jnp.asarray(plen), max_new_tokens=12,
                            key=jax.random.PRNGKey(7))
        for r in range(3):
            assert_sampled_match(got["tokens"][r].numpy(), wt[r],
                                 lambda k, r=r: float(rec.gaps[k][r]), f"generate row {r}")
    # the same key again gives the same tokens; another key other tokens
    again = engine.generate(model, params, torch.from_numpy(buf),
                            prompt_lengths=torch.from_numpy(plen), max_new_tokens=12,
                            sampler=sampling.top_p(0.9, 0.8), key=prng.PRNGKey(7))
    assert torch.equal(again["tokens"], got["tokens"])
    other = engine.generate(model, params, torch.from_numpy(buf),
                            prompt_lengths=torch.from_numpy(plen), max_new_tokens=12,
                            sampler=sampling.top_p(0.9, 0.8), key=prng.PRNGKey(8))
    assert not torch.equal(other["tokens"], got["tokens"])


def test_generate_contrastive_sampled_matches_jax():
    """Chameleon T-I with nucleus sampling at t = 0.8 on the mixed, masked
    logits: the reference's tokens, every one in the image range."""
    jmodel, jparams, model, params = bridged_pair("chameleon-34b")
    from repro_torch.models import vlm

    rng = np.random.default_rng(3)
    off = vlm.image_token_offset(model.config)
    prompt = rng.integers(0, off, size=(2, 5)).astype(np.int32)
    kw = dict(uncond_token=0, n_image_tokens=16, guidance=3.0)
    want = jengine.generate_contrastive(jmodel, jparams, jnp.asarray(prompt),
                                        sampler=jsampling.top_p(0.9, 0.8),
                                        key=jax.random.PRNGKey(4), **kw)
    got = engine.generate_contrastive(model, params, torch.from_numpy(prompt),
                                      sampler=sampling.top_p(0.9, 0.8), key=prng.PRNGKey(4),
                                      **kw)
    assert bool((got["tokens"] >= off).all())
    wt = np.asarray(want["tokens"])
    greedy = engine.generate_contrastive(model, params, torch.from_numpy(prompt), **kw)
    assert not torch.equal(greedy["tokens"], got["tokens"])  # it did sample
    if got["tokens"].tolist() != wt.tolist():
        from repro.models import vlm as jvlm

        gaps = []

        class Rec(jprofiles.ContrastiveProfile):
            def step(self, state, logits, key):
                mixed = jvlm.image_token_mask(off, jvlm.contrastive_logits(
                    logits[0::2], logits[1::2], 3.0))
                gaps.append(batch_gaps(mixed, key, 0.8, 0.9))
                return super().step(state, logits, key)

        jengine.run_profile(jmodel, jparams, Rec(uncond_token=0, guidance=3.0, mask_offset=off,
                                                 sampler=jsampling.top_p(0.9, 0.8)),
                            jnp.asarray(prompt), max_new_tokens=16, max_len=5 + 16 + 1,
                            key=jax.random.PRNGKey(4))
        for g in range(2):
            assert_sampled_match(got["tokens"][g].numpy(), wt[g],
                                 lambda k, g=g: float(gaps[k][g]), f"T-I row {g}")
