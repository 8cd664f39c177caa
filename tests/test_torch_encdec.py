"""The port's encoder-decoder slice vs the JAX package, on the f32
``whisper-smoke`` and ``seamless-smoke`` configs: params come from the
reference's ``init(PRNGKey(0))`` through ``repro_torch.bridge``; frames,
tokens and frame lengths are made with numpy and handed to both sides.

Covered: ``sinusoid_positions``, the encoder states, train / prefill /
decode logits, the cross cache after prefill, beam search (``beam_step`` on
crafted logits with ties and finished beams, ``beam_finalize``, and
``generate_beam`` in both reorder arms), the two cache reorders, and
Seamless's T2U, vocoder and S-S pipeline.

Tolerances: encoder states, T2U logits and the waveform at atol 1e-4 /
rtol 1e-3, like the logits: matmuls sum in another order in XLA and
PyTorch. ``beam_step`` on crafted logits with exact ties is exact
(tokens, parents and scores: every log-probability is -log(2^j), which
both packages round alike); on random logits tokens and parents are exact
and scores within two f32 ulps. Beam tokens must match
exactly and scores within 1e-4; a divergence passes only where the
reference's deciding gap (between its K-th and (K+1)-th candidate at that
step) is below 1e-4, and is reported."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_CONFIGS
from repro.core import engine as jengine
from repro.core import kv_cache as jkv
from repro.core import profiles as jprofiles
from repro.core import sampling as jsampling
from repro.models import encdec as jencdec
from repro.models import get_model as jget_model
from repro.models import layers as jL
from repro.models import seamless as jseamless
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core import engine, kv_cache, profiles, sampling
from repro_torch.core.kv_cache import leaves
from repro_torch.models import encdec, get_model, seamless
from repro_torch.models import layers as L

LOGITS = dict(atol=1e-4, rtol=1e-3)
NEAR_TIE = 1e-4
B, T_TGT = 2, 8
BOS, EOS = 1, 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while the module runs: its decode loops are many
    tiny eager ops, which a thread pool only slows beside other test
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["whisper-base", "seamless-m4t"])
def pair(request):
    arch = request.param
    jcfg = SMOKE_CONFIGS[arch].replace(dtype="float32")
    jmodel = jget_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = get_smoke_config(arch).replace(dtype="float32")
    tparams = bridge.params_to_torch(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jmodel, jparams, tcfg, get_model(tcfg), tparams


@pytest.fixture(scope="module")
def inputs(pair):
    """Frames [B, F, d], a short frame length in row 0, target tokens."""
    jcfg = pair[0]
    rng = np.random.default_rng(0)
    f = jcfg.encdec.n_frames
    frames = rng.standard_normal((B, f, jcfg.d_model)).astype(np.float32)
    frame_lengths = np.array([f - 23, f], np.int32)
    tokens = rng.integers(0, jcfg.vocab_size, size=(B, T_TGT)).astype(np.int32)
    return frames, frame_lengths, tokens


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=LOGITS):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               **tol)


def _batches(frames, frame_lengths, tokens):
    jb = {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames),
          "frame_lengths": jnp.asarray(frame_lengths)}
    tb = {"tokens": t(tokens), "frames": t(frames), "frame_lengths": t(frame_lengths)}
    return jb, tb


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("n,d", [(1, 4), (7, 16), (64, 128), (1500, 512)])
def test_sinusoid_positions_match_jax(n, d):
    """f32 at atol 2e-5 plus one f32 ulp of a frequency (2^-23 relative)
    times the largest position: XLA's and PyTorch's ``exp`` may round a
    frequency apart by one ulp, which the position scales."""
    got = L.sinusoid_positions(n, d)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    close(got, jL.sinusoid_positions(n, d), dict(atol=2e-5 + (n - 1) * 2.0 ** -23, rtol=2e-4))


# ----------------------------------------------------------------- encoder
def test_encoder_states_match_jax(pair, inputs):
    jcfg, _, jparams, tcfg, _, tparams = pair
    frames = inputs[0]
    want = jencdec.encode(jcfg, jparams, jnp.asarray(frames))
    got = encdec.encode(tcfg, tparams, t(frames))
    assert got.shape == frames.shape
    close(got, want)


# ------------------------------------------------------------------ forward
def test_forward_train_matches_jax(pair, inputs):
    _, jmodel, jparams, _, tmodel, tparams = pair
    jb, tb = _batches(*inputs)
    jlog, _, _ = jmodel.forward(jparams, jb, mode="train")
    tlog, cache, aux = tmodel.forward(tparams, tb, mode="train")
    assert tlog.dtype == torch.float32 and cache is None and float(aux["aux_loss"]) == 0.0
    close(tlog, jlog)


def test_prefill_and_decode_match_jax(pair, inputs):
    """Prefill 6 target tokens into a cache of 12 rows, then decode the next
    two: logits at every step, and the caches after each (self K/V, cross
    K/V, lengths, frame lengths)."""
    _, jmodel, jparams, _, tmodel, tparams = pair
    frames, frame_lengths, tokens = inputs
    jb, tb = _batches(frames, frame_lengths, tokens[:, :6])
    jc = jmodel.init_cache(B, 12)
    tc = tmodel.init_cache(B, 12, "cpu")
    jlog, jc, _ = jmodel.forward(jparams, jb, cache=jc, mode="prefill")
    tlog, tc, _ = tmodel.forward(tparams, tb, cache=tc, mode="prefill")
    close(tlog, jlog)
    for step in (6, 7):
        jlog, jc, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens[:, step:step + 1])},
                                     cache=jc, mode="decode")
        tlog, tc, _ = tmodel.forward(tparams, {"tokens": t(tokens[:, step:step + 1])},
                                     cache=tc, mode="decode")
        close(tlog, jlog)
    assert tc["lengths"].tolist() == np.asarray(jc["lengths"]).tolist() == [8, 8]
    assert tc["frame_lengths"].tolist() == frame_lengths.tolist()
    for tl, jl in zip(tc["layers"], jc["layers"]):
        for k in ("cross_k", "cross_v"):
            close(tl[k], jl[k], dict(atol=2e-5, rtol=2e-4))
        for k in ("k", "v"):
            close(tl["self"][k], jl["self"][k], dict(atol=2e-5, rtol=2e-4))


def test_prefill_writes_the_cross_cache_in_place(pair, inputs):
    """The cross K/V are written into the preallocated buffers (the same
    tensors come back), the self cache is clamped to ``max_target_len``,
    and a decode step reads the cache without running the encoder."""
    jcfg, _, _, tcfg, tmodel, tparams = pair
    frames, frame_lengths, tokens = inputs
    tc = tmodel.init_cache(B, 10_000, "cpu")
    assert tc["layers"][0]["self"]["k"].shape[1] == tcfg.encdec.max_target_len
    ptrs = [x.data_ptr() for x in leaves(tc["layers"])] + [tc["frame_lengths"].data_ptr()]
    _, tb = _batches(frames, frame_lengths, tokens[:, :3])
    _, tc, _ = tmodel.forward(tparams, tb, cache=tc, mode="prefill")
    assert [x.data_ptr() for x in leaves(tc["layers"])] + [tc["frame_lengths"].data_ptr()] == ptrs
    assert float(tc["layers"][0]["cross_k"].abs().sum()) > 0

    calls = []
    real = encdec.encode
    encdec.encode = lambda *a, **kw: calls.append(1) or real(*a, **kw)
    try:
        tmodel.forward(tparams, {"tokens": t(tokens[:, 3:4])}, cache=tc, mode="decode")
    finally:
        encdec.encode = real
    assert calls == []
    with pytest.raises(NotImplementedError):
        tmodel.forward(tparams, {"tokens": t(tokens[:, :1])}, cache=tc, mode="mixed")


# -------------------------------------------------------------- beam search
def _crafted_step_inputs(rng, b, k, v, step, ties):
    """A beam state at ``step`` and the logits of the next steps, some beams
    finished. ``ties``: each row holds 0.5 at 1, 2, 4 or 8 tokens and -inf
    elsewhere, two beams of a group share their row and their dyadic score,
    so candidates tie exactly within a beam and across beams, and every
    log-probability is exactly -log(2^j) in both packages. Otherwise random
    normal logits."""
    if ties:
        logits = np.full((b * k, v), -np.inf, np.float32)
        for r in range(b * k):
            logits[r, rng.choice(v, size=2 ** int(rng.integers(0, 4)), replace=False)] = 0.5
        scores = -rng.integers(1, 8, size=b * k).astype(np.float32) / 4
    else:
        logits = rng.standard_normal((b * k, v)).astype(np.float32)
        scores = rng.standard_normal(b * k).astype(np.float32) - 2.0
    logits[1], scores[1] = logits[2], scores[2]  # two identical beams
    finished = np.zeros(b * k, bool)
    finished[[0, k + 1]] = True
    tokens = rng.integers(1, v, size=(b * k, 6)).astype(np.int32)
    tokens[:, step:] = 0
    return logits, finished, scores, tokens


@pytest.mark.parametrize("ties", [True, False], ids=["ties", "random"])
@pytest.mark.parametrize("step", [0, 2, 5])
def test_beam_step_matches_jax_on_ties(step, ties):
    """Three ``beam_step`` calls from a crafted state, then
    ``beam_finalize``: tokens, parents and finished flags exact; scores
    exact on the tie case, and within two f32 ulps on random logits (XLA's
    and PyTorch's ``exp`` and ``log`` round apart in the last bit)."""
    b, k, v = 3, 4, 16
    logits, finished, scores, tokens = _crafted_step_inputs(
        np.random.default_rng(step), b, k, v, step, ties)
    if step == 0:  # the first step: every beam the same, beams 1..K-1 seeded -1e9
        js = jsampling.beam_init(b, k, 6)
        ts = sampling.beam_init(b, k, 6)
        assert ts.scores.tolist() == np.asarray(js.scores).tolist()
        logits = np.repeat(logits[::k], k, axis=0)
    else:
        js = jsampling.BeamState(tokens=jnp.asarray(tokens), scores=jnp.asarray(scores),
                                 finished=jnp.asarray(finished), step=step)
        ts = sampling.BeamState(tokens=t(tokens), scores=t(scores), finished=t(finished),
                                step=step)

    def same_scores(got, want):
        if ties:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=2 * 2.0 ** -23, atol=0)

    for _ in range(3):  # three steps in a row from the crafted state
        js, jidx = jsampling.beam_step(js, jnp.asarray(logits), k, EOS)
        ts, tidx = sampling.beam_step(ts, t(logits), k, EOS)
        assert tidx.tolist() == np.asarray(jidx).tolist()
        assert ts.tokens.tolist() == np.asarray(js.tokens).tolist()
        assert ts.finished.tolist() == np.asarray(js.finished).tolist()
        same_scores(ts.scores.numpy(), np.asarray(js.scores))
        assert ts.step == js.step
        if ts.step >= 6:
            break
    jt, jsc = jsampling.beam_finalize(js, k)
    tt, tsc = sampling.beam_finalize(ts, k)
    assert tt.tolist() == np.asarray(jt).tolist()
    same_scores(tsc.numpy(), np.asarray(jsc))


def test_top_k_breaks_ties_by_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, float("-inf")]])
    vals, idx = sampling.top_k_lower_index(x, 4)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    assert idx.tolist() == np.asarray(ji).tolist() == [[1, 2, 4, 3]]
    assert vals.tolist() == np.asarray(jv).tolist()


class _Recording(jprofiles.BeamProfile):
    """The reference's BeamProfile, recording each step's fed tokens, its
    permutation and its deciding gap: the least distance between the K-th
    and (K+1)-th candidate score of any group."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.trace = []

    def step(self, state, logits, key):
        bk, v = logits.shape
        k = self.n_beams
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        eos_only = jnp.full((v,), -jnp.inf).at[self.eos_id].set(0.0)
        logp = jnp.where(state.finished[:, None], eos_only[None], logp)
        cand = np.sort(np.asarray(state.scores[:, None] + logp).reshape(bk // k, k * v),
                       axis=1)[:, ::-1]
        gap = float(np.min(cand[:, k - 1] - cand[:, k]))
        out = super().step(state, logits, key)
        self.trace.append((np.asarray(out.feed).tolist(), np.asarray(out.perm).tolist(), gap))
        return out


class _TorchRecording(profiles.BeamProfile):
    """The port's BeamProfile, recording each step's fed tokens and
    permutation."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.trace = []

    def step(self, state, logits, key=None):
        out = super().step(state, logits, key)
        self.trace.append((out.feed.tolist(), out.perm.tolist()))
        return out


def assert_beams_match(got, want, replay, what: str) -> None:
    """Equal beam tokens; if they differ, replay both sides step by step
    and accept the first differing step only at a reference near tie."""
    if got["tokens"].tolist() == np.asarray(want["tokens"]).tolist():
        np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                                   atol=1e-4, rtol=0)
        assert got["n_steps"] == want["n_steps"]
        return
    jtrace, ttrace = replay()
    for i, ((jf, jp, gap), (tf, tp)) in enumerate(zip(jtrace, ttrace)):
        if (jf, jp) != (tf, tp):
            assert gap < NEAR_TIE, f"{what}: step {i} differs with deciding gap {gap}"
            print(f"{what}: near-tie divergence at step {i} (gap {gap:.2e})")
            return
    raise AssertionError(f"{what}: tokens differ but every step agrees")


@pytest.mark.parametrize("donate", [True, False])
def test_generate_beam_matches_jax(pair, inputs, donate):
    """4 groups x 3 beams from BOS over the frames, 10 steps: the port's
    tokens in either reorder arm equal the reference's, scores within 1e-4,
    and the same number of steps."""
    _, jmodel, jparams, _, tmodel, tparams = pair
    frames, frame_lengths, _ = inputs
    fr = np.concatenate([frames, frames[::-1] * 0.5])
    fl = np.concatenate([frame_lengths, frame_lengths[::-1] - 7])
    kw = dict(batch=4, n_beams=3, bos_id=BOS, eos_id=EOS, max_new_tokens=10)
    want = jengine.generate_beam(jmodel, jparams, **kw, extra_inputs={
        "frames": jnp.asarray(fr), "frame_lengths": jnp.asarray(fl)})
    got = engine.generate_beam(tmodel, tparams, **kw, donate_reorder=donate,
                               extra_inputs={"frames": t(fr), "frame_lengths": t(fl)})
    assert got["tokens"].shape == (4, 10) and got["tokens"].dtype == torch.int32

    def replay():
        jp, tp = _Recording(n_beams=3, eos_id=EOS), _TorchRecording(n_beams=3, eos_id=EOS)
        bos = np.full((4, 1), BOS, np.int32)
        jengine.run_profile(jmodel, jparams, jp, jnp.asarray(bos), max_new_tokens=10,
                            extra_inputs={"frames": jnp.asarray(fr),
                                          "frame_lengths": jnp.asarray(fl)})
        engine.run_profile(tmodel, tparams, tp, t(bos), max_new_tokens=10,
                           extra_inputs={"frames": t(fr), "frame_lengths": t(fl)})
        return jp.trace, tp.trace

    assert_beams_match(got, want, replay, f"generate_beam donate={donate}")


def test_generate_beam_stops_when_every_beam_ends(pair, inputs):
    """With EOS set to the first step's best token, every beam of a group
    finishes and the loop halts early, as the reference's does."""
    _, jmodel, jparams, _, tmodel, tparams = pair
    frames, frame_lengths, _ = inputs
    extra_t = {"frames": t(frames), "frame_lengths": t(frame_lengths)}
    first = engine.generate_beam(tmodel, tparams, batch=B, n_beams=2, bos_id=BOS, eos_id=EOS,
                                 max_new_tokens=1, extra_inputs=extra_t)["tokens"]
    eos = int(first[0, 0])
    kw = dict(batch=B, n_beams=2, bos_id=BOS, eos_id=eos, max_new_tokens=8)
    want = jengine.generate_beam(jmodel, jparams, **kw, extra_inputs={
        "frames": jnp.asarray(frames), "frame_lengths": jnp.asarray(frame_lengths)})
    got = engine.generate_beam(tmodel, tparams, **kw, extra_inputs=extra_t)
    assert got["n_steps"] == want["n_steps"]
    assert got["tokens"].tolist() == np.asarray(want["tokens"]).tolist()
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), atol=1e-4)


def test_reorders_match_jax_and_keep_or_replace_tensors(pair):
    """``reorder_realloc`` gathers every leaf (lengths and frame lengths
    too) into fresh tensors as the reference's ``reorder`` does;
    ``reorder_donated`` writes the same rows back into the same tensors."""
    _, jmodel, _, _, tmodel, _ = pair
    rng = np.random.default_rng(3)
    jc = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(x.dtype)
                                            if x.dtype != jnp.int32 else
                                            rng.integers(0, 9, x.shape).astype(np.int32)),
                      jmodel.init_cache(6, 5))
    idx = np.array([2, 2, 0, 5, 1, 1], np.int32)
    want = jax.tree.map(np.asarray, jkv.reorder(jc, jnp.asarray(idx)))
    tc = bridge.cache_to_torch(jax.tree.map(np.asarray, jc), "cpu")
    fresh = kv_cache.reorder_realloc(tc, t(idx))
    ptrs = [x.data_ptr() for x in leaves(tc)]
    same = kv_cache.reorder_donated(tc, t(idx))
    assert same is tc and [x.data_ptr() for x in leaves(same)] == ptrs
    assert all(x.data_ptr() not in ptrs for x in leaves(fresh))
    for a, b, w in zip(leaves(same), leaves(fresh), leaves(bridge.cache_to_torch(want, "cpu"))):
        assert torch.equal(a, w) and torch.equal(b, w)


# ----------------------------------------------------------------- seamless
@pytest.mark.parametrize("pair", ["seamless-m4t"], indirect=True)
def test_t2u_and_vocoder_match_jax(pair):
    jcfg, _, jparams, tcfg, _, tparams = pair
    rng = np.random.default_rng(4)
    text = rng.integers(0, jcfg.vocab_size, size=(B, 5)).astype(np.int32)
    want = jseamless.t2u_forward(jcfg, jparams["t2u"], jnp.asarray(text))
    got = seamless.t2u_forward(tcfg, tparams["t2u"], t(text))
    assert got.shape == (B, 5 * seamless.UPSAMPLE_T2U, seamless.N_UNITS)
    close(got, want)
    units = rng.integers(0, seamless.N_UNITS, size=(B, 9)).astype(np.int32)
    want = jseamless.vocode(jcfg, jparams["vocoder"], jnp.asarray(units))
    got = seamless.vocode(tcfg, tparams["vocoder"], t(units))
    assert got.shape == (B, 9 * 16) and seamless.VOC_BLOCK_FACTORS == (4, 4, 1)
    close(got, want)


@pytest.mark.parametrize("pair", ["seamless-m4t"], indirect=True)
def test_speech_to_speech_matches_jax(pair, inputs):
    _, jmodel, jparams, _, tmodel, tparams = pair
    frames = inputs[0]
    want = jseamless.speech_to_speech(jmodel, jparams, frames=jnp.asarray(frames),
                                      max_text_len=6, n_beams=2)
    got = seamless.speech_to_speech(tmodel, tparams, frames=t(frames), max_text_len=6,
                                    n_beams=2)
    assert got["text"].tolist() == np.asarray(want["text"]).tolist()
    assert got["units"].tolist() == np.asarray(want["units"]).tolist()
    assert got["n_decode_steps"] == want["n_decode_steps"]
    assert got["waveform"].shape == (B, got["units"].shape[1] * 16)
    close(got["waveform"], want["waveform"])


def test_scheduler_refuses_an_encoder_decoder(pair, inputs):
    """The contiguous scheduler serves an encoder-decoder, each request's
    frames written into its slots' cross rows at admission: two concurrent
    2-beam requests give the port's ``generate_beam`` tokens exactly and its
    scores within 1e-4. The paged pool still refuses the family (per-slot
    cross rows have no block layout)."""
    from repro_torch.core.scheduler import Scheduler, ServeRequest

    _, _, _, _, tmodel, tparams = pair
    frames, frame_lengths, _ = inputs
    want = engine.generate_beam(tmodel, tparams, batch=B, n_beams=2, bos_id=BOS, eos_id=EOS,
                                max_new_tokens=5,
                                extra_inputs={"frames": t(frames),
                                              "frame_lengths": t(frame_lengths)})
    sched = Scheduler(tmodel, tparams, slots=4, pad_to=4, max_new_cap=5, device="cpu")
    done = sched.run([
        ServeRequest(rid=i, prompt=np.asarray([BOS]), max_new=5,
                     profile=profiles.BeamProfile(n_beams=2, eos_id=EOS),
                     extra_inputs={"frames": frames[i:i + 1],
                                   "frame_lengths": frame_lengths[i:i + 1]})
        for i in range(B)])
    for r in done:
        assert r.tokens == want["tokens"][r.rid, :len(r.tokens)].tolist()
        assert abs(r.score - float(want["scores"][r.rid])) <= 1e-4
    assert sched.n_group_admissions == B
    with pytest.raises(NotImplementedError, match="enc-dec"):
        Scheduler(tmodel, tparams, slots=2, pad_to=4, max_new_cap=4, device="cpu",
                  paged=True, block_size=4)
