"""Port's tensor-parallel serving of the ssm, encdec and seamless families
(``repro_torch.distributed.tp_pool``, the ``tp_*`` step family,
``Scheduler(tp=...)``) against the JAX package's single-device functions
and scheduler.

Two gloo ranks on the CPU, spawned once for the module (a ``FileStore``
under ``tmp_path``: no TCP port), one intra-op thread each, params bridged
from the reference's f32 smoke inits of ``mamba2-130m`` (a rank's heads
through the head-aligned ``in_proj`` / conv layout, the gate norm's sums
reduced), ``whisper-base`` (the encoder, self and cross attention at a
rank's heads), ``seamless-m4t`` (its T2TT backbone) and ``whisper-base`` at
an odd vocabulary (511: the embedding and the LM head whole on every rank,
as the reference's specs leave whisper-base's 51865):

- tokens and host counters equal to the JAX single-device scheduler's:
  mamba2 greedy and at t = 0.8 on ``tests/test_torch_tp.py``'s trace,
  whisper S-T beam groups beside greedy requests, each request with its
  own frames, and seamless S-T;
- ``tp_prefill`` / ``tp_decode_step`` logits against the reference's
  single-device functions at atol 1e-4 / rtol 1e-3, and each rank's state
  heads or K/V heads against the reference's cache;
- each rank's ``in_proj`` / ``conv_w`` columns equal to the reference's at
  the permuted indices; its state or KV bytes at most 0.6x the whole; the
  reduces of a prefill and of a decode step;
- a ``wo`` AutoQuant'd mamba2 shard against the reference's quantized
  steps;
- the split-row RMSNorm's plain version against the reference's whole-row
  ``layers.rmsnorm``, and (``cuda``-marked: the card only) its kernel
  against its plain version;
- ``serve --tp 2 --device cpu`` for the three archs.

The JAX package is imported inside the fixtures and tests only: the spawned
ranks import this module and stay free of it. The JAX runs go on in the
parent while the ranks run."""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core import engine, profiles
from repro_torch.core.quantization import quantize_params
from repro_torch.core.scheduler import Scheduler, ServeRequest
from repro_torch.distributed import sharding, tp_pool
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rn
from repro_torch.launch import serve
from repro_torch.models import get_model

TP = 2
STEP_TOL = dict(atol=1e-4, rtol=1e-3)  # tests/test_torch_model.py's whole-model tolerance
TRACE = dict(pad_to=16, max_new_cap=16, vocab_size=512, arrival_rate=0.0, seed=0)
CONTIGUOUS = dict(slots=4, pad_to=16, max_new_cap=16)
ST = dict(slots=8, pad_to=4, max_new_cap=8)
#: model name -> (smoke arch, vocabulary override or None)
MODELS = {"mamba2-130m": ("mamba2-130m", None), "whisper-base": ("whisper-base", None),
          "seamless-m4t": ("seamless-m4t", None), "whisper-base V511": ("whisper-base", 511)}
#: model -> arm -> (trace kind, temperature, top-p, geometry)
ARMS = {"mamba2-130m": {"greedy": ("poisson", 0.0, 1.0, CONTIGUOUS),
                        "t=0.8": ("poisson", 0.8, 0.9, CONTIGUOUS)},
        "whisper-base": {"S-T beams": ("st beams", 0.0, 1.0, ST)},
        "seamless-m4t": {"S-T": ("st", 0.0, 1.0, ST)},
        "whisper-base V511": {"S-T beams": ("st beams", 0.0, 1.0, ST)}}
CASES = [(name, arm) for name in MODELS for arm in ARMS[name]]
COUNTERS = ("n_preemptions", "n_decode_steps", "n_prefills", "n_group_admissions",
            "n_cache_reorders")
QUANT = "mamba2-130m wo"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name):
    arch, vocab = MODELS[name]
    cfg = get_smoke_config(arch).replace(dtype="float32")
    return cfg if vocab is None else cfg.replace(vocab_size=vocab)


def _frames(cfg, n, seed):
    """``n`` utterances' stub frames [n, F, d] f32 and frame lengths [n]."""
    rng = np.random.default_rng(seed)
    f = cfg.encdec.n_frames
    frames = rng.standard_normal((n, f, cfg.d_model)).astype(np.float32)
    return frames, np.asarray([f - 7 * (i % 3) for i in range(n)], np.int32)


def _trace(sched_mod, serve_mod, cfg, kind, temperature, top_p):
    """The arm's requests, built from ``sched_mod``'s ``ServeRequest`` and
    ``profiles`` (the port's or the reference's give the same trace)."""
    if kind == "poisson":
        prof = serve_mod.data_mod.PAPER_PROFILES["seamless_s2t"]
        return serve_mod.poisson_trace(prof, 8, temperature=temperature, top_p=top_p, **TRACE)
    rng = np.random.default_rng(5)
    frames, flens = _frames(cfg, 4, 3)
    reqs = []
    for i in range(4):
        beam = kind == "st beams" and i % 2 == 1
        prompt = np.asarray([1] + list(rng.integers(3, cfg.vocab_size, i % 3)), np.int32)
        reqs.append(sched_mod.ServeRequest(
            rid=i, prompt=prompt, max_new=8,
            profile=sched_mod.profiles.BeamProfile(n_beams=2 + i // 2, eos_id=2)
            if beam else None,
            extra_inputs={"frames": frames[i:i + 1], "frame_lengths": flens[i:i + 1]}))
    return reqs


class _PortSched:
    ServeRequest, profiles = ServeRequest, profiles


def _step_inputs(cfg):
    """A prefill of two prompts (with frames for an encoder-decoder), then
    a decode token."""
    rng = np.random.default_rng(7)
    x = dict(tokens=rng.integers(0, cfg.vocab_size, size=(2, 8)).astype(np.int32),
             lengths=np.array([8, 5], np.int32), max_len=24,
             token=np.array([3, 7], np.int32), extra=None)
    if cfg.encdec is not None:
        frames, flens = _frames(cfg, 2, 11)
        x["extra"] = {"frames": frames, "frame_lengths": flens}
    return x


def _tp_steps(tp):
    """``tp_prefill`` and ``tp_decode_step`` on ``_step_inputs``: their
    gathered logits, the prefill's first-layer cache leaves and the reduces
    of each."""
    x = _step_inputs(tp.config)
    t = torch.from_numpy
    extra = None if x["extra"] is None else {k: t(v) for k, v in x["extra"].items()}
    m, p, out = tp.model, tp.params, {}
    n0 = tp.group.n_reduces
    logits, cache = engine.tp_prefill(m, p, t(x["tokens"]), t(x["lengths"]), x["max_len"],
                                      extra=extra)
    out["prefill_reduces"] = tp.group.n_reduces - n0
    out["prefill"] = logits.numpy()
    out["cache"] = _leaves(cache["layers"][0])
    n0 = tp.group.n_reduces
    logits, cache = engine.tp_decode_step(m, p, cache, t(x["token"]))
    out["decode_reduces"] = tp.group.n_reduces - n0
    out["decode"] = logits.numpy()
    return out


def _leaves(tree):
    """{path: numpy copy} of a cache tree's leaves (torch or JAX)."""
    out = {}
    sharding.map_with_path(lambda p, t: out.__setitem__(p, np.array(t)), tree)
    return out


def _shapes(tree):
    out = {}
    sharding.map_with_path(lambda p, t: out.__setitem__(p, tuple(t.shape)), tree)
    return out


def _rank_checks(group, np_params):
    """One rank's share of every check; returns its results."""
    out = {}
    for name in MODELS:
        cfg = _cfg(name)
        whole = bridge.params_to_torch(cfg, np_params[name], "cpu")
        tp = tp_pool.TPContext(get_model(cfg), whole, group)
        res = {"serve": {}, "bytes": {}, "params": _leaves(tp.params), "steps": _tp_steps(tp),
               "param_bytes": tp_pool.max_per_device_bytes(tp.params, group)}
        for arm, (kind, temp, top_p, geometry) in ARMS[name].items():
            sched = Scheduler(tp.model, tp.params, tp=tp, **geometry)
            done = sched.run(_trace(_PortSched, serve, cfg, kind, temp, top_p))
            res["serve"][arm] = ({r.rid: [int(t) for t in r.tokens] for r in done},
                                 {c: getattr(sched, c) for c in COUNTERS})
            res["bytes"][arm] = (tp_pool.max_per_device_bytes(sched.pool.cache, group),
                                 tp.whole_bytes(sched.pool.cache),
                                 _shapes(sched.pool.cache["layers"][0]))
        out[name] = res
    cfg = _cfg("mamba2-130m")
    tp = tp_pool.TPContext(get_model(cfg), quantize_params(
        bridge.params_to_torch(cfg, np_params["mamba2-130m"], "cpu"), "wo"), group)
    out[QUANT] = {"steps": _tp_steps(tp), "params": _leaves(tp.params)}
    return out


def _jax_pair(name):
    import jax

    from repro.configs import SMOKE_CONFIGS
    from repro.models import get_model as jget_model

    arch, vocab = MODELS[name]
    jcfg = SMOKE_CONFIGS[arch].replace(dtype="float32")
    if vocab is not None:
        jcfg = jcfg.replace(vocab_size=vocab)
    jmodel = jget_model(jcfg)
    return jmodel, jmodel.init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def ref():
    """The reference's (model, params) of each model, and every params tree
    as numpy for the ranks."""
    import jax

    pairs = {name: _jax_pair(name) for name in MODELS}
    return pairs, {n: jax.tree.map(np.asarray, p[1]) for n, p in pairs.items()}


@pytest.fixture(scope="module")
def ranks_started(ref, tmp_path_factory):
    """Two spawned gloo ranks on the CPU running every TP = 2 check, in a
    thread of their own: the JAX fixtures run meanwhile."""
    store = tmp_path_factory.mktemp("tp_ssm_encdec_store") / "store"
    box = {}

    def run():
        try:
            box["ranks"] = tp_pool.spawn(_rank_checks, TP, ref[1], devices=["cpu"] * TP,
                                         init_file=str(store))
        except BaseException as e:  # re-raised by ``ranks``
            box["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread, box


@pytest.fixture(scope="module")
def jax_runs(ref, ranks_started):
    """Each model's arms through the JAX package's single-device scheduler:
    tokens, counters and the pool's reserved bytes."""
    from repro.core import profiles as jprofiles
    from repro.core import scheduler as jsched
    from repro.launch import serve as jserve

    class JSched:
        ServeRequest, profiles = jsched.ServeRequest, jprofiles

    runs = {}
    for name, arm in CASES:
        jmodel, jparams = ref[0][name]
        kind, temp, top_p, geometry = ARMS[name][arm]
        js = jsched.Scheduler(jmodel, jparams, **geometry)
        done = js.run(_trace(JSched, jserve, _cfg(name), kind, temp, top_p))
        runs[name, arm] = ({r.rid: [int(t) for t in r.tokens] for r in done},
                           {c: getattr(js, c) for c in COUNTERS}, js.pool.reserved_bytes)
    return runs


def _jax_steps(name, jmodel, jparams):
    import jax

    from repro.core import engine as jengine

    x = _step_inputs(_cfg(name))
    extra = None if x["extra"] is None else jax.tree.map(jax.numpy.asarray, x["extra"])
    out = {}
    logits, cache = jengine.prefill(jmodel, jparams, x["tokens"], x["lengths"], x["max_len"],
                                    extra)
    out["prefill"] = np.asarray(logits)
    out["cache"] = _leaves(cache["layers"][0])
    logits, cache = jengine.decode_step(jmodel, jparams, cache, x["token"])
    out["decode"] = np.asarray(logits)
    return out


@pytest.fixture(scope="module")
def jax_steps(ref, jax_runs):
    """The reference's single-device prefill and decode step on
    ``_step_inputs`` for each model, and for mamba2 quantized whole by the
    reference's ``quantize_params`` (``wo``)."""
    from repro.core.quantization import quantize_params as jquantize

    out = {name: _jax_steps(name, *ref[0][name]) for name in MODELS}
    jmodel, jparams = ref[0]["mamba2-130m"]
    out[QUANT] = _jax_steps("mamba2-130m", jmodel, jquantize(jparams, "wo"))
    return out


@pytest.fixture(scope="module")
def ranks(ranks_started, jax_runs, jax_steps):
    thread, box = ranks_started
    thread.join()
    if "error" in box:
        raise box["error"]
    return box["ranks"]


# ------------------------------------------------------------ TP = 2 serving
@pytest.mark.parametrize("name,arm", CASES)
def test_tp2_tokens_and_counters_equal_the_jax_scheduler(ranks, jax_runs, name, arm):
    """Both ranks commit the reference single-device scheduler's tokens,
    and its preemptions, steps, prefills, group admissions and row
    gathers."""
    want_tokens, want_counters, _ = jax_runs[name, arm]
    for rank in ranks:
        tokens, counters = rank[name]["serve"][arm]
        assert tokens == want_tokens
        assert counters == want_counters
    if "beams" in arm:
        assert want_counters["n_group_admissions"] >= 2
        assert want_counters["n_cache_reorders"] >= 1


@pytest.mark.parametrize("name,arm", CASES)
def test_tp2_state_and_kv_bytes_a_rank(ranks, jax_runs, name, arm):
    """A rank holds at most 0.6x of the pool: its SSM heads' state and its
    conv tail's x channels (B and C whole), or its self and cross K/V
    heads; counted once, the ranks' pool is the reference's."""
    per_rank, whole, leaves = ranks[0][name]["bytes"][arm]
    assert whole == jax_runs[name, arm][2]
    assert ranks[1][name]["bytes"][arm] == (per_rank, whole, leaves)
    assert per_rank / whole <= 0.6
    cfg = _cfg(name)
    if cfg.ssm is not None:
        s = cfg.ssm
        heads = s.n_heads(cfg.d_model) // TP
        assert leaves["state"][1:] == (heads, s.head_dim, s.d_state)
        assert leaves["conv"][-1] == heads * s.head_dim + 2 * s.d_state
    else:
        for leaf in ("self/k", "self/v", "cross_k", "cross_v"):
            assert leaves[leaf][-2:] == (cfg.n_kv_heads // TP, cfg.head_dim)


def reduces_a_forward(cfg, mode):
    """The reduces of one TP forward of ``cfg``, counted from the model's
    structure: the embedding and the logits' gather when the vocabulary
    splits; a Mamba-2 layer's gate-norm sums and ``out_proj``; an
    encoder-decoder's 3 a decoder layer (self, cross, FFN) and, in a
    prefill, 2 an encoder layer."""
    n = 2 if cfg.vocab_size % TP == 0 else 0
    if cfg.ssm is not None:
        return n + 2 * cfg.n_layers
    n += 3 * cfg.n_layers
    return n + (2 * cfg.encdec.n_encoder_layers if mode == "prefill" else 0)


@pytest.mark.parametrize("name", list(MODELS) + [QUANT])
@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_tp2_reduces_a_forward(ranks, name, mode):
    """A prefill's and a decode step's reduces on each rank, as the model's
    structure gives them (the published widths: mamba2-130m 50, whisper-base
    18 a decode and 30 a prefill, seamless-m4t 20 a decode)."""
    cfg = _cfg("mamba2-130m" if name == QUANT else name)
    for rank in ranks:
        assert rank[name]["steps"][f"{mode}_reduces"] == reduces_a_forward(cfg, mode)


def test_tp2_reduces_at_the_published_widths():
    """``reduces_a_forward`` at the published configs: the counts the card's
    ``tp`` phase holds its ranks to."""
    from repro_torch.configs import get_config

    assert reduces_a_forward(get_config("mamba2-130m"), "decode") == 50
    assert reduces_a_forward(get_config("whisper-base"), "decode") == 18
    assert reduces_a_forward(get_config("whisper-base"), "prefill") == 30
    assert reduces_a_forward(get_config("seamless-m4t"), "decode") == 20
    for arch in ("mamba2-130m", "whisper-base", "seamless-m4t"):
        tp_pool.check_supported(get_config(arch), TP)


@pytest.mark.parametrize("name", list(MODELS) + [QUANT])
@pytest.mark.parametrize("step", ["prefill", "decode"])
def test_tp2_steps_match_the_reference(ranks, jax_steps, name, step):
    """``tp_prefill`` / ``tp_decode_step`` logits (gathered over the vocab,
    or whole) on both ranks against the reference's single-device steps at
    the whole-model tolerance; for ``wo`` against its quantized steps."""
    for rank in ranks:
        got, want = rank[name]["steps"][step], jax_steps[name][step]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **STEP_TOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_tp2_ranks_hold_their_heads_of_the_prefill_cache(ranks, jax_steps, name):
    """The prefill's first-layer cache: rank r holds state heads (an SSM)
    or self and cross K/V heads [r * H / 2, (r + 1) * H / 2) of the
    reference's, and its conv tail's x channels beside B and C whole."""
    cfg = _cfg(name)
    want = jax_steps[name]["cache"]
    for r, rank in enumerate(ranks):
        got = rank[name]["steps"]["cache"]
        assert set(got) == set(want)
        for path, w in want.items():
            if path == "conv":
                _, conv = sharding.ssm_rank_columns(cfg, r, TP)
                np.testing.assert_allclose(got[path], w[..., conv.numpy()], **STEP_TOL)
                continue
            axis = 1 if path == "state" else 2
            h = w.shape[axis] // TP
            np.testing.assert_allclose(got[path], np.take(w, range(r * h, (r + 1) * h), axis),
                                       **STEP_TOL)


@pytest.mark.parametrize("leaf", ["in_proj/w", "conv_w", "conv_b", "A_log", "dt_bias",
                                  "gate_norm/scale", "out_proj/w"])
def test_tp2_mamba_shard_is_the_head_aligned_layout(ranks, ref, leaf):
    """Each rank's mixer leaves are the reference's at the permuted indices:
    ``in_proj``'s z, x and dt columns of its heads with B and C whole,
    ``conv``'s x channels of its heads with B and C whole, its heads'
    ``A_log`` / ``dt_bias``, its channels of ``gate_norm`` and rows of
    ``out_proj``."""
    cfg = _cfg("mamba2-130m")
    s = cfg.ssm
    d_in, nh = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model)
    jp = ref[1]["mamba2-130m"]["layers"]
    for r, rank in enumerate(ranks):
        cols, conv = sharding.ssm_rank_columns(cfg, r, TP)
        heads = np.arange(r * nh // TP, (r + 1) * nh // TP)
        chans = np.arange(r * d_in // TP, (r + 1) * d_in // TP)
        for i in range(cfg.n_layers):
            w = _jax_leaf(jp, i, leaf)
            got = rank["mamba2-130m"]["params"][f"layers/{i}/mixer/{leaf}"]
            if leaf == "in_proj/w":
                want = w[:, cols.numpy()]
            elif leaf in ("conv_w", "conv_b"):
                want = w[conv.numpy()]
            elif leaf in ("A_log", "dt_bias"):
                want = w[heads]
            else:
                want = w[chans]
            np.testing.assert_array_equal(got, want)
    z, x = cols[:d_in // TP], cols[d_in // TP:2 * d_in // TP]
    assert torch.equal(x - z, torch.full_like(z, d_in))


def _jax_leaf(jlayers, i, leaf):
    """Leaf ``mixer/<leaf>`` of layer ``i`` of the reference's tree."""
    node = jlayers[i]["mixer"]
    for k in leaf.split("/"):
        node = node[k]
    return np.asarray(node)


def test_tp2_autoquant_mamba_shard_cuts_the_whole_trees_codes(ranks, ref):
    """``wo``: the rank's ``in_proj`` codes and ``w_scale`` the whole tree's
    at its permuted columns, ``out_proj``'s codes its rows with the scale
    whole."""
    cfg = _cfg("mamba2-130m")
    whole = quantize_params(bridge.params_to_torch(cfg, ref[1]["mamba2-130m"], "cpu"), "wo")
    d_in = cfg.ssm.d_inner(cfg.d_model)
    for r, rank in enumerate(ranks):
        cols, _ = sharding.ssm_rank_columns(cfg, r, TP)
        got = {k[len("layers/0/mixer/"):]: torch.from_numpy(v)
               for k, v in rank[QUANT]["params"].items() if k.startswith("layers/0/mixer/")}
        want = whole["layers"][0]["mixer"]
        assert torch.equal(got["in_proj/w_q_wo"], want["in_proj"]["w_q_wo"][:, cols])
        assert torch.equal(got["in_proj/w_scale"], want["in_proj"]["w_scale"][cols])
        rows = slice(r * d_in // TP, (r + 1) * d_in // TP)
        assert torch.equal(got["out_proj/w_q_wo"], want["out_proj"]["w_q_wo"][rows])
        assert torch.equal(got["out_proj/w_scale"], want["out_proj"]["w_scale"])


@pytest.mark.parametrize("name", ["whisper-base", "whisper-base V511"])
def test_tp2_vocab_splits_or_stays_whole(ranks, name):
    """The embedding and the LM head: vocab-split where V splits, whole on
    every rank where it does not (the reference's ``_spec_for``)."""
    cfg = _cfg(name)
    v = cfg.vocab_size if cfg.vocab_size % TP else cfg.vocab_size // TP
    for rank in ranks:
        p = rank[name]["params"]
        assert p["embed/table"].shape == (v, cfg.d_model)
        assert p["lm_head/w"].shape == (cfg.d_model, v)
        assert p["decoder/0/cross_attn/wk/w"].shape == (
            cfg.d_model, cfg.n_kv_heads // TP * cfg.head_dim)
        assert p["encoder/0/attn/wo/w"].shape == (cfg.n_heads // TP * cfg.head_dim, cfg.d_model)


# ------------------------------------------------- the split-row RMSNorm
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shards", [1, 2, 3])
def test_split_rmsnorm_plain_matches_the_reference_whole_row(dtype, shards):
    """``ops.mul_silu_rmsnorm_split``'s plain version over ``shards`` slices
    of each row, their partial sums added as the ranks' reduce adds them,
    against the reference's whole-row ``layers.rmsnorm`` of ``y * silu(z)``
    (the kernels' tolerance: bf16 2e-2, f32 atol 2e-5 / rtol 2e-4)."""
    import jax.numpy as jnp

    from repro.models import layers as jL

    rng = np.random.default_rng(shards)
    d = 96 * shards
    y, z = (rng.standard_normal((3, 5, d)).astype(np.float32) for _ in range(2))
    w = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    ty, tz, tw = (torch.from_numpy(a).to(tdt) for a in (y, z, w))
    n = d // shards
    parts = [rn.mul_silu_partial_plain(ty[..., i * n:(i + 1) * n], tz[..., i * n:(i + 1) * n])
             for i in range(shards)]
    total = sum(s for _, s in parts)
    got = torch.cat([rn.rmsnorm_scale_plain(p, total, tw[i * n:(i + 1) * n], d)
                     for i, (p, _) in enumerate(parts)], dim=-1)
    jy, jz = (jnp.asarray(t.float().numpy()).astype(dtype) for t in (ty, tz))
    gated = jy * (jz * (1 / (1 + jnp.exp(-jz.astype(jnp.float32))))).astype(dtype)
    want = jL.rmsnorm({"scale": jnp.asarray(tw.float().numpy()).astype(dtype)}, gated)
    atol, rtol = (2e-2, 2e-2) if dtype == "bfloat16" else (2e-5, 2e-4)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=atol, rtol=rtol)


def test_split_rmsnorm_through_ops_counts_no_launch_on_the_cpu():
    """On CPU tensors ``ops.mul_silu_rmsnorm_split`` runs the plain version
    (no launch counted), reduces its sums once through the caller's
    ``reduce`` and, at one shard, equals ``ops.mul_silu_rmsnorm``; a strided
    ``z`` (a slice of a wider projection) is read as it is."""
    rng = np.random.default_rng(0)
    wide = torch.from_numpy(rng.standard_normal((2, 3, 200)).astype(np.float32))
    y, z = wide[..., :64].contiguous(), wide[..., 100:164]
    w = torch.from_numpy((1 + 0.1 * rng.standard_normal(64)).astype(np.float32))
    seen = []
    before = dict(rn.LAUNCHES_BY_PROLOGUE)
    got = ops.mul_silu_rmsnorm_split(y, z, w, 64, lambda s: seen.append(s) or s)
    assert rn.LAUNCHES_BY_PROLOGUE == before
    assert len(seen) == 1 and seen[0].shape == (2, 3) and seen[0].dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ops.mul_silu_rmsnorm(y, z, w).numpy(),
                               atol=2e-6, rtol=2e-6)


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_rmsnorm_kernel_matches_its_plain_version(dtype):
    """Both launches of the split-row form on the card against their plain
    versions at a rank's mamba2-130m rows ([8, 768] of 1536, z in rows of
    1676), each counted once under ``mul_silu_split``: ``y * silu(z)`` bit
    for bit, the partial sums at the f32 tolerance (another summation
    order), the scale at the kernels' tolerance of its type."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    wide = torch.randn((8, 1676), generator=gen, device=dev).to(dtype)
    y = torch.randn((8, 768), generator=gen, device=dev).to(dtype)
    z = wide[:, :768]
    w = (1 + 0.1 * torch.randn(768, generator=gen, device=dev)).to(dtype)
    before = rn.LAUNCHES_BY_PROLOGUE[rn.SPLIT]
    p, s = rn.mul_silu_partial_cuda(y, z)
    pp, sp = rn.mul_silu_partial_plain(y, z)
    torch.testing.assert_close(p, pp, atol=0, rtol=0)
    torch.testing.assert_close(s, sp, atol=2e-5, rtol=2e-4)
    total = s * 2
    out = rn.rmsnorm_scale_cuda(p, total, w, 1536)
    tol = dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16 else dict(atol=2e-5, rtol=2e-4)
    torch.testing.assert_close(out, rn.rmsnorm_scale_plain(pp, total, w, 1536), **tol)
    assert rn.LAUNCHES_BY_PROLOGUE[rn.SPLIT] - before == 2


# ------------------------------------------------------------ the launcher
@pytest.mark.parametrize("arch,extra", [
    ("mamba2-130m", ["--temperature", "0.8", "--top-p", "0.9"]),
    ("whisper-base", ["--profile-mix", "greedy,beam"]),
    ("seamless-m4t", []),
])
def test_launcher_serves_ssm_and_encdec_at_tp2(capfd, arch, extra):
    """``serve --tp 2 --device cpu``: two ranks serve the S-T profile (the
    encoder-decoders with each request's stub frames); rank 0 prints the
    backend, a rank's pool bytes (at most 0.6x) and the reduces, which are
    the model's prefills' and decode steps' counts."""
    m = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--tp", "2",
                    "--n-requests", "3", "--batch-slots", "4", "--max-new", "3",
                    "--profile", "seamless_s2t", *extra])
    assert m["tp"] == 2 and m["backend"] == "gloo" and m["n_requests"] == 3
    assert m["kv_reserved_per_device_bytes"] / m["kv_reserved_bytes"] <= 0.6
    cfg = get_smoke_config(arch)
    assert m["reduces"] == (m["prefills"] * reduces_a_forward(cfg, "prefill")
                            + m["decode_steps"] * reduces_a_forward(cfg, "decode"))
    assert "tp=2 on" in capfd.readouterr().out


def test_split_widths_refuse_grouped_ssm_and_odd_heads():
    """A Mamba-2 config whose heads do not split, or with more than one B/C
    group, is refused by name; whisper-base's odd vocabulary is not."""
    cfg = get_smoke_config("mamba2-130m")
    tp_pool.check_supported(cfg, 2)
    with pytest.raises(NotImplementedError, match="the SSM heads = 4 does not split.*ROADMAP"):
        tp_pool.check_supported(cfg, 3)
    with pytest.raises(NotImplementedError, match="n_groups = 2.*ROADMAP"):
        tp_pool.check_supported(cfg.replace(ssm=dataclasses.replace(cfg.ssm, n_groups=2)), 2)
    tp_pool.check_supported(get_smoke_config("whisper-base").replace(vocab_size=511), 2)
