"""Port's tensor-parallel serving of the vlm, moe and mla_moe families and
of AutoQuant'd weights (``repro_torch.distributed.tp_pool``, the ``tp_*``
step family, ``Scheduler(tp=...)``) against the JAX package's
single-device functions and scheduler.

Two gloo ranks on the CPU, spawned once for the module (a ``FileStore``
under ``tmp_path``: no TCP port), one intra-op thread each, params bridged
from the reference's f32 smoke inits of ``chameleon-34b`` (qk-norm, GQA),
``qwen3-moe-30b-a3b`` (experts split on their axis) and
``deepseek-v2-236b`` (MLA's heads split over the whole latent, a dense
first layer, a shared expert):

- tokens and host counters equal to the JAX single-device scheduler's on
  ``tests/test_torch_tp.py``'s trace at t = 0 on the paged, chunked pool
  and on the contiguous pool, and at t = 0.8 with speculative steps on the
  paged one; the prefix cache for the moe family, a contrastive (T-I) group
  for the vlm;
- the logits of the five ``tp_*`` steps against the reference's
  single-device functions at atol 1e-4 / rtol 1e-3 (the draft window
  exactly), and each rank's KV heads (or the whole latent) against the
  reference's prefill cache;
- each rank's shard shapes (experts E / tp, ``q_up`` / ``kv_up``
  columns, ``wo`` rows), its KV bytes (head-split K/V half the pool, the
  latent whole) and its reduces a forward;
- AutoQuant ``wo`` and ``dyn`` (quantized whole, then cut) on the llama
  smoke config: the step family against the reference's quantized
  single-device steps.

The JAX package is imported inside the fixtures only: the spawned ranks
import this module and stay free of it. The JAX runs go on in the parent
while the ranks run."""
import threading

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core import engine, layerskip
from repro_torch.core.quantization import quantize_params
from repro_torch.core.scheduler import Scheduler
from repro_torch.distributed import sharding, tp_pool
from repro_torch.launch import serve
from repro_torch.models import get_model

TP = 2
FAMILIES = ("chameleon-34b", "qwen3-moe-30b-a3b", "deepseek-v2-236b")
QUANT = ("wo", "dyn")
STEP_TOL = dict(atol=1e-4, rtol=1e-3)  # tests/test_torch_model.py's whole-model tolerance
TRACE = dict(pad_to=16, max_new_cap=16, vocab_size=512, arrival_rate=0.0, seed=0)
PAGED = dict(slots=4, pad_to=16, max_new_cap=16, paged=True, block_size=16, num_blocks=10,
             chunked=True, prefill_budget=4)
CONTIGUOUS = dict(slots=4, pad_to=16, max_new_cap=16)
PREFIX_TRACE = dict(n_prefixes=3, prefix_len=8, pad_to=14, max_new_cap=5, vocab_size=512,
                    arrival_rate=0.0, seed=2)
PREFIX = dict(slots=3, pad_to=14, max_new_cap=5, paged=True, block_size=4, num_blocks=12,
              chunked=True, prefill_budget=6, prefix_cache=True)
GROUPS = dict(slots=4, pad_to=16, max_new_cap=8, paged=True, block_size=4, num_blocks=40)
SPEC_EXIT, SPEC_DRAFT = 1, 3
GUIDANCE = 2.0
#: arm -> (trace kind, temperature, top-p, geometry): greedy on both pools,
#: sampled (t = 0.8) with speculative windows on the paged one
BASE_ARMS = {"paged t=0": ("poisson", 0.0, 1.0, PAGED),
             "contiguous": ("poisson", 0.0, 1.0, CONTIGUOUS),
             "speculative": ("speculative", 0.8, 0.9, PAGED)}
ARMS = {"chameleon-34b": dict(BASE_ARMS, contrastive=("contrastive", 0.0, 1.0, GROUPS)),
        "qwen3-moe-30b-a3b": dict(BASE_ARMS, prefix=("prefix", 0.0, 1.0, PREFIX)),
        "deepseek-v2-236b": dict(BASE_ARMS)}
CASES = [(arch, arm) for arch in FAMILIES for arm in ARMS[arch]]
COUNTERS = ("n_preemptions", "n_decode_steps", "n_prefills", "n_mixed_steps", "n_chunks",
            "n_spec_steps", "n_spec_accepted", "n_prefix_hits", "n_group_admissions")
STEPS = ("prefill", "decode", "verify", "mixed", "draft")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch):
    return get_smoke_config(arch).replace(dtype="float32")


def _trace(serve_mod, kind, temperature, top_p, vocab_offset=None):
    """The arm's requests from ``serve_mod``'s generators (the port's or the
    reference's give the same trace)."""
    if kind == "prefix":
        return serve_mod.shared_prefix_trace(10, **PREFIX_TRACE)
    prof = serve_mod.data_mod.PAPER_PROFILES["seamless_s2t"]
    n = 4 if kind == "contrastive" else 8
    reqs = serve_mod.poisson_trace(prof, n, temperature=temperature, top_p=top_p,
                                   **dict(TRACE, max_new_cap=8 if kind == "contrastive"
                                          else TRACE["max_new_cap"]))
    if kind == "speculative":
        serve_mod.apply_profile_mix(reqs, "speculative", exit_layer=SPEC_EXIT,
                                    n_draft=SPEC_DRAFT)
    if kind == "contrastive":
        serve_mod.apply_profile_mix(reqs, "greedy,contrastive", guidance=GUIDANCE,
                                    mask_offset=vocab_offset)
    return reqs


def _image_offset(cfg):
    return cfg.vocab_size - cfg.vlm.image_vocab if cfg.vlm is not None else None


def _step_inputs():
    """The step family's inputs (``tests/test_torch_tp.py``'s): a prefill of
    two prompts, a decode token, a verify window over the prefilled cache, a
    draft, and two mixed steps over a fresh paged pool."""
    rng = np.random.default_rng(7)
    return dict(
        tokens=rng.integers(0, 512, size=(2, 8)).astype(np.int32),
        lengths=np.array([8, 5], np.int32), max_len=24,
        token=np.array([3, 7], np.int32),
        window=rng.integers(0, 512, size=(2, 4)).astype(np.int32),
        t_new=np.array([4, 2], np.int32),
        draft_token=np.array([5, 9], np.int32), n_live=np.array([3, 1], np.int32),
        draft_lengths=np.array([10, 7], np.int32),
        bt=np.array([[1, 2, 3], [4, 5, 6], [7, 0, 0]], np.int32), nb=8, bs=4,
        mixed=[(rng.integers(0, 512, size=(3, 5)).astype(np.int32),
                np.array([5, 3, 0], np.int32), np.array([0, 0, 0], np.int32)),
               (rng.integers(0, 512, size=(3, 5)).astype(np.int32),
                np.array([1, 4, 2], np.int32), np.array([5, 3, 0], np.int32))],
    )


def _tp_steps(tp):
    """The five ``tp_*`` steps on ``_step_inputs``: their (gathered) logits,
    the draft window, the prefill's first-layer cache leaves and the
    reduces of one decode step."""
    x = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
         for k, v in _step_inputs().items()}
    m, p, out = tp.model, tp.params, {}
    logits, cache = engine.tp_prefill(m, p, x["tokens"], x["lengths"], x["max_len"])
    out["prefill"] = logits.numpy()
    out["kv"] = {k: v.numpy().copy() for k, v in cache["layers"][0].items()}
    n0 = tp.group.n_reduces
    logits, cache = engine.tp_decode_step(m, p, cache, x["token"])
    out["decode_reduces"] = tp.group.n_reduces - n0
    out["decode"] = logits.numpy()
    logits, cache = engine.tp_verify_step(m, p, cache, x["window"], x["t_new"],
                                          x["lengths"] + 1)
    out["verify"] = logits.numpy()
    window, cache = layerskip.tp_draft_window(m, SPEC_EXIT, SPEC_DRAFT, p, cache,
                                              x["draft_token"], x["n_live"],
                                              x["draft_lengths"])
    out["draft"] = window.numpy()
    pool = m.init_cache(x["nb"], x["bs"], "cpu")
    pool["lengths"] = torch.zeros((3,), dtype=torch.int32)
    pool["block_tables"] = x["bt"]
    out["mixed"] = []
    for toks, t_new, lengths in x["mixed"]:
        logits, pool = engine.tp_mixed_step(m, p, pool, torch.from_numpy(toks),
                                            torch.from_numpy(t_new), torch.from_numpy(lengths))
        out["mixed"].append(logits.numpy())
    return out


def _flat_shapes(tree):
    out = []
    sharding.map_with_path(lambda p, t: out.append((p, tuple(t.shape))), tree)
    return out


def _rank_checks(group, np_params):
    """One rank's share of every check; returns its results."""
    out = {}
    for arch in FAMILIES:
        cfg = _cfg(arch)
        tp = tp_pool.TPContext(get_model(cfg), bridge.params_to_torch(cfg, np_params[arch],
                                                                      "cpu"), group)
        res = {"serve": {}, "kv_bytes": {}, "shapes": dict(_flat_shapes(tp.params))}
        for arm, (kind, temp, top_p, geometry) in ARMS[arch].items():
            sched = Scheduler(tp.model, tp.params, tp=tp, **geometry)
            done = sched.run(_trace(serve, kind, temp, top_p, _image_offset(cfg)))
            res["serve"][arm] = ({r.rid: [int(t) for t in r.tokens] for r in done},
                                 {c: getattr(sched, c) for c in COUNTERS},
                                 (sched.pool.n_used_blocks - sched.pool.n_cached_blocks
                                  if sched.paged else 0))
            res["kv_bytes"][arm] = (tp_pool.max_per_device_bytes(sched.pool.cache, group),
                                    tp.whole_bytes(sched.pool.cache),
                                    dict(_flat_shapes(sched.pool.cache["layers"][0])))
        res["steps"] = _tp_steps(tp)
        res["param_bytes"] = tp_pool.max_per_device_bytes(tp.params, group)
        out[arch] = res
    cfg = _cfg("llama3.2-1b")
    for mode in QUANT:
        params = quantize_params(bridge.params_to_torch(cfg, np_params["llama3.2-1b"], "cpu"),
                                 mode)
        tp = tp_pool.TPContext(get_model(cfg), params, group)
        out[mode] = {"steps": _tp_steps(tp), "shapes": dict(_flat_shapes(tp.params))}
    return out


def _jax_pair(arch):
    import jax

    from repro.configs import SMOKE_CONFIGS
    from repro.models import get_model as jget_model

    jmodel = jget_model(SMOKE_CONFIGS[arch].replace(dtype="float32"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, jparams


@pytest.fixture(scope="module")
def ref():
    """The reference's (model, params) of each smoke config, and every
    params tree as numpy for the ranks."""
    import jax

    pairs = {arch: _jax_pair(arch) for arch in FAMILIES + ("llama3.2-1b",)}
    return pairs, {a: jax.tree.map(np.asarray, p[1]) for a, p in pairs.items()}


@pytest.fixture(scope="module")
def ranks_started(ref, tmp_path_factory):
    """Two spawned gloo ranks on the CPU running every TP = 2 check, in a
    thread of their own: the JAX fixtures run meanwhile."""
    store = tmp_path_factory.mktemp("tp_families_store") / "store"
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
    """Each family's arms through the JAX package's single-device scheduler:
    tokens, counters and the pool's reserved bytes."""
    from repro.core.scheduler import Scheduler as JScheduler
    from repro.launch import serve as jserve

    runs = {}
    for arch, arm in CASES:
        jmodel, jparams = ref[0][arch]
        kind, temp, top_p, geometry = ARMS[arch][arm]
        js = JScheduler(jmodel, jparams, **geometry)
        done = js.run(_trace(jserve, kind, temp, top_p, _image_offset(_cfg(arch))))
        runs[arch, arm] = ({r.rid: [int(t) for t in r.tokens] for r in done},
                           {c: getattr(js, c) for c in COUNTERS}, js.pool.reserved_bytes)
    return runs


def _jax_steps(jmodel, jparams):
    import jax.numpy as jnp

    from repro.core import engine as jengine
    from repro.core import layerskip as jlayerskip

    x = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
         for k, v in _step_inputs().items()}
    out = {}
    logits, cache = jengine.prefill(jmodel, jparams, x["tokens"], x["lengths"],
                                    x["max_len"], None)
    out["prefill"] = np.asarray(logits)
    out["kv"] = {k: np.asarray(v) for k, v in cache["layers"][0].items()}
    logits, cache = jengine.decode_step(jmodel, jparams, cache, x["token"])
    out["decode"] = np.asarray(logits)
    logits, cache = jengine.verify_step(jmodel, jparams, cache, x["window"], x["t_new"],
                                        x["lengths"] + 1)
    out["verify"] = np.asarray(logits)
    window, cache = jlayerskip.draft_window(jmodel, SPEC_EXIT, SPEC_DRAFT, jparams, cache,
                                            x["draft_token"], x["n_live"],
                                            x["draft_lengths"])
    out["draft"] = np.asarray(window)
    pool = jmodel.init_cache(x["nb"], x["bs"])
    pool = {**pool, "lengths": jnp.zeros((3,), jnp.int32), "block_tables": x["bt"]}
    out["mixed"] = []
    for toks, t_new, lengths in x["mixed"]:
        logits, pool = jengine.mixed_step(jmodel, jparams, pool, jnp.asarray(toks),
                                          jnp.asarray(t_new), jnp.asarray(lengths))
        out["mixed"].append(np.asarray(logits))
    return out


@pytest.fixture(scope="module")
def jax_steps(ref, jax_runs):
    """The reference's single-device step functions on ``_step_inputs`` for
    each family, and for the llama smoke config quantized whole by the
    reference's ``quantize_params`` in each mode."""
    from repro.core.quantization import quantize_params as jquantize

    out = {arch: _jax_steps(*ref[0][arch]) for arch in FAMILIES}
    jmodel, jparams = ref[0]["llama3.2-1b"]
    for mode in QUANT:
        out[mode] = _jax_steps(jmodel, jquantize(jparams, mode))
    return out


@pytest.fixture(scope="module")
def ranks(ranks_started, jax_runs, jax_steps):
    thread, box = ranks_started
    thread.join()
    if "error" in box:
        raise box["error"]
    return box["ranks"]


# ------------------------------------------------------------ TP = 2 serving
@pytest.mark.parametrize("arch,arm", CASES)
def test_tp2_family_tokens_equal_the_jax_scheduler(ranks, jax_runs, arch, arm):
    """Both ranks commit the reference single-device scheduler's tokens and
    its preemptions, steps, chunks, speculative steps, prefix hits and
    group admissions, and free every block."""
    want_tokens, want_counters, _ = jax_runs[arch, arm]
    for rank in ranks:
        tokens, counters, leaked = rank[arch]["serve"][arm]
        assert tokens == want_tokens
        assert counters == want_counters
        assert leaked == 0
    if arm == "paged t=0":
        assert want_counters["n_chunks"] >= 1 and want_counters["n_mixed_steps"] >= 1
    if arm == "speculative":
        assert want_counters["n_spec_steps"] >= 1
    if arm == "prefix":
        assert want_counters["n_prefix_hits"] >= 1
    if arm == "contrastive":
        cfg = _cfg(arch)
        assert want_counters["n_group_admissions"] >= 1
        groups = [rid for rid in want_tokens if rid % 2 == 1]
        assert all(t >= _image_offset(cfg) for rid in groups for t in want_tokens[rid])


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("arm", ["paged t=0", "contiguous"])
def test_tp2_family_kv_bytes_follow_the_reference_specs(ranks, jax_runs, arch, arm):
    """Head-split K/V: a rank holds half the pool's K/V bytes (the lengths
    and tables whole); MLA's latent: whole on every rank. Counted once, the
    ranks' pool is the reference's."""
    per_rank, whole, leaves = ranks[0][arch]["kv_bytes"][arm]
    single = jax_runs[arch, arm][2]
    assert whole == single
    assert ranks[1][arch]["kv_bytes"][arm] == (per_rank, whole, leaves)
    cfg = _cfg(arch)
    if cfg.mla is not None:
        assert set(leaves) == {"latent"}
        assert leaves["latent"][-1] == cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim
        assert per_rank == single
    else:
        assert leaves["k"][-2:] == (cfg.n_kv_heads // TP, cfg.head_dim)
        assert per_rank / single <= 0.5 + 1e-3


@pytest.mark.parametrize("arch", FAMILIES)
def test_tp2_family_shard_shapes(ranks, arch):
    """Each rank's shard: experts E / tp on their axis, ``q_up`` / ``kv_up``
    and q/k/v columns and ``wo`` rows at a rank's heads, the router, the
    MLA down projections and every norm whole; about half the params a
    rank."""
    cfg = _cfg(arch)
    d = cfg.d_model
    for rank in ranks:
        shapes = rank[arch]["shapes"]
        if cfg.mla is not None:
            m = cfg.mla
            assert shapes["layers/0/attn/q_up/w"] == (
                m.q_lora_rank, cfg.n_heads // TP * (m.qk_nope_dim + m.qk_rope_dim))
            assert shapes["layers/0/attn/kv_up/w"] == (
                m.kv_lora_rank, cfg.n_heads // TP * (m.qk_nope_dim + m.v_head_dim))
            assert shapes["layers/0/attn/wo/w"] == (cfg.n_heads // TP * m.v_head_dim, d)
            assert shapes["layers/0/attn/kv_down/w"] == (d, m.kv_lora_rank + m.qk_rope_dim)
            assert shapes["layers/0/attn/q_down/w"] == (d, m.q_lora_rank)
            assert shapes["layers/0/ffn/w1/w"] == (d, cfg.moe.d_ff_dense // TP)
        else:
            hd = cfg.head_dim
            assert shapes["layers/0/attn/wq/w"] == (d, cfg.n_heads // TP * hd)
            assert shapes["layers/0/attn/wk/w"] == (d, cfg.n_kv_heads // TP * hd)
            assert shapes["layers/0/attn/wo/w"] == (cfg.n_heads // TP * hd, d)
            assert shapes["layers/0/attn/q_norm/scale"] == (hd,)
        if cfg.moe is not None:
            e, f = cfg.moe.n_experts, cfg.moe.d_ff_expert
            layer = f"layers/{cfg.moe.first_dense_layers}/moe"
            assert shapes[f"{layer}/w1"] == (e // TP, d, f)
            assert shapes[f"{layer}/w2"] == (e // TP, f, d)
            assert shapes[f"{layer}/router/w"] == (d, e)
            if cfg.moe.n_shared_experts:
                s = cfg.moe.n_shared_experts * f
                assert shapes[f"{layer}/shared/w1/w"] == (d, s // TP)
                assert shapes[f"{layer}/shared/w2/w"] == (s // TP, d)
    np_bytes = sum(int(np.prod(s)) * 4 for s in ranks[0][arch]["shapes"].values())
    assert ranks[0][arch]["param_bytes"] == np_bytes < 0.6 * _whole_bytes(cfg)


def _whole_bytes(cfg):
    with torch.device("meta"):
        params = get_model(cfg).init(None, "meta")
    return sum(int(np.prod(s)) * 4 for _, s in _flat_shapes(params))


def reduces_per_forward(cfg, quant=None):
    """The reduces a TP forward of ``cfg`` makes, counted from the model's
    structure: the embedding and the logits' gather, two a layer (the
    attention, and the FFN or MoE: a MoE layer's routed and shared partials
    share one), and under ``dyn`` a max-reduce a row-parallel linear
    (``wo``, and a dense or shared FFN's ``w2``; the experts' stacks stay
    bf16)."""
    n = 2
    for i in range(cfg.n_layers):
        n += 2
        if quant == "dyn":
            moe = cfg.moe is not None and i >= cfg.moe.first_dense_layers
            n += 2 if not moe or cfg.moe.n_shared_experts else 1
    return n


@pytest.mark.parametrize("arch", FAMILIES + QUANT)
def test_tp2_decode_reduces_a_forward(ranks, arch):
    """One decode step's reduces on each rank: the embedding, the logits'
    gather and two a layer (a MoE layer's routed and shared partials in
    one), plus a max a ``dyn`` row-parallel linear."""
    cfg = _cfg("llama3.2-1b" if arch in QUANT else arch)
    want = reduces_per_forward(cfg, arch if arch in QUANT else None)
    assert want == 2 + (4 if arch == "dyn" else 2) * cfg.n_layers
    for rank in ranks:
        assert rank[arch]["steps"]["decode_reduces"] == want


@pytest.mark.parametrize("arch", FAMILIES + QUANT)
@pytest.mark.parametrize("step", STEPS)
def test_tp2_family_step_family_matches_the_reference(ranks, jax_steps, arch, step):
    """``tp_prefill`` / ``tp_decode_step`` / ``tp_verify_step`` /
    ``tp_mixed_step`` logits (gathered over the vocab) at the whole-model
    tolerance and ``tp_draft_window``'s window exactly, on both ranks; for
    ``wo`` / ``dyn`` against the reference's quantized single-device
    steps."""
    for rank in ranks:
        got, want = rank[arch]["steps"][step], jax_steps[arch][step]
        if step == "draft":
            np.testing.assert_array_equal(got, want)
        elif step == "mixed":
            for g, w in zip(got, want):
                np.testing.assert_allclose(g[:2], w[:2], **STEP_TOL)  # row 2 idles
        else:
            np.testing.assert_allclose(got, want, **STEP_TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_tp2_ranks_hold_their_kv_heads_or_the_whole_latent(ranks, jax_steps, arch):
    """The prefill's first-layer cache: rank r holds KV heads [r * Hkv / 2,
    (r + 1) * Hkv / 2) of the reference's, or the reference's whole
    latent."""
    want = jax_steps[arch]["kv"]
    for r, rank in enumerate(ranks):
        got = rank[arch]["steps"]["kv"]
        assert set(got) == set(want)
        for name, w in want.items():
            if name == "latent":
                np.testing.assert_allclose(got[name], w, **STEP_TOL)
                continue
            h = w.shape[2] // TP
            np.testing.assert_allclose(got[name], w[:, :, r * h:(r + 1) * h], **STEP_TOL)


@pytest.mark.parametrize("mode", QUANT)
def test_tp2_autoquant_shards_cut_the_whole_trees_codes(ranks, mode):
    """The quantized shard: ``w_q_*`` cut as its weight, ``w_scale`` with a
    column-parallel leaf's columns and whole beside a row-parallel one."""
    cfg = _cfg("llama3.2-1b")
    d, hd = cfg.d_model, cfg.head_dim
    for rank in ranks:
        shapes = rank[mode]["shapes"]
        q = f"w_q_{mode}"
        assert shapes[f"layers/0/attn/wq/{q}"] == (d, cfg.n_heads // TP * hd)
        assert shapes["layers/0/attn/wq/w_scale"] == (cfg.n_heads // TP * hd,)
        assert shapes[f"layers/0/attn/wo/{q}"] == (cfg.n_heads // TP * hd, d)
        assert shapes["layers/0/attn/wo/w_scale"] == (d,)
        assert shapes[f"layers/0/ffn/w2/{q}"] == (cfg.d_ff // TP, d)
        assert shapes["layers/0/ffn/w1/w_scale"] == (cfg.d_ff // TP,)


# ------------------------------------------------------------ the launcher
@pytest.mark.parametrize("arch,extra", [
    ("chameleon-34b", ["--quant", "dyn", "--paged", "--chunked", "--num-blocks", "40",
                       "--prefill-budget", "16"]),
    ("qwen3-moe-30b-a3b", ["--paged", "--chunked", "--num-blocks", "40",
                           "--prefill-budget", "16"]),
    ("deepseek-v2-236b", []),
])
def test_launcher_serves_the_families_at_tp2(capfd, arch, extra):
    """``serve --tp 2 --device cpu`` for each family (chameleon's quantized
    whole by ``--quant dyn``): two ranks, rank 0 prints the backend, the
    bytes a rank holds and the reduces it measured a forward."""
    m = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--tp", "2",
                    "--n-requests", "2", "--batch-slots", "2", "--max-new", "2",
                    "--profile", "seamless_s2t", *extra])
    assert m["tp"] == 2 and m["backend"] == "gloo" and m["n_requests"] == 2
    cfg = get_smoke_config(arch)
    per = m["kv_reserved_per_device_bytes"] / m["kv_reserved_bytes"]
    assert per == 1.0 if cfg.mla is not None else per <= 0.6
    quant = "dyn" if "--quant" in extra else None
    out = capfd.readouterr().out
    assert "tp=2 on" in out
    assert m["reduces"] == reduces_per_forward(cfg, quant) * m["forwards"]
    assert f"{reduces_per_forward(cfg, quant)} a forward" in out


@pytest.mark.parametrize("arch", ["hstu"])
def test_launcher_refuses_the_other_families_by_name(arch):
    """``serve --tp 2`` refuses the hstu family before any rank starts,
    naming the ROADMAP item (the ssm, encdec and seamless families serve:
    ``tests/test_torch_tp_ssm_encdec.py``; the hybrid:
    ``tests/test_torch_tp_hybrid.py``)."""
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1, step 6"):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--tp", "2"])
