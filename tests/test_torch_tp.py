"""Port's tensor-parallel serving (``repro_torch.distributed.tp_pool``, the
``tp_*`` step family, ``Scheduler(tp=...)``) against the JAX package's
single-device functions and scheduler.

- The seam at TP = 1: a one-rank group (no process group) gives the plain
  scheduler's tokens; ``tp`` with ``device`` raises; a group needs as many
  devices as ranks; the backend rule.
- TP = 2, two gloo ranks on the CPU, spawned once for the module (a
  ``FileStore`` under ``tmp_path``: no TCP port), params bridged from the
  reference's f32 llama3.2-1b smoke init: tokens equal to the JAX
  scheduler's on the reference's trace (``tests/test_tp.py``'s: 8
  requests of the ``seamless_s2t`` profile, slots 4, pad 16, paged, block
  16, 10 blocks, chunked, budget 4) at temperature 0 and 0.8, on the
  contiguous pool, with the prefix cache and with speculative steps, with
  the JAX run's host counters; each rank's KV bytes at most 0.6x the
  single pool's; the logits of ``tp_prefill``, ``tp_decode_step``,
  ``tp_mixed_step``, ``tp_verify_step`` and the window of
  ``tp_draft_window`` against the reference's single-device functions at
  atol 1e-4 / rtol 1e-3, and each rank's KV heads against the
  reference's cache.
- The collectives' shared slots (``tp_pool.SharedSlots``): two spawned
  ranks' sums, max and broadcasts bit for bit gloo's.

The JAX package is imported inside the tests only: the spawned ranks import
this module and stay free of it."""
import platform

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core import engine, layerskip
from repro_torch.core.scheduler import Scheduler
from repro_torch.distributed import tp_pool
from repro_torch.launch import serve
from repro_torch.models import get_model
from repro_torch.training import data as data_mod

TP = 2
STEP_TOL = dict(atol=1e-4, rtol=1e-3)  # tests/test_torch_model.py's whole-model tolerance
TRACE = dict(pad_to=16, max_new_cap=16, vocab_size=512, arrival_rate=0.0, seed=0)
PAGED = dict(slots=4, pad_to=16, max_new_cap=16, paged=True, block_size=16, num_blocks=10,
             chunked=True, prefill_budget=4)
CONTIGUOUS = dict(slots=4, pad_to=16, max_new_cap=16)
PREFIX_TRACE = dict(n_prefixes=3, prefix_len=8, pad_to=14, max_new_cap=5, vocab_size=512,
                    arrival_rate=0.0, seed=2)
PREFIX = dict(slots=3, pad_to=14, max_new_cap=5, paged=True, block_size=4, num_blocks=12,
              chunked=True, prefill_budget=6, prefix_cache=True)
SPEC_EXIT, SPEC_DRAFT = 1, 3
#: arm -> (trace kind, temperature, top-p, geometry)
ARMS = {"paged t=0": ("poisson", 0.0, 1.0, PAGED),
        "paged t=0.8": ("poisson", 0.8, 0.9, PAGED),
        "contiguous": ("poisson", 0.0, 1.0, CONTIGUOUS),
        "prefix": ("prefix", 0.0, 1.0, PREFIX),
        "speculative": ("speculative", 0.8, 0.9, PAGED)}
COUNTERS = ("n_preemptions", "n_decode_steps", "n_prefills", "n_mixed_steps", "n_chunks",
            "n_spec_steps", "n_prefix_hits")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return get_smoke_config("llama3.2-1b").replace(dtype="float32")


def _trace(serve_mod, kind, temperature, top_p):
    """The arm's requests from ``serve_mod``'s generators (the port's or the
    reference's give the same trace)."""
    if kind == "prefix":
        return serve_mod.shared_prefix_trace(10, **PREFIX_TRACE)
    prof = serve_mod.data_mod.PAPER_PROFILES["seamless_s2t"]
    reqs = serve_mod.poisson_trace(prof, 8, temperature=temperature, top_p=top_p, **TRACE)
    if kind == "speculative":
        serve_mod.apply_profile_mix(reqs, "speculative", exit_layer=SPEC_EXIT,
                                    n_draft=SPEC_DRAFT)
    return reqs


def _step_inputs():
    """The step family's inputs: a prefill of two prompts, a decode token,
    a verify window over the prefilled cache, a draft, and two mixed steps
    over a fresh paged pool (chunks, a decode lane, an idle row)."""
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


def _rank_checks(group, np_params):
    """One rank's share of every TP = 2 check; returns its results."""
    cfg = _cfg()
    tp = tp_pool.TPContext(get_model(cfg), bridge.params_to_torch(cfg, np_params, "cpu"),
                           group)
    out = {"serve": {}, "kv_bytes": {}, "steps": {}}
    for arm, (kind, temp, top_p, geometry) in ARMS.items():
        sched = Scheduler(tp.model, tp.params, tp=tp, **geometry)
        done = sched.run(_trace(serve, kind, temp, top_p))
        out["serve"][arm] = ({r.rid: [int(t) for t in r.tokens] for r in done},
                             {c: getattr(sched, c) for c in COUNTERS},
                             (sched.pool.n_used_blocks - sched.pool.n_cached_blocks
                              if sched.paged else 0))
        out["kv_bytes"][arm] = (tp_pool.max_per_device_bytes(sched.pool.cache, group),
                                tp.whole_bytes(sched.pool.cache))

    x = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
         for k, v in _step_inputs().items()}
    m, p, steps = tp.model, tp.params, out["steps"]
    logits, cache = engine.tp_prefill(m, p, x["tokens"], x["lengths"], x["max_len"])
    steps["prefill"] = logits.numpy()
    steps["kv"] = [cache["layers"][0][k].numpy().copy() for k in ("k", "v")]
    logits, cache = engine.tp_decode_step(m, p, cache, x["token"])
    steps["decode"] = logits.numpy()
    logits, cache = engine.tp_verify_step(m, p, cache, x["window"], x["t_new"],
                                          x["lengths"] + 1)
    steps["verify"] = logits.numpy()
    window, cache = layerskip.tp_draft_window(m, SPEC_EXIT, SPEC_DRAFT, p, cache,
                                              x["draft_token"], x["n_live"],
                                              x["draft_lengths"])
    steps["draft"] = window.numpy()
    pool = m.init_cache(x["nb"], x["bs"], "cpu")
    pool["lengths"] = torch.zeros((3,), dtype=torch.int32)
    pool["block_tables"] = x["bt"]
    steps["mixed"] = []
    for toks, t_new, lengths in x["mixed"]:
        logits, pool = engine.tp_mixed_step(m, p, pool, torch.from_numpy(toks),
                                            torch.from_numpy(t_new), torch.from_numpy(lengths))
        steps["mixed"].append(logits.numpy())
    out["param_bytes"] = tp_pool.max_per_device_bytes(tp.params, group)
    out["reduces"] = group.n_reduces
    return out


@pytest.fixture(scope="module")
def ref():
    """The reference's model and params (JAX), and its params as numpy."""
    import jax

    from repro.configs import SMOKE_CONFIGS
    from repro.models import get_model as jget_model

    jmodel = jget_model(SMOKE_CONFIGS["llama3.2-1b"].replace(dtype="float32"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, jparams, jax.tree.map(np.asarray, jparams)


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    """Every TP = 2 check, run once by two spawned gloo ranks on the CPU."""
    store = tmp_path_factory.mktemp("tp_store") / "store"
    return tp_pool.spawn(_rank_checks, TP, ref[2], devices=["cpu"] * TP,
                         init_file=str(store))


@pytest.fixture(scope="module")
def jax_runs(ref):
    """Each arm through the JAX package's single-device scheduler: tokens,
    counters and the pool's reserved bytes."""
    from repro.core.scheduler import Scheduler as JScheduler
    from repro.launch import serve as jserve

    jmodel, jparams, _ = ref
    runs = {}
    for arm, (kind, temp, top_p, geometry) in ARMS.items():
        js = JScheduler(jmodel, jparams, **geometry)
        done = js.run(_trace(jserve, kind, temp, top_p))
        runs[arm] = ({r.rid: [int(t) for t in r.tokens] for r in done},
                     {c: getattr(js, c) for c in COUNTERS}, js.pool.reserved_bytes)
    return runs


# ------------------------------------------------------------ TP = 2 serving
@pytest.mark.parametrize("arm", list(ARMS))
def test_tp2_tokens_equal_the_jax_scheduler(ranks, jax_runs, arm):
    """Both ranks commit the reference single-device scheduler's tokens,
    steps, preemptions, chunks and speculative steps, and free every
    block."""
    want_tokens, want_counters, _ = jax_runs[arm]
    for rank in ranks:
        tokens, counters, leaked = rank["serve"][arm]
        assert tokens == want_tokens
        assert counters == want_counters
        assert leaked == 0
    assert len(want_tokens) == (10 if arm == "prefix" else 8)
    if arm == "paged t=0":
        assert want_counters["n_chunks"] >= 1 and want_counters["n_mixed_steps"] >= 1
    if arm == "speculative":
        assert want_counters["n_spec_steps"] >= 1
    if arm == "prefix":
        assert want_counters["n_prefix_hits"] >= 1


@pytest.mark.parametrize("arm", ["paged t=0", "contiguous"])
def test_tp2_rank_reserves_at_most_0_6_of_the_pool(ranks, jax_runs, arm):
    """Each rank holds its KV heads: at most 0.6x the single pool's bytes,
    and the ranks' pool, counted once, is the reference's."""
    per_rank, whole = ranks[0]["kv_bytes"][arm]
    single = jax_runs[arm][2]
    assert whole == single
    assert per_rank / single <= 0.6
    assert ranks[1]["kv_bytes"][arm] == (per_rank, whole)


def test_tp2_rank_holds_half_the_params(ranks, ref):
    n_bytes = sum(a.nbytes for a in _leaves(ref[2]))
    assert ranks[0]["param_bytes"] / n_bytes < 0.6
    assert ranks[0]["reduces"] > 0


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.fixture(scope="module")
def jax_steps(ref):
    """The reference's single-device step functions on ``_step_inputs``."""
    import jax.numpy as jnp

    from repro.core import engine as jengine
    from repro.core import layerskip as jlayerskip

    jmodel, jparams, _ = ref
    x = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
         for k, v in _step_inputs().items()}
    out = {}
    logits, cache = jengine.prefill(jmodel, jparams, x["tokens"], x["lengths"],
                                    x["max_len"], None)
    out["prefill"] = np.asarray(logits)
    out["kv"] = [np.asarray(cache["layers"][0][k]) for k in ("k", "v")]
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


@pytest.mark.parametrize("step", ["prefill", "decode", "verify", "mixed", "draft"])
def test_tp2_step_family_matches_the_reference(ranks, jax_steps, step):
    """``tp_prefill`` / ``tp_decode_step`` / ``tp_verify_step`` /
    ``tp_mixed_step`` logits (every rank's, gathered over the vocab) at the
    whole-model tolerance, ``tp_draft_window``'s window exactly, on both
    ranks."""
    for rank in ranks:
        got, want = rank["steps"][step], jax_steps[step]
        if step == "draft":
            np.testing.assert_array_equal(got, want)
        elif step == "mixed":
            for g, w in zip(got, want):
                np.testing.assert_allclose(g[:2], w[:2], **STEP_TOL)  # row 2 idles
        else:
            np.testing.assert_allclose(got, want, **STEP_TOL)


def test_tp2_ranks_hold_their_kv_heads(ranks, jax_steps):
    """The prefill's K/V: rank r holds KV heads [r * Hkv / 2, (r + 1) * Hkv /
    2) of the reference's cache."""
    for r, rank in enumerate(ranks):
        for got, want in zip(rank["steps"]["kv"], jax_steps["kv"]):
            h = want.shape[2] // TP
            np.testing.assert_allclose(got, want[:, :, r * h:(r + 1) * h], **STEP_TOL)


# ------------------------------------------------------------ the seam, TP = 1
def _plain_pair():
    cfg = _cfg()
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    return model, params


def test_tp1_inprocess_token_identity():
    """A one-rank group (no process group) through the TP seam gives the
    plain scheduler's tokens (``tests/test_tp.py:216``)."""
    model, params = _plain_pair()
    prof = data_mod.PAPER_PROFILES["seamless_s2t"]

    def run(tp):
        reqs = serve.poisson_trace(prof, 8, temperature=0.8, top_p=0.9, **TRACE)
        kw = dict(device="cpu") if tp is None else dict(tp=tp)
        sched = Scheduler(model, params, **PAGED, **kw)
        return {r.rid: list(r.tokens) for r in sched.run(reqs)}

    group = tp_pool.make_tp_group(1, ["cpu"])
    tp = tp_pool.TPContext(model, params, group)
    assert run(tp) == run(None)
    assert group.n_reduces == 0 and tp.executables().decode_step is engine.tp_decode_step


def test_scheduler_rejects_tp_plus_device_pin():
    model, params = _plain_pair()
    tp = tp_pool.TPContext(model, params, tp_pool.make_tp_group(1, ["cpu"]))
    with pytest.raises(ValueError, match="mutually exclusive"):
        Scheduler(model, params, slots=2, pad_to=16, max_new_cap=16, paged=True,
                  block_size=16, num_blocks=8, tp=tp, device="cpu")


def test_make_tp_group_needs_enough_devices():
    with pytest.raises(ValueError, match="exactly tp"):
        tp_pool.make_tp_group(torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="exactly tp"):
        tp_pool.make_tp_group(2, ["cpu"])


@pytest.mark.parametrize("devices,backend", [(["cpu", "cpu"], "gloo"),
                                             (["cuda:0", "cuda:0"], "gloo"),
                                             (["cuda:0", "cuda:1"], "nccl")])
def test_backend_rule(devices, backend):
    """gloo on the CPU and for ranks sharing a card; nccl a card a rank."""
    assert tp_pool.backend_for([torch.device(d) for d in devices]) == backend


def test_launcher_serves_tp2_on_the_cpu(capfd):
    """``serve --tp 2 --device cpu``: two ranks, rank 0 prints the KV bytes
    a rank reserves."""
    m = serve.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--tp", "2",
                    "--n-requests", "4", "--batch-slots", "2", "--max-new", "4",
                    "--profile", "seamless_s2t", "--paged", "--chunked",
                    "--num-blocks", "40", "--prefill-budget", "16"])
    assert m["tp"] == 2 and m["backend"] == "gloo" and m["n_requests"] == 4
    assert m["kv_reserved_per_device_bytes"] / m["kv_reserved_bytes"] <= 0.6
    assert "tp=2 on" in capfd.readouterr().out


def _slot_checks(group):
    """On each rank, through the group's shared slots and through gloo, on
    the same rank-seeded tensors: sums in bf16 and f32, a max, a broadcast
    from rank 1 and a host max, more collectives in a row than the slots'
    two parities; a tensor above SLOT_BYTES (through gloo)."""
    import torch.distributed as dist

    gen = torch.Generator().manual_seed(group.rank)
    out = {"slots": group.slots is not None}
    for name, dtype, op in [("sum bf16", torch.bfloat16, dist.ReduceOp.SUM),
                            ("sum f32", torch.float32, dist.ReduceOp.SUM),
                            ("max bf16", torch.bfloat16, dist.ReduceOp.MAX)]:
        x = torch.randn(3, 5, 64, generator=gen).to(dtype)
        got, want = x.clone(), x.clone()
        for _ in range(3):
            group.all_reduce(got, op)
            dist.all_reduce(want, op=op)
        out[name] = (got, want)
    got = torch.arange(28, dtype=torch.float32).reshape(4, 7) * (group.rank + 1)
    want = got.clone()
    group.broadcast(got, src=1)
    dist.broadcast(want, src=1)
    out["broadcast"] = (got, want)
    out["host max"] = (group.max(10 + group.rank), 11)
    big = torch.full((tp_pool.SLOT_BYTES // 4 + 1,), float(group.rank + 1))
    group.all_reduce(big)
    out["above the slots"] = (big[:4], torch.full((4,), 3.0))
    # tensors leave the rank as their dtype and bytes (a tensor's storage
    # would be shared with a process that is gone)
    return {k: tuple((str(t.dtype), t.contiguous().view(-1).view(torch.uint8).numpy().copy())
                     if isinstance(t, torch.Tensor) else t for t in v)
            if isinstance(v, tuple) else v for k, v in out.items()}


@pytest.fixture(scope="module")
def slot_ranks(tmp_path_factory):
    store = tmp_path_factory.mktemp("tp_slots_store") / "store"
    return tp_pool.spawn(_slot_checks, TP, devices=["cpu"] * TP, init_file=str(store))


@pytest.mark.parametrize("case", ["sum bf16", "sum f32", "max bf16", "broadcast", "host max",
                                  "above the slots"])
def test_shared_slots_give_gloos_results(slot_ranks, case):
    """Ranks on one x86-64 host reduce and broadcast through shared slots,
    bit for bit gloo's results on every rank."""
    for rank in slot_ranks:
        assert rank["slots"] == (platform.machine() == "x86_64")
        got, want = rank[case]
        if isinstance(got, tuple):  # (dtype, bytes): bit for bit
            assert got[0] == want[0]
            np.testing.assert_array_equal(got[1], want[1])
        else:
            assert got == want


def test_tp_steps_are_hot_paths():
    from repro_torch.analysis.hotpath import HOT_PATHS

    for name in ("engine.tp_prefill", "engine.tp_decode_step", "engine.tp_mixed_step",
                 "engine.tp_verify_step", "layerskip.tp_draft_window"):
        assert f"repro_torch.core.{name}" in HOT_PATHS

