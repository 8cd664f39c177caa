"""Port's tensor-parallel serving of the hybrid family (``recurrentgemma-2b``)
and its sequence-parallel decode (``attention.sp_decode``) against the JAX
package's single-device functions, scheduler and ``_sp_decode``.

Two gloo ranks on the CPU, spawned once for the module (a ``FileStore``
under ``tmp_path``: no TCP port), one intra-op thread each, params bridged
from the reference's f32 ``recurrentgemma-2b`` smoke init (3 layers: two
RG-LRU blocks, one local attention of 4 q heads over one KV head, window
32). A rank holds its 64 of 128 RG-LRU channels and 2 q heads; its ring of
``S = min(max_len, 32)`` rows splits along the rows where S is even
(``sharding.cache_specs_tp``'s sequence fallback) and is whole on every
rank where it is odd:

- tokens and host counters equal to the JAX single-device scheduler's,
  greedy and at t = 0.8, on three rings: S = 32 (split), S = 31 (whole)
  and S = 32 wrapped by prompts padded to 48;
- ``tp_prefill`` / ``tp_decode_step`` logits against the reference's
  single-device functions at atol 1e-4 / rtol 1e-3 on a split, a whole and
  a wrapped ring, and each rank's ring rows, RG-LRU state and conv tail
  channels against the reference's cache at its indices, before and after
  the decode step's owner-only write;
- each rank's params the reference's at its channels and heads (``wk`` /
  ``wv`` whole), its pool bytes (at most 0.6x on a split ring), the
  reduces of a prefill and of a decode step on each route;
- ``sp_decode`` on the two ranks at the reference test's shapes against
  ``repro.kernels.ref.decode_attention_ref`` (1e-5) with its cache bit for
  bit ``write_decode``'s, and over a ring that wraps;
- the partial form's and the merge's plain versions against the
  reference's ``decode_attention_partial`` / ``combine_partial_attention``,
  and (``cuda``-marked: the card only) their kernels against their plain
  versions;
- ``serve --tp 2 --arch recurrentgemma-2b --smoke --device cpu``.

The JAX package is imported inside the fixtures and tests only: the spawned
ranks import this module and stay free of it. The JAX runs go on in the
parent while the ranks run."""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import engine
from repro_torch.core.scheduler import Scheduler
from repro_torch.distributed import sharding, tp_pool
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import attention as A
from repro_torch.models import get_model

TP = 2
ARCH = "recurrentgemma-2b"
STEP_TOL = dict(atol=1e-4, rtol=1e-3)  # tests/test_torch_model.py's whole-model tolerance
F32 = dict(atol=2e-5, rtol=2e-4)  # tests/test_kernels.py's f32 kernel tolerance
#: ring -> (scheduler geometry, the trace's prompt pad); S = min(pad_to +
#: max_new_cap + 1, 32)
RINGS = {"split S=32": (dict(slots=4, pad_to=16, max_new_cap=16), 16),
         "whole S=31": (dict(slots=4, pad_to=16, max_new_cap=14), 16),
         "wrapped S=32": (dict(slots=4, pad_to=48, max_new_cap=16), 48)}
ARMS = {"greedy": (0.0, 1.0), "t=0.8": (0.8, 0.9)}
CASES = [(ring, arm) for ring in RINGS for arm in ARMS]
COUNTERS = ("n_preemptions", "n_decode_steps", "n_prefills")
#: step -> (prompt tokens [2, T], prompt lengths, max_len): the ring of
#: min(max_len, 32) rows split (24), whole (25), split and wrapped by a
#: 40-token prompt (48: S = 32)
STEPS = {"split": (8, [8, 5], 24), "whole": (8, [8, 5], 25), "wrapped": (40, [40, 37], 48)}
#: the reference test's shapes (tests/test_distributed.py)
SP = dict(b=4, s=32, hq=8, hkv=2, d=16, lengths=[5, 12, 31, 20])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return get_smoke_config(ARCH).replace(dtype="float32")


def _trace(serve_mod, ring, temperature, top_p):
    prof = serve_mod.data_mod.PAPER_PROFILES["seamless_s2t"]
    return serve_mod.poisson_trace(prof, 8, pad_to=RINGS[ring][1], max_new_cap=14,
                                   vocab_size=512, arrival_rate=0.0, seed=0,
                                   temperature=temperature, top_p=top_p)


def _step_inputs(step):
    t, lengths, max_len = STEPS[step]
    rng = np.random.default_rng(7)
    return dict(tokens=rng.integers(0, 512, size=(2, t)).astype(np.int32),
                lengths=np.array(lengths, np.int32), max_len=max_len,
                token=np.array([3, 7], np.int32))


def _leaves(tree):
    """{path: numpy copy} of a cache tree's leaves (torch or JAX)."""
    out = {}
    sharding.map_with_path(lambda p, t: out.__setitem__(p, np.array(t)), tree)
    return out


def _tp_steps(tp, step):
    """``tp_prefill`` then ``tp_decode_step`` on ``_step_inputs(step)``:
    their gathered logits, the cache's leaves after each and the reduces of
    each."""
    x = _step_inputs(step)
    t = torch.from_numpy
    out = {}
    n0 = tp.group.n_reduces
    logits, cache = engine.tp_prefill(tp.model, tp.params, t(x["tokens"]), t(x["lengths"]),
                                      x["max_len"])
    out["prefill_reduces"] = tp.group.n_reduces - n0
    out["prefill"], out["prefill_cache"] = logits.numpy(), _leaves(cache["layers"])
    n0 = tp.group.n_reduces
    logits, cache = engine.tp_decode_step(tp.model, tp.params, cache, t(x["token"]))
    out["decode_reduces"] = tp.group.n_reduces - n0
    out["decode"], out["decode_cache"] = logits.numpy(), _leaves(cache["layers"])
    return out


def _sp_inputs(seed=0):
    c = SP
    rng = np.random.default_rng(seed)
    ck, cv = (rng.standard_normal((c["b"], c["s"], c["hkv"], c["d"])).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.standard_normal((c["b"], c["hkv"], c["d"])).astype(np.float32)
              for _ in range(2))
    q = rng.standard_normal((c["b"], c["hq"], c["d"])).astype(np.float32)
    return ck, cv, kn, vn, q


def _sp_run(group, lengths, ring):
    """``sp_decode`` over this rank's half of ``_sp_inputs``' cache: (out,
    its K and V rows after the write, the reduces)."""
    ck, cv, kn, vn, q = (torch.from_numpy(a) for a in _sp_inputs())
    n = SP["s"] // group.size
    rows = slice(group.rank * n, (group.rank + 1) * n)
    cache = {"k": ck[:, rows].clone(), "v": cv[:, rows].clone()}
    n0 = group.n_reduces
    out, cache = A.sp_decode(cache, kn, vn, q, torch.tensor(lengths, dtype=torch.int32), group,
                             ring=ring)
    return out.numpy(), cache["k"].numpy(), cache["v"].numpy(), group.n_reduces - n0


def _rank_checks(group, np_params):
    """One rank's share of every check; returns its results (numpy)."""
    cfg = _cfg()
    whole = bridge.params_to_torch(cfg, np_params, "cpu")
    tp = tp_pool.TPContext(get_model(cfg), whole, group)
    out = {"serve": {}, "bytes": {}, "params": _leaves(tp.params),
           "param_bytes": tp_pool.max_per_device_bytes(tp.params, group),
           "steps": {step: _tp_steps(tp, step) for step in STEPS}}
    for ring, arm in CASES:
        geometry, _ = RINGS[ring]
        sched = Scheduler(tp.model, tp.params, tp=tp, **geometry)
        done = sched.run(_trace(serve, ring, *ARMS[arm]))
        out["serve"][ring, arm] = ({r.rid: [int(t) for t in r.tokens] for r in done},
                                   {c: getattr(sched, c) for c in COUNTERS})
        out["bytes"][ring] = (tp_pool.max_per_device_bytes(sched.pool.cache, group),
                              tp.whole_bytes(sched.pool.cache),
                              {p: v.shape for p, v in _leaves(sched.pool.cache).items()})
    out["sp"] = _sp_run(group, SP["lengths"], None)
    out["sp ring"] = _sp_run(group, [5, 40, 31, 63], SP["s"])
    return out


@pytest.fixture(scope="module")
def ref():
    """The reference's (model, params) and the params as numpy."""
    import jax

    from repro.configs import SMOKE_CONFIGS
    from repro.models import get_model as jget_model

    jcfg = SMOKE_CONFIGS[ARCH].replace(dtype="float32")
    jmodel = jget_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, jparams, jax.tree.map(np.asarray, jparams)


@pytest.fixture(scope="module")
def ranks_started(ref, tmp_path_factory):
    """Two spawned gloo ranks on the CPU running every TP = 2 check, in a
    thread of their own: the JAX fixtures run meanwhile."""
    store = tmp_path_factory.mktemp("tp_hybrid_store") / "store"
    box = {}

    def run():
        try:
            box["ranks"] = tp_pool.spawn(_rank_checks, TP, ref[2], devices=["cpu"] * TP,
                                         init_file=str(store))
        except BaseException as e:  # re-raised by ``ranks``
            box["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread, box


@pytest.fixture(scope="module")
def jax_runs(ref, ranks_started):
    """Each ring and arm through the JAX package's single-device scheduler:
    tokens, counters and the pool's reserved bytes."""
    from repro.core import scheduler as jsched
    from repro.launch import serve as jserve

    jmodel, jparams, _ = ref
    runs = {}
    for ring, arm in CASES:
        js = jsched.Scheduler(jmodel, jparams, **RINGS[ring][0])
        done = js.run(_trace(jserve, ring, *ARMS[arm]))
        runs[ring, arm] = ({r.rid: [int(t) for t in r.tokens] for r in done},
                           {c: getattr(js, c) for c in COUNTERS}, js.pool.reserved_bytes)
    return runs


@pytest.fixture(scope="module")
def jax_steps(ref, jax_runs):
    """The reference's single-device prefill and decode step on each
    ``_step_inputs``: logits and the cache after each."""
    from repro.core import engine as jengine

    jmodel, jparams, _ = ref
    out = {}
    for step in STEPS:
        x = _step_inputs(step)
        res = {}
        logits, cache = jengine.prefill(jmodel, jparams, x["tokens"], x["lengths"],
                                        x["max_len"])
        res["prefill"], res["prefill_cache"] = np.asarray(logits), _leaves(cache["layers"])
        logits, cache = jengine.decode_step(jmodel, jparams, cache, x["token"])
        res["decode"], res["decode_cache"] = np.asarray(logits), _leaves(cache["layers"])
        out[step] = res
    return out


@pytest.fixture(scope="module")
def ranks(ranks_started, jax_runs, jax_steps):
    thread, box = ranks_started
    thread.join()
    if "error" in box:
        raise box["error"]
    return box["ranks"]


def _split(step_or_ring: str) -> bool:
    return "whole" not in step_or_ring


# ------------------------------------------------------------ TP = 2 serving
@pytest.mark.parametrize("ring,arm", CASES)
def test_tp2_tokens_and_counters_equal_the_jax_scheduler(ranks, jax_runs, ring, arm):
    """Both ranks commit the reference single-device scheduler's tokens,
    preemptions, steps and prefills, on a split, a whole and a wrapped
    ring."""
    want_tokens, want_counters, _ = jax_runs[ring, arm]
    for rank in ranks:
        tokens, counters = rank["serve"][ring, arm]
        assert tokens == want_tokens
        assert counters == want_counters


@pytest.mark.parametrize("ring", list(RINGS))
def test_tp2_pool_a_rank(ranks, jax_runs, ring):
    """A rank's pool: its RG-LRU channels of the state and the conv tail,
    and its rows of a split ring (every row of a whole one); counted once,
    the ranks' pool is the reference's. On a split ring a rank holds at
    most 0.6x of it."""
    cfg = _cfg()
    per_rank, whole, shapes = ranks[0]["bytes"][ring]
    assert whole == jax_runs[ring, "greedy"][2]
    assert ranks[1]["bytes"][ring][:2] == (per_rank, whole)
    w = cfg.hybrid.lru_width // TP
    assert shapes["layers/0/state"] == (4, w)
    assert shapes["layers/0/conv"] == (4, cfg.hybrid.conv_width - 1, w)
    s = 31 if ring.startswith("whole") else 32
    if _split(ring):
        assert shapes["layers/2/seq_shard/k"] == (4, s // TP, 1, cfg.head_dim)
        assert per_rank / whole <= 0.6
    else:
        assert shapes["layers/2/k"] == (4, s, 1, cfg.head_dim)


def test_tp2_ring_layout_is_the_reference_cache_specs():
    """The port's ``cache_specs_tp`` on the whole model's caches: the ring's
    one KV head does not split, so S does where it divides the ranks (32,
    24) and the ring is whole where it does not (31, 25), the layout the
    ranks' pools hold."""
    cfg = _cfg()
    mesh = sharding.MeshShape({"model": TP})
    with torch.device("meta"):
        model = get_model(cfg)
        for max_len, split in ((33, True), (24, True), (31, False), (25, False)):
            cache = model.init_cache(4, max_len, "meta")
            spec = sharding.flat_specs(sharding.cache_specs_tp(cfg, cache, mesh, 4))
            assert spec["layers/2/k"] == ((None, "model", None, None) if split else
                                          (None, None, None, None))
            assert spec["layers/0/state"] == (None, None)


@pytest.mark.parametrize("max_len,split", [(24, True), (25, False)])
def test_a_rank_without_a_window_splits_its_cache_of_max_len(max_len, split):
    """With the window removed (the long arm's plain record without it) a
    rank's attention cache holds ``max_len`` rows, split along them where
    they divide the ranks, as a ring of ``min(max_len, window)`` rows is."""
    cfg = _cfg()
    nowin = tp_pool.local_config(cfg, TP).replace(
        hybrid=dataclasses.replace(tp_pool.local_config(cfg, TP).hybrid, window=None))
    from repro_torch.models import hybrid as H

    cache = H.init_cache(nowin, 2, max_len, "cpu", tp=tp_pool.TPGroup(1, TP, "cpu"))
    shapes = {p: tuple(v.shape) for p, v in _leaves(cache).items()}
    if split:
        assert shapes["layers/2/seq_shard/k"] == (2, max_len // TP, 1, cfg.head_dim)
    else:
        assert shapes["layers/2/k"] == (2, max_len, 1, cfg.head_dim)
    whole = H.init_cache(nowin, 2, max_len, "cpu")  # one device: every row
    assert tuple(whole["layers"][2]["k"].shape) == (2, max_len, 1, cfg.head_dim)


def reduces_a_forward(cfg, mode, split):
    """The reduces of one TP forward of the hybrid ``cfg``: 3 a recurrent
    layer (the post-conv gather, ``proj_out``, the FFN), 2 an attention
    layer (``wo``, the FFN) and, in a decode step over a split ring, 2 more
    (the q heads' gather, the partials' exchange); 2 for the vocabulary."""
    n_attn = sum(cfg.hybrid.block_kind(i) == "attention" for i in range(cfg.n_layers))
    n_attn_reduces = 4 if (split and mode == "decode") else 2
    return 3 * (cfg.n_layers - n_attn) + n_attn_reduces * n_attn + 2


@pytest.mark.parametrize("step", list(STEPS))
@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_tp2_reduces_a_forward(ranks, step, mode):
    """A prefill's and a decode step's reduces on each rank (the smoke
    config: 10 a prefill, 10 a decode step over a whole ring, 12 over a
    split one)."""
    for rank in ranks:
        got = rank["steps"][step][f"{mode}_reduces"]
        assert got == reduces_a_forward(_cfg(), mode, _split(step))


def test_tp2_reduces_at_the_published_widths():
    """``reduces_a_forward`` at recurrentgemma-2b's 26 layers: 72 a prefill
    and a whole-ring decode step, 88 a split-ring decode step; the config
    splits at TP = 2 and refuses TP = 3 (10 heads) by name."""
    cfg = get_config(ARCH)
    assert reduces_a_forward(cfg, "prefill", True) == 72
    assert reduces_a_forward(cfg, "decode", False) == 72
    assert reduces_a_forward(cfg, "decode", True) == 88
    tp_pool.check_supported(cfg, TP)
    with pytest.raises(NotImplementedError, match="n_heads = 10 does not split.*ROADMAP"):
        tp_pool.check_supported(cfg, 3)


def test_tp_refuses_an_lru_width_that_does_not_split():
    cfg = _cfg()
    odd = cfg.replace(hybrid=dataclasses.replace(cfg.hybrid, lru_width=130))
    with pytest.raises(NotImplementedError,
                       match="hybrid.lru_width = 130 does not split.*ROADMAP Queue 1, step 6"):
        tp_pool.check_supported(odd, 4)
    with pytest.raises(NotImplementedError, match="lru_width = 129 does not split"):
        tp_pool.check_supported(odd.replace(hybrid=dataclasses.replace(cfg.hybrid,
                                                                       lru_width=129)), 2)


@pytest.mark.parametrize("step", list(STEPS))
@pytest.mark.parametrize("which", ["prefill", "decode"])
def test_tp2_steps_match_the_reference(ranks, jax_steps, step, which):
    """``tp_prefill`` / ``tp_decode_step`` logits (gathered over the vocab)
    on both ranks against the reference's single-device steps at the
    whole-model tolerance."""
    for rank in ranks:
        got, want = rank["steps"][step][which], jax_steps[step][which]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **STEP_TOL)


@pytest.mark.parametrize("step", list(STEPS))
@pytest.mark.parametrize("which", ["prefill_cache", "decode_cache"])
def test_tp2_ranks_hold_their_rows_and_channels(ranks, jax_steps, step, which):
    """After the prefill and after the decode step: rank r's RG-LRU state and
    conv tail are the reference's channels [r * w / 2, (r + 1) * w / 2), its
    ring rows [r * S / 2, (r + 1) * S / 2) of a split ring (the decode
    step's new row on its owner alone) or every row of a whole one."""
    want = jax_steps[step][which]
    w = _cfg().hybrid.lru_width // TP
    for r, rank in enumerate(ranks):
        got = rank["steps"][step][which]
        for path, g in got.items():
            if path.endswith(("state", "conv")):
                np.testing.assert_allclose(g, want[path][..., r * w:(r + 1) * w], **STEP_TOL)
                continue
            whole = want[path.replace("seq_shard/", "")]
            if "seq_shard" in path:
                n = whole.shape[1] // TP
                whole = whole[:, r * n:(r + 1) * n]
            np.testing.assert_allclose(g, whole, **STEP_TOL)
        assert any("seq_shard" in p for p in got) == _split(step)


@pytest.mark.parametrize("leaf", ["rec/proj_x/w", "rec/proj_gate/w", "rec/conv_w", "rec/conv_b",
                                  "rec/gate_a/w", "rec/gate_a/b", "rec/gate_x/b", "rec/lam",
                                  "rec/proj_out/w", "attn/wq/w", "attn/wk/w", "attn/wv/w",
                                  "attn/wo/w"])
def test_tp2_shard_is_the_channel_and_head_layout(ranks, ref, leaf):
    """Each rank's leaves are the reference's at its channels or heads: the
    recurrent block's ``proj_x`` / ``proj_gate`` / gate columns, conv, decay
    and gate biases at channels [r * w / 2, (r + 1) * w / 2), ``proj_out``'s
    rows; the attention's ``wq`` columns and ``wo`` rows of its heads, ``wk``
    and ``wv`` whole."""
    cfg = _cfg()
    for r, rank in enumerate(ranks):
        for i in range(cfg.n_layers):
            kind = "rec" if cfg.hybrid.block_kind(i) == "recurrent" else "attn"
            if not leaf.startswith(kind):
                continue
            node = ref[2]["layers"][i]
            for k in leaf.split("/"):
                node = node[k]
            want = np.asarray(node)
            got = rank["params"][f"layers/{i}/{leaf}"]
            if leaf in ("attn/wk/w", "attn/wv/w"):
                pass
            elif leaf.endswith(("proj_out/w", "wo/w")) or want.ndim == 1 or leaf == "rec/conv_w":
                n = want.shape[0] // TP
                want = want[r * n:(r + 1) * n]
            else:
                n = want.shape[1] // TP
                want = want[:, r * n:(r + 1) * n]
            np.testing.assert_array_equal(got, want)


def test_tp2_vocab_and_param_bytes(ranks, ref):
    """The tied embedding (and its f32 unembed copy, f32 here: none) splits
    its 512 rows; a rank holds about half the params (the norms and ``wk`` /
    ``wv`` whole)."""
    cfg = _cfg()
    whole = sum(np.asarray(a).nbytes for a in _leaves(ref[2]).values())
    for rank in ranks:
        assert rank["params"]["embed/table"].shape == (cfg.vocab_size // TP, cfg.d_model)
        assert 0.5 < rank["param_bytes"] / whole < 0.55


# ------------------------------------------------------ sequence-parallel decode
def test_sp_decode_equals_the_reference(ranks):
    """``sp_decode`` on the two ranks at ``test_sequence_parallel_decode_
    equals_reference``'s shapes: the output within 1e-5 of
    ``decode_attention_ref`` over the written cache, the ranks' rows
    together bit for bit the reference's ``write_decode``, one reduce."""
    import jax.numpy as jnp

    from repro.kernels import ref as kref
    from repro.models.attention import write_decode

    ck, cv, kn, vn, q = _sp_inputs()
    ln = jnp.asarray(SP["lengths"])
    wk, wv = (np.asarray(write_decode(jnp.asarray(c), jnp.asarray(n), ln))
              for c, n in ((ck, kn), (cv, vn)))
    want = np.asarray(kref.decode_attention_ref(jnp.asarray(q), jnp.asarray(wk), jnp.asarray(wv),
                                                ln + 1))
    for out, _, _, n_red in (r["sp"] for r in ranks):
        assert np.abs(out - want).max() < 1e-5
        assert n_red == 1
    got_k = np.concatenate([r["sp"][1] for r in ranks], axis=1)
    got_v = np.concatenate([r["sp"][2] for r in ranks], axis=1)
    np.testing.assert_array_equal(got_k, wk)
    np.testing.assert_array_equal(got_v, wv)


def test_sp_decode_over_a_wrapped_ring(ranks):
    """With ``ring=S`` the new row lands at ``lengths % S`` on its owner and
    the valid rows are ``min(lengths + 1, S)``: the ranks' output is the
    whole-ring decode's (the port's plain decode over the written ring)."""
    ck, cv, kn, vn, q = (torch.from_numpy(a) for a in _sp_inputs())
    ln = torch.tensor([5, 40, 31, 63], dtype=torch.int32)
    s = SP["s"]
    wk = A.write_decode(ck.clone(), kn, ln % s)
    wv = A.write_decode(cv.clone(), vn, ln % s)
    want = da.decode_attention_plain(q, wk, wv, A.valid_counts(ln + 1, s))
    for out, _, _, _ in (r["sp ring"] for r in ranks):
        np.testing.assert_allclose(out, want.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(np.concatenate([r["sp ring"][1] for r in ranks], 1), wk)
    np.testing.assert_array_equal(np.concatenate([r["sp ring"][2] for r in ranks], 1), wv)


def test_sp_decode_on_one_rank_is_the_decode():
    """A group of one holds the whole cache: ``sp_decode`` is the write and
    the plain decode, with no reduce."""
    ck, cv, kn, vn, q = (torch.from_numpy(a) for a in _sp_inputs(1))
    ln = torch.tensor(SP["lengths"], dtype=torch.int32)
    group = tp_pool.TPGroup(0, 1, "cpu")
    out, cache = A.sp_decode({"k": ck.clone(), "v": cv.clone()}, kn, vn, q, ln, group)
    wk, wv = A.write_decode(ck.clone(), kn, ln), A.write_decode(cv.clone(), vn, ln)
    assert torch.equal(cache["k"], wk) and torch.equal(cache["v"], wv)
    torch.testing.assert_close(out, da.decode_attention_plain(q, wk, wv, ln + 1), **F32)
    assert group.n_reduces == 0


# --------------------------------------------------- the partial form and merge
@pytest.mark.parametrize("counts", [[0, 9, 17, 3], [17, 17, 1, 0]])
def test_partial_plain_matches_the_reference(counts):
    """``ops.decode_attention_partial`` with counts of a valid prefix (the
    partial form's plain version, into a flat triple) against the
    reference's ``decode_attention_partial`` over the same prefix mask
    (f32; a row with no valid key gives acc 0, l 0, m the sentinel)."""
    import jax.numpy as jnp

    from repro.kernels import ops as jops

    rng = np.random.default_rng(sum(counts))
    q = rng.standard_normal((4, 10, 32)).astype(np.float32)
    k, v = (rng.standard_normal((4, 17, 1, 32)).astype(np.float32) for _ in range(2))
    n = np.asarray(counts, np.int32)
    buf = torch.zeros(da.partial_numel(4, 10, 32))
    got = ops.decode_attention_partial(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), torch.from_numpy(n), out=buf)
    want = jops.decode_attention_partial(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(np.arange(17)[None] < n[:, None]))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)
    assert got[0].data_ptr() == buf.data_ptr()
    empty = n == 0
    assert (got[2].numpy()[empty] == 0).all() and (got[0].numpy()[empty] == 0).all()


def test_merge_plain_matches_the_reference_on_strided_views():
    """``ops.combine_partial_attention`` over views of a flat exchange buffer
    (as ``sp_decode`` holds it, one part with no valid key on a row)
    against the reference's ``combine_partial_attention``."""
    import jax.numpy as jnp

    from repro.kernels import ops as jops

    rng = np.random.default_rng(3)
    b, h, d, parts = 3, 10, 32, 2
    ex = torch.from_numpy(rng.standard_normal((parts, b * h * (d + 2))).astype(np.float32))
    n = b * h * d
    ml = ex[:, n:].view(parts, b, h, 2)
    ml[..., 1].abs_()
    ml[1, 0, :, 0], ml[1, 0, :, 1] = da.NEG_INF, 0.0
    ex[1, :h * d].zero_()
    accs, ms, ls = ex[:, :n].view(parts, b, h, d), ml[..., 0], ml[..., 1]
    got = ops.combine_partial_attention(accs, ms, ls)
    want = jops.combine_partial_attention(*(jnp.asarray(t.numpy()) for t in (accs, ms, ls)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert np.isfinite(got.numpy()).all()


def test_partial_refuses_a_mask_on_cuda_and_out_with_a_mask():
    q, k = torch.zeros(1, 2, 16), torch.zeros(1, 4, 1, 16)
    mask = torch.ones(1, 4, dtype=torch.bool)
    with pytest.raises(ValueError, match="out= takes counts"):
        ops.decode_attention_partial(q, k, k, mask, out=torch.zeros(36))
    with pytest.raises(ValueError, match="counts of a valid prefix"):
        ops.decode_attention_partial(q, k, k, mask, impl="cuda")


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s_loc", [16, 1024])
def test_partial_kernel_matches_its_plain_version(dtype, s_loc):
    """The partial form on the card against its plain version: all of
    recurrentgemma's 10 heads over one KV head of 256 on a rank's ring rows
    (one split at 16 rows, several at 1024), counts 0, 1, a split's edge
    and all rows, f32 out at the f32 tolerance; counted once a call."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b = 4
    q = torch.randn((b, 10, 256), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((b, s_loc, 1, 256), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    n = torch.tensor([0, 1, min(64, s_loc), s_loc], dtype=torch.int32, device=dev)
    before = da.LAUNCHES_PARTIAL
    got = da.decode_attention_partial_cuda(q, k, v, n)
    want = da.decode_attention_partial_plain(q, k, v, n)
    assert da.LAUNCHES_PARTIAL - before == 1
    torch.testing.assert_close(got, want, **F32)
    torch.testing.assert_close(got, da.decode_attention_partial_cuda(q, k, v, n), atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_merge_kernel_matches_its_plain_version():
    """The merge on the card over strided views of an exchange buffer of
    two parts (one with no valid key on a row) against its plain version at
    the f32 tolerance; counted once a call."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    b, h, d = 8, 10, 256
    n = b * h * d
    ex = torch.randn((2, da.partial_numel(b, h, d)), generator=gen, device=dev)
    ml = ex[:, n:].view(2, b, h, 2)
    ml[..., 1].abs_()
    ml[1, 0, :, 0], ml[1, 0, :, 1] = da.NEG_INF, 0.0
    accs, ms, ls = ex[:, :n].view(2, b, h, d), ml[..., 0], ml[..., 1]
    before = da.LAUNCHES_MERGE
    got = da.combine_partial_attention_cuda(accs, ms, ls)
    assert da.LAUNCHES_MERGE - before == 1
    torch.testing.assert_close(got, da.combine_partial_attention(accs, ms, ls), **F32)


# ------------------------------------------------------------ the launcher
def test_launcher_serves_the_hybrid_at_tp2(capfd):
    """``serve --tp 2 --device cpu``: two ranks serve recurrentgemma's smoke
    config (a ring of min(pad + 3 + 1, 32) rows); rank 0 prints the backend,
    a rank's pool bytes and the reduces, its prefills' and decode steps'
    counts on the ring's route."""
    m = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--tp", "2",
                    "--n-requests", "3", "--batch-slots", "4", "--max-new", "3",
                    "--profile", "seamless_s2t"])
    assert m["tp"] == 2 and m["backend"] == "gloo" and m["n_requests"] == 3
    cfg = get_smoke_config(ARCH)
    pad = serve.trace_pad_to(serve.data_mod.PAPER_PROFILES["seamless_s2t"], 3, 0)
    split = min(pad + 3 + 1, cfg.hybrid.window) % TP == 0
    assert m["reduces"] == (m["prefills"] * reduces_a_forward(cfg, "prefill", split)
                            + m["decode_steps"] * reduces_a_forward(cfg, "decode", split))
    assert "tp=2 on" in capfd.readouterr().out
