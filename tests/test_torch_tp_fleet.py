"""Port's DP x TP replica fleet (``ReplicaRouter(tp=...)``, ``serve --tp
--replicas``) against the JAX package's ``ReplicaRouter(tp=2)``.

- The reference runs in a subprocess with 4 forced host devices (its fleet
  carves them into two disjoint groups of 2), as ``tests/test_tp.py`` runs
  its TP script: params from the f32 llama3.2-1b smoke init, the trace of
  ``tests/test_tp.py`` (8 ``seamless_s2t`` requests, pad 16, ``max_new``
  16), 4 slots a replica, paged (block 16, 10 blocks) and chunked (budget
  4) at t = 0 and t = 0.8 / top-p 0.9, on the contiguous pool, and on a
  pool of 6 blocks, where replicas preempt and requeue.
- The port runs the same arms on ONE pair of gloo ranks spawned for the
  module (a ``FileStore`` under ``tmp_path``: no TCP port), each rank
  hosting its rank of both replicas, params bridged from the same init:
  tokens exactly the reference's; placements, spills, requeues and each
  replica's decode steps, prefills, chunks and preemptions exactly; a
  rank's KV bytes the reference's per-device bytes and at most 0.6x the
  single pool's; both ranks' host state the same after every round, also
  on a trace whose arrivals and aging follow the clock; each replica's
  collectives its own.
- ``serve --tp 2 --replicas 2`` on the CPU prints the fleet's lines; without
  a card and ``--device cpu`` it raises; ``hstu`` stays refused.

The JAX package is imported inside the tests only: the spawned ranks import
this module and stay free of it."""
import hashlib
import json
import os
import platform
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core import prng
from repro_torch.core.router import ReplicaRouter
from repro_torch.distributed import tp_pool
from repro_torch.launch import serve
from repro_torch.models import get_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TP, REPLICAS = 2, 2
TRACE = dict(pad_to=16, max_new_cap=16, vocab_size=512, arrival_rate=0.0, seed=0)
PAGED = dict(slots=4, pad_to=16, max_new_cap=16, paged=True, block_size=16, num_blocks=10,
             chunked=True, prefill_budget=4)
CONTIGUOUS = dict(slots=4, pad_to=16, max_new_cap=16)
#: 5 usable blocks a replica for 4 slots of requests of up to 3: replicas
#: preempt, and the replays go back to the shared queue
TIGHT = dict(PAGED, num_blocks=6)
#: arm -> (temperature, top-p, each replica's geometry)
ARMS = {"paged t=0": (0.0, 1.0, PAGED),
        "paged t=0.8": (0.8, 0.9, PAGED),
        "contiguous": (0.0, 1.0, CONTIGUOUS),
        "tight t=0.8": (0.8, 0.9, TIGHT)}
REPLICA_COUNTERS = ("n_decode_steps", "n_prefills", "n_chunks", "n_preemptions")

_REF_SCRIPT = """
import json, sys
import jax
import numpy as np
assert jax.device_count() == 4, jax.device_count()
from repro.configs import SMOKE_CONFIGS
from repro.core.router import ReplicaRouter
from repro.core.scheduler import Scheduler
from repro.distributed import tp_pool
from repro.launch import serve
from repro.models import get_model

arms = json.loads(sys.argv[1])
cfg = SMOKE_CONFIGS["llama3.2-1b"].replace(dtype="float32")
model = get_model(cfg)
params = model.init(jax.random.PRNGKey(0))
prof = serve.data_mod.PAPER_PROFILES["seamless_s2t"]
out = {"param_sum": float(sum(np.abs(np.asarray(x, np.float64)).sum()
                              for x in jax.tree.leaves(params)))}
for arm, (temperature, top_p, geometry, trace) in arms.items():
    reqs = serve.poisson_trace(prof, 8, temperature=temperature, top_p=top_p, **trace)
    router = ReplicaRouter(model, params, replicas=2, tp=2, base_key=jax.random.PRNGKey(0),
                           **geometry)
    done = router.run(reqs)
    out[arm] = dict(
        tokens={str(r.rid): [int(t) for t in r.tokens] for r in done},
        placements={str(k): v for k, v in router.placements.items()},
        spills=router.n_spills, requeues=router.n_requeues,
        replicas=[{c: getattr(s, c) for c in %r} for s in router.replicas],
        per_device=max(tp_pool.max_per_device_bytes(s.pool.cache) for s in router.replicas),
        reserved=router.reserved_bytes,
        single=Scheduler(model, params, **geometry).pool.reserved_bytes)
print("FLEET_REF " + json.dumps(out))
""" % (REPLICA_COUNTERS,)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return get_smoke_config("llama3.2-1b").replace(dtype="float32")


def _trace(temperature, top_p):
    prof = serve.data_mod.PAPER_PROFILES["seamless_s2t"]
    return serve.poisson_trace(prof, 8, temperature=temperature, top_p=top_p, **TRACE)


def _host_state(router) -> str:
    """A digest of the fleet's host state: the shared queue, the placements
    and each replica's residents, slot mirrors, free lists, block tables,
    refcounts, queue and counters."""
    parts = [[r.rid for r in router.waiting], sorted(router.placements.items()),
             router.n_spills, router.n_requeues]
    for s in router.replicas:
        pool = s.pool
        parts.append([sorted((b, st.req.rid) for b, st in s.active.items()),
                      s._token.tolist(), s._rid.tolist(), s._ngen.tolist(),
                      [r.rid for r in s.waiting], list(pool._free),
                      [getattr(s, c) for c in REPLICA_COUNTERS]])
        if s.paged:
            parts.append([pool.block_tables.tolist(), pool._ref.tolist(),
                          list(pool._free_blocks)])
    return hashlib.sha256(repr(parts).encode()).hexdigest()


def _traced_run(router, reqs):
    """``router.run(reqs)`` with the host state digested after every
    round: (the finished requests, the digests)."""
    states, real_round = [], router._round

    def traced(live):
        real_round(live)
        states.append(_host_state(router))

    router._round = traced
    return router.run(reqs), states


def _fleet_rank(group, np_params):
    """One rank's share of every fleet check: each arm through a
    ``ReplicaRouter(tp=2)`` of 2 replicas, the host state digested after
    every round; a trace whose arrivals and aging follow the clock; then
    the refusal of ``hstu``."""
    cfg = _cfg()
    model = get_model(cfg)
    params = bridge.params_to_torch(cfg, np_params, "cpu")
    fleet = dict(replicas=REPLICAS, tp=TP, group=group, devices=[("cpu",) * TP] * REPLICAS,
                 base_key=prng.PRNGKey(0))
    out = {"arms": {}}
    for arm, (temp, top_p, geometry) in ARMS.items():
        world0 = group.n_reduces
        router = ReplicaRouter(model, params, **fleet, **geometry)
        done, states = _traced_run(router, _trace(temp, top_p))
        groups = [s.tp.group for s in router.replicas]
        out["arms"][arm] = dict(
            tokens={r.rid: [int(t) for t in r.tokens] for r in done},
            placements=dict(router.placements), spills=router.n_spills,
            requeues=router.n_requeues,
            replicas=[{c: getattr(s, c) for c in REPLICA_COUNTERS} for s in router.replicas],
            per_device=max(tp_pool.max_per_device_bytes(s.pool.cache, s.tp.group)
                           for s in router.replicas),
            reserved=router.reserved_bytes, states=states,
            groups=[(g.slots is not None, g.pg is not None, g.n_reduces, g.device.type)
                    for g in groups],
            shared_shard=router.replicas[0].tp.params is router.replicas[1].tp.params,
            world_reduces=group.n_reduces - world0)
    # requests arrive over ~40 ms and age every 5 ms: placement follows the
    # clock, which every process must read as rank 0 does (rank 1's own
    # stands still, so a rank that read it would place otherwise)
    clock = time.perf_counter if group.rank == 0 else (lambda: 0.0)
    router = ReplicaRouter(model, params, priority_boost_after=0.005, clock=clock, **fleet,
                           **PAGED)
    prof = serve.data_mod.PAPER_PROFILES["seamless_s2t"]
    reqs = serve.poisson_trace(prof, 8, temperature=0.8, top_p=0.9,
                               **dict(TRACE, arrival_rate=200.0))
    done, states = _traced_run(router, reqs)
    out["timed"] = dict(tokens={r.rid: [int(t) for t in r.tokens] for r in done},
                        placements=dict(router.placements), states=states,
                        boosts=router.n_priority_boosts)
    hstu = get_smoke_config("hstu").replace(dtype="float32")
    try:
        ReplicaRouter(get_model(hstu), None, replicas=REPLICAS, tp=TP, group=group,
                      devices=[("cpu",) * TP] * REPLICAS, slots=2, pad_to=8, max_new_cap=4)
        out["hstu"] = None
    except NotImplementedError as e:
        out["hstu"] = str(e)
    return out


@pytest.fixture(scope="module")
def np_params():
    import jax

    from repro.configs import SMOKE_CONFIGS
    from repro.models import get_model as jget_model

    jparams = jget_model(SMOKE_CONFIGS["llama3.2-1b"].replace(dtype="float32")).init(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, jparams)


@pytest.fixture(scope="module")
def reference():
    """The reference's fleet on every arm, in a subprocess with 4 forced
    host devices."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    arms = {arm: (temp, top_p, geometry, TRACE) for arm, (temp, top_p, geometry) in ARMS.items()}
    r = subprocess.run([sys.executable, "-c", _REF_SCRIPT, json.dumps(arms)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    line = next(x for x in r.stdout.splitlines() if x.startswith("FLEET_REF "))
    return json.loads(line[len("FLEET_REF "):])


@pytest.fixture(scope="module")
def ranks(np_params, tmp_path_factory):
    """Every arm, run once by two spawned gloo ranks on the CPU."""
    store = tmp_path_factory.mktemp("fleet_store") / "store"
    return tp_pool.spawn(_fleet_rank, TP, np_params, devices=["cpu"] * TP,
                         init_file=str(store))


def test_reference_and_port_start_from_one_init(reference, np_params):
    got = sum(float(np.abs(np.asarray(x, np.float64)).sum())
              for x in _leaves(np_params))
    assert got == pytest.approx(reference["param_sum"], rel=1e-12)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("arm", list(ARMS))
def test_fleet_tokens_equal_the_reference_fleet(ranks, reference, arm):
    """Both ranks commit the reference fleet's tokens, every request."""
    want = {int(rid): toks for rid, toks in reference[arm]["tokens"].items()}
    assert len(want) == 8
    for rank in ranks:
        assert rank["arms"][arm]["tokens"] == want


@pytest.mark.parametrize("arm", list(ARMS))
def test_fleet_routes_as_the_reference_fleet(ranks, reference, arm):
    """Placements, spills, requeues and each replica's decode steps,
    prefills, chunks and preemptions exactly the reference's, on both
    ranks."""
    ref = reference[arm]
    want_placements = {int(rid): path for rid, path in ref["placements"].items()}
    for rank in ranks:
        got = rank["arms"][arm]
        assert got["placements"] == want_placements
        assert (got["spills"], got["requeues"]) == (ref["spills"], ref["requeues"])
        assert got["replicas"] == ref["replicas"]
    assert {p[-1] for p in want_placements.values()} == {0, 1}  # both replicas serve
    if arm == "paged t=0":
        assert sum(r["n_chunks"] for r in ref["replicas"]) >= 1
    if arm.startswith("tight"):
        assert ref["requeues"] >= 1 and all(r["n_preemptions"] for r in ref["replicas"])


@pytest.mark.parametrize("arm", ["paged t=0", "contiguous"])
def test_fleet_rank_reserves_at_most_0_6_of_the_pool(ranks, reference, arm):
    """A rank holds its KV heads of each replica: the reference's
    per-device bytes, at most 0.6x one single pool's; the fleet's pools
    counted whole are the reference's logical bytes."""
    ref = reference[arm]
    for rank in ranks:
        got = rank["arms"][arm]
        assert got["per_device"] == ref["per_device"]
        assert got["per_device"] / ref["single"] <= 0.6
        assert got["reserved"] == ref["reserved"] == REPLICAS * ref["single"]


@pytest.mark.parametrize("arm", list(ARMS))
def test_fleet_ranks_hold_the_same_host_state(ranks, arm):
    """After every round both ranks' queues, placements, residents, slot
    mirrors, free lists, block tables and counters are the same."""
    a, b = (rank["arms"][arm]["states"] for rank in ranks)
    assert len(a) > 10 and a == b


def test_fleet_ranks_agree_on_the_clock(ranks):
    """Arrivals over time and aging: both processes place every request
    alike, after every round, on rank 0's clock, and serve all of them."""
    a, b = (rank["timed"] for rank in ranks)
    assert a == b
    assert len(a["tokens"]) == 8 and all(len(t) == 16 for t in a["tokens"].values())


def test_fleet_replicas_have_collectives_of_their_own(ranks):
    """Each replica reduces on a process group and slots of its own: its
    reduces are counted apart, the rank's first group carries none of them,
    and the replicas on one device group share the rank's shard."""
    for rank in ranks:
        for arm, got in rank["arms"].items():
            for slots, own_pg, n_reduces, dev in got["groups"]:
                assert slots == (platform.machine() == "x86_64") and own_pg
                assert n_reduces > 0 and dev == "cpu"
            assert got["world_reduces"] == 0
            assert got["shared_shard"]


def test_fleet_still_refuses_hstu(ranks):
    for rank in ranks:
        assert rank["hstu"] is not None and "ROADMAP Queue 1, step 6" in rank["hstu"]


def test_serve_main_runs_the_fleet_on_the_cpu(capfd):
    """``serve --tp 2 --replicas 2 --device cpu``: rank 0 prints the
    reference's ``tp=`` line, the fleet's spills and requeues and a line a
    replica with its reduces."""
    m = serve.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--tp", "2",
                    "--replicas", "2"])
    out = capfd.readouterr().out
    assert re.search(r"\[serve/continuous\+x2\+tp2\] tp=2 \| kv reserved/device=.*MB \(pool "
                     r".*MB logical\)", out)
    assert re.search(r"\[serve/continuous\+x2\+tp2\] spills=\d+ \| requeues=\d+ \|", out)
    assert len(re.findall(r"\[serve/continuous\+x2\+tp2\]   replica \d: .* \| on cpu,cpu \| "
                          r"reduces=[1-9]\d*", out)) == 2
    assert m["tp"] == 2 and m["replicas"] == 2 and m["n_requests"] == 8
    assert m["backend"] == "gloo"
    assert m["kv_reserved_per_device_bytes"] <= 0.6 * m["kv_reserved_bytes"] / REPLICAS


def test_serve_fleet_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the refusal is for hosts without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "llama3.2-1b", "--smoke", "--tp", "2", "--replicas", "2"])
