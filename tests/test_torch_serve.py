"""Port serving stack vs the JAX package on the f32 llama3.2-1b smoke
config (params bridged from the reference's ``init(PRNGKey(0))``): the
slot pool, greedy ``engine.generate``, the continuous and fixed
``Scheduler`` on the same requests, the trace generator and the serve
launcher. Plus the port's structural guards: it imports neither JAX nor
the JAX package, and ``chip_smoke.py`` refuses to run without a card.

Greedy tokens must match exactly. A divergence passes only where the
reference's top-1/top-2 logit gap at that step is below 1e-4 (a near tie
that f32 summation order may break either way); the test reports it."""
import dataclasses
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_CONFIGS
from repro.core import engine as jengine
from repro.core import sampling as jsampling
from repro.core.scheduler import Scheduler as JScheduler
from repro.core.scheduler import ServeRequest as JRequest
from repro.launch import serve as jserve
from repro.models import get_model as jget_model
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core import engine, profiles
from repro_torch.core.kv_cache import leaves
from repro_torch.core.scheduler import Scheduler, ServeRequest
from repro_torch.core.slot_pool import SlotPool
from repro_torch.launch import serve
from repro_torch.models import get_model

ROOT = Path(__file__).resolve().parents[1]
PAD_TO = 8
NEAR_TIE = 1e-4


@pytest.fixture(scope="module")
def pair():
    jcfg = SMOKE_CONFIGS["llama3.2-1b"].replace(dtype="float32")
    jmodel = jget_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = get_smoke_config("llama3.2-1b").replace(dtype="float32")
    tparams = bridge.params_to_torch(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, get_model(tcfg), tparams


def _ref_gap(jmodel, jparams, prompt, prefix) -> float:
    """The reference's top-1/top-2 logit gap for the token after
    ``prompt + prefix``."""
    seq = np.concatenate([np.asarray(prompt, np.int32), np.asarray(prefix, np.int32)])
    logits, _ = jengine.prefill(jmodel, jparams, jnp.asarray(seq[None]),
                                jnp.asarray([len(seq)], jnp.int32), len(seq) + 1, None)
    top2 = np.sort(np.asarray(logits[0]))[-2:]
    return float(top2[1] - top2[0])


def assert_tokens_match(got, want, gap_at, what: str) -> None:
    """Exact match up to the first divergence; a divergence is accepted
    only at a reference near tie (gap < 1e-4), and reported."""
    got, want = [int(x) for x in got], [int(x) for x in want]
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            gap = gap_at(i)
            assert gap < NEAR_TIE, (
                f"{what}: token {i} is {g}, the reference's {w} (top-1/top-2 gap {gap})"
            )
            print(f"{what}: near-tie divergence at token {i} (gap {gap:.2e})")
            return
    assert len(got) == len(want), f"{what}: {len(got)} tokens vs {len(want)}"


def _prompts(n, rng, vocab):
    return [rng.integers(0, vocab, size=int(rng.integers(3, PAD_TO + 1))) for _ in range(n)]


# ------------------------------------------------------------- slot pool
def test_slot_pool_free_list_and_occupancy(pair):
    _, _, model, _ = pair
    pool = SlotPool(model, slots=3, max_len=16, device="cpu")
    assert pool.n_free == 3 and pool.occupancy == 0.0
    a, b = pool.acquire(), pool.acquire()
    assert (a, b) == (0, 1) and pool.n_active == 2
    pool.evict(a)
    assert pool.n_free == 2 and pool.acquire() == 0  # lowest-first recycle
    pool.reset()
    assert pool.n_free == 3
    assert int(pool.cache["lengths"].sum()) == 0


def test_slot_pool_assign_writes_one_row_only(pair):
    _, _, model, params = pair
    pool = SlotPool(model, slots=3, max_len=16, device="cpu")
    for leaf in leaves(pool.cache):  # non-zero neighbours
        leaf.copy_(torch.arange(leaf.numel()).reshape(leaf.shape).to(leaf.dtype))
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (1, 4)))
    _, row = engine.prefill(model, params, toks, torch.tensor([4], dtype=torch.int32), 16)
    before = [leaf.clone() for leaf in leaves(pool.cache)]
    pool.assign(1, row)
    after = list(leaves(pool.cache))
    assert int(after[0][1]) == 4  # lengths come from the row
    for b, a, r in zip(before, after, leaves(row)):
        assert torch.equal(a[1], r[0])  # row replaced
        assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])  # neighbours bit-identical


# ---------------------------------------------------------------- engine
@pytest.mark.parametrize("case", ["plain", "eos+live"])
def test_generate_greedy_matches_jax(pair, case):
    jmodel, jparams, model, params = pair
    rng = np.random.default_rng(5)
    prompts = _prompts(3, rng, 512)
    buf = np.zeros((3, PAD_TO), np.int32)
    for i, p in enumerate(prompts):
        buf[i, : len(p)] = p
    plen = np.array([len(p) for p in prompts], np.int32)
    kw_j, kw_t = {}, {}
    if case == "eos+live":
        probe = engine.generate(model, params, torch.from_numpy(buf),
                                prompt_lengths=torch.from_numpy(plen), max_new_tokens=6)
        eos = int(probe["tokens"][0, 2])
        live = np.array([True, True, False])
        kw_j = dict(eos_id=eos, live=jnp.asarray(live))
        kw_t = dict(eos_id=eos, live=torch.from_numpy(live))
    want = jengine.generate(jmodel, jparams, jnp.asarray(buf),
                            prompt_lengths=jnp.asarray(plen), max_new_tokens=10,
                            sampler=jsampling.greedy, **kw_j)
    got = engine.generate(model, params, torch.from_numpy(buf),
                          prompt_lengths=torch.from_numpy(plen), max_new_tokens=10, **kw_t)
    assert got["tokens"].shape == (3, 10) and got["tokens"].dtype == torch.int32
    assert got["n_steps"] == want["n_steps"]
    wt = np.asarray(want["tokens"])
    for i in range(3):
        assert_tokens_match(
            got["tokens"][i].numpy(), wt[i],
            lambda k, i=i: _ref_gap(jmodel, jparams, prompts[i], wt[i][:k]),
            f"generate row {i}",
        )


# -------------------------------------------------------------- scheduler
def _traffic(seed, n, max_news):
    rng = np.random.default_rng(seed)
    prompts = _prompts(n, rng, 512)
    return [(i, p, max_news[i % len(max_news)]) for i, p in enumerate(prompts)]


@pytest.mark.parametrize("policy,eos", [("continuous", False), ("fixed", False),
                                        ("continuous", True)])
def test_scheduler_matches_jax_scheduler(pair, policy, eos):
    """Same 6 requests through the JAX Scheduler and the port's (2 slots,
    pad 8, mixed max_new): tokens, finish order, prefills and decode
    steps agree; with ``eos_id`` slots are evicted and refilled mid-flight."""
    jmodel, jparams, model, params = pair
    traffic = _traffic(11, 6, [5, 12, 3, 9])
    eos_id = None
    if eos:  # an EOS id the model emits: request 0's third token
        buf = np.zeros((1, PAD_TO), np.int32)
        buf[0, : len(traffic[0][1])] = traffic[0][1]
        probe = engine.generate(model, params, torch.from_numpy(buf),
                                prompt_lengths=torch.tensor([len(traffic[0][1])]),
                                max_new_tokens=4)
        eos_id = int(probe["tokens"][0, 2])
    js = JScheduler(jmodel, jparams, slots=2, pad_to=PAD_TO, max_new_cap=12,
                    policy=policy, eos_id=eos_id)
    ts = Scheduler(model, params, slots=2, pad_to=PAD_TO, max_new_cap=12,
                   policy=policy, eos_id=eos_id, device="cpu")
    jdone = js.run([JRequest(rid=i, prompt=p, max_new=m) for i, p, m in traffic])
    tdone = ts.run([ServeRequest(rid=i, prompt=p, max_new=m) for i, p, m in traffic])
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    jtok = {r.rid: r.tokens for r in jdone}
    for r in tdone:
        prompt = traffic[r.rid][1]
        assert_tokens_match(
            r.tokens, jtok[r.rid],
            lambda k, p=prompt, w=jtok[r.rid]: _ref_gap(jmodel, jparams, p, w[:k]),
            f"{policy} request {r.rid}",
        )
        if eos_id is not None and eos_id in r.tokens:
            assert r.tokens[-1] == eos_id  # stopped AT the eos token
    assert (ts.n_prefills, ts.n_decode_steps) == (js.n_prefills, js.n_decode_steps)
    assert ts.occupancy_trace == js.occupancy_trace


def test_fixed_and_continuous_give_same_tokens(pair):
    _, _, model, params = pair
    traffic = _traffic(1, 5, [4, 10, 6])
    outs, steps = {}, {}
    for policy in ("continuous", "fixed"):
        sched = Scheduler(model, params, slots=2, pad_to=PAD_TO, max_new_cap=10,
                          policy=policy, device="cpu")
        done = sched.run([ServeRequest(rid=i, prompt=p, max_new=m) for i, p, m in traffic])
        outs[policy] = {d.rid: list(d.tokens) for d in done}
        steps[policy] = sched.n_decode_steps
    assert outs["fixed"] == outs["continuous"]
    assert steps["fixed"] >= steps["continuous"]


def test_priority_admission_order(pair):
    _, _, model, params = pair
    reqs = [ServeRequest(rid=i, prompt=np.arange(3) + i, max_new=2, priority=p)
            for i, p in enumerate([0, 0, 5, 1])]
    sched = Scheduler(model, params, slots=1, pad_to=PAD_TO, max_new_cap=4, device="cpu")
    done = sched.run([dataclasses.replace(r) for r in reqs])
    assert [r.rid for r in done] == [2, 3, 0, 1]


def test_unported_scheduler_features_raise(pair):
    """What the scheduler serves and what it still refuses: the prefix cache
    is taken under chunked prefill (the reference's ValueError without it),
    slot groups and sampled requests are served, and a profile that is no
    ``DecodingProfile`` is refused."""
    _, _, model, params = pair
    with pytest.raises(ValueError, match="chunked"):
        Scheduler(model, params, slots=2, pad_to=PAD_TO, max_new_cap=4, device="cpu",
                  paged=True, prefix_cache=True)
    pfx = Scheduler(model, params, slots=2, pad_to=PAD_TO, max_new_cap=4, device="cpu",
                    paged=True, chunked=True, block_size=4, prefix_cache=True)
    assert pfx._pcache is not None and pfx.prefix_hit_rate == 0.0
    sched = Scheduler(model, params, slots=2, pad_to=PAD_TO, max_new_cap=4, device="cpu")
    with pytest.raises(TypeError, match="DecodingProfile"):
        sched.submit([ServeRequest(rid=1, prompt=np.arange(3), max_new=2, profile=object())])
    done = sched.run([ServeRequest(rid=0, prompt=np.arange(3), max_new=2,
                                   profile=profiles.BeamProfile(n_beams=2, eos_id=2)),
                      ServeRequest(rid=2, prompt=np.arange(3), max_new=2, temperature=0.8)])
    assert sorted(r.rid for r in done) == [0, 2] and sched.n_group_admissions == 1
    assert all(len(r.tokens) == 2 for r in done)
    assert next(r for r in done if r.rid == 0).score is not None  # the beam's best


# ---------------------------------------------------------------- launcher
def test_poisson_trace_matches_jax():
    prof = serve.data_mod.PAPER_PROFILES["llama_humaneval"]
    kw = dict(pad_to=64, max_new_cap=16, vocab_size=512, arrival_rate=20.0, seed=3)
    mine = serve.poisson_trace(prof, 8, **kw)
    ref = jserve.poisson_trace(jserve.data_mod.PAPER_PROFILES["llama_humaneval"], 8, **kw)
    for a, b in zip(mine, ref):
        assert (a.rid, a.max_new, a.t_arrival) == (b.rid, b.max_new, b.t_arrival)
        np.testing.assert_array_equal(a.prompt, b.prompt)


def test_serve_main_on_cpu_prints_summary(capsys):
    m = serve.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
                    "--n-requests", "4", "--batch-slots", "2", "--max-new", "4",
                    "--eos-id", "3"])
    out = capsys.readouterr().out
    assert re.search(r"\[serve/continuous\] 4 requests in .* tok/s \| occupancy=", out)
    assert m["n_requests"] == 4 and m["device"] == "cpu"


def test_serve_main_defaults_to_cuda_and_refuses_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the refusal is for hosts without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "llama3.2-1b", "--smoke"])


# ------------------------------------------------------------------ guards
_BANNED_IMPORT = re.compile(
    r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)(\.|\s))", re.MULTILINE
)


def test_port_sources_import_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in _BANNED_IMPORT.finditer(f.read_text())]
    assert not bad, bad


#: modules the import lock must have walked (the multimodal slice's among them)
_LOCKED_MODULES = {
    "repro_torch.core.engine", "repro_torch.core.profiles", "repro_torch.core.sampling",
    "repro_torch.core.prng", "repro_torch.core.layerskip",
    "repro_torch.core.kv_cache", "repro_torch.models.encdec", "repro_torch.models.seamless",
    "repro_torch.models.vlm", "repro_torch.configs.whisper_base",
    "repro_torch.configs.seamless_m4t", "repro_torch.configs.chameleon_34b",
    "repro_torch.core.prefix_cache", "repro_torch.core.scheduler",
    "repro_torch.core.slot_pool", "repro_torch.launch.serve", "repro_torch.core.router",
    "repro_torch.models.moe", "repro_torch.configs.qwen3_moe_30b_a3b",
    "repro_torch.configs.deepseek_v2_236b", "repro_torch.configs.qwen2_5_3b",
    "repro_torch.configs.yi_34b", "repro_torch.configs.llama3_405b",
    "repro_torch.core.characterization", "repro_torch.launch.op_breakdown",
    "repro_torch.training.optimizer", "repro_torch.training.checkpoint",
    "repro_torch.training.train_loop", "repro_torch.launch.train",
    "repro_torch.analysis.astlint", "repro_torch.analysis.hotpath",
    "repro_torch.analysis.trace_audit", "repro_torch.core.graphs",
    "repro_torch.kernels.counts",
}


def test_importing_the_whole_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(' '.join(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 15
    assert _LOCKED_MODULES <= names, sorted(_LOCKED_MODULES - names)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """On a host without CUDA, and from a directory holding only the
    script, chip_smoke.py exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
