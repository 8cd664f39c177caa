"""Port's expert parallelism (``moe.moe_ffn_ep`` over ``TPGroup.all_to_all``)
against the JAX package's ``moe_ffn_ep`` under ``EP_MESH``.

- The reference runs in ONE subprocess with 4 forced host devices, as
  ``tests/test_distributed.py`` runs its scripts, started first so that it
  runs beside the port's ranks: the f32 smoke configs of qwen3-moe (4
  experts top-2) and deepseek-v2 (4 experts top-2, one shared expert) on
  the meshes ``(data 2, model 2)`` and ``(1, 4)``, at the default capacity
  factor, at 0.5 (assignments drop) and at ``E / k`` (dropless). Params
  from ``init_moe(PRNGKey(0))``, x and the cotangent ``ct`` [4, 16, 256]
  from numpy seeds; it saves out, aux, each data row's dropped assignments
  and ``jax.grad`` of ``sum(out * ct) + aux`` for the params and x.
- The port runs on ONE set of 4 gloo ranks spawned for the module (a
  ``FileStore`` under ``tmp_path``: no TCP port; one thread each), whose
  ``tp_pool.ep_group`` builds both layouts; the params cross through
  ``bridge.py``. Each rank's out, the aux, the drops and the gradients
  summed as the reference holds them; the plain version
  (``moe_ffn_ep_plain``) bit for bit the ranks; the all-to-all through the
  shared slots (one round and several) and through gloo alike, with its
  counters; at dropless capacity ranks with tokens of their own equal to
  ``moe_ffn`` on each rank's tokens; a smoke model of each MoE family bound
  to ``ep = 2`` giving the one-device logits and loss, and its remat'd
  backward exchanging again; and the refusals.

The JAX package is imported inside the tests only: the spawned ranks import
this module and stay free of it."""
import dataclasses
import json
import os
import platform
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import sharding, tp_pool
from repro_torch.models import get_model
from repro_torch.models import moe as M
from repro_torch.training import train_loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = dict(atol=2e-5, rtol=2e-4)
N_RANKS = 4
ARCHS = ("qwen3-moe-30b-a3b", "deepseek-v2-236b")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
#: capacity factor by name: None keeps the config's (1.25)
FACTORS = {"default": None, "0.5": 0.5, "dropless": "E/k"}
CASES = {f"{mesh}/{arch}/{cf}": (MESHES[mesh], arch, FACTORS[cf])
         for mesh in MESHES for arch in ARCHS for cf in FACTORS}
X_SHAPE = (4, 16, 256)  # both smoke configs are at d_model 256

_REF_SCRIPT = """
import dataclasses, json, sys
import jax, jax.numpy as jnp
import numpy as np
assert jax.device_count() == 4, jax.device_count()
from repro.configs import SMOKE_CONFIGS
from repro.models import moe as M

cases, path = json.loads(sys.argv[1]), sys.argv[2]
x = jnp.asarray(np.random.default_rng(1).standard_normal(%(shape)r), jnp.float32)
ct = jnp.asarray(np.random.default_rng(2).standard_normal(%(shape)r), jnp.float32)
out = {}
for name, (mesh_shape, arch, cf) in cases.items():
    cfg = SMOKE_CONFIGS[arch].replace(dtype="float32")
    if cf is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=float(cf)))
    p = M.init_moe(jax.random.PRNGKey(0), cfg)
    mesh = jax.make_mesh(tuple(mesh_shape), ("data", "model"))

    def loss(p, x):
        o, aux = M.moe_ffn(cfg, p, x)
        return jnp.sum(o * ct) + aux, (o, aux)

    M.EP_MESH = mesh
    with mesh:
        (_, (o, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(p, x)
    M.EP_MESH = None
    out[name + "/out"], out[name + "/aux"], out[name + "/gx"] = o, aux, gx
    for path_, g in jax.tree_util.tree_leaves_with_path(gp):
        out[name + "/g/" + "/".join(k.key for k in path_)] = g
    # each data row's dropped assignments, as its ranks' local_fn ranks them
    m, data = cfg.moe, mesh_shape[0]
    drops = []
    for rows in np.split(np.asarray(x), data):
        xf = jnp.asarray(rows).reshape(-1, cfg.d_model)
        probs = jax.nn.softmax(xf @ p["router"]["w"], axis=-1)
        _, top_ids = jax.lax.top_k(probs, m.top_k)
        n = xf.shape[0]
        pos = M._position_in_expert(top_ids.reshape(-1), m.n_experts, "sort")
        cap = M._round8(int(m.capacity_factor * n * m.top_k / m.n_experts))
        drops.append(int((pos >= cap).sum()))
    out[name + "/drops"] = np.asarray(drops)
np.savez(path, **{k: np.asarray(v) for k, v in out.items()})
print("EP_REF_DONE")
""" % {"shape": X_SHAPE}


def _cfg(arch, cf=None):
    cfg = get_smoke_config(arch).replace(dtype="float32")
    if cf == "E/k":
        cf = cfg.moe.n_experts / cfg.moe.top_k
    if cf is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=float(cf)))
    return cfg


def _inputs():
    x = np.random.default_rng(1).standard_normal(X_SHAPE).astype(np.float32)
    ct = np.random.default_rng(2).standard_normal(X_SHAPE).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(ct)


def _rank_rows(t, rank, data, ep):
    """The reference's ``xspec``: x split over ``data`` only, so every rank
    of a data row holds that row's tokens."""
    b = t.shape[0] // data
    row = rank // ep
    return t[row * b:(row + 1) * b]


def _leaves(tree):
    """{path: leaf} of a tree (``sharding.map_with_path``'s paths, which
    are the reference's key paths joined by ``/``)."""
    out = {}
    sharding.map_with_path(lambda path, t: out.setdefault(path, t), tree)
    return out


def _live(tree):
    return sharding.map_with_path(lambda _, t: t.detach().clone().requires_grad_(True), tree)


def _layer_cases(group, layouts, np_params):
    """Every reference case on this rank: out, aux, drops and gradients."""
    x_all, ct_all = _inputs()
    res = {}
    for name, ((data, ep), arch, cf) in CASES.items():
        cfg = _cfg(arch, cf)
        whole = bridge.tree_to_torch(np_params[arch], "cpu")
        grp = layouts[(data, ep)]
        p = _live(sharding.shard_tree(whole, sharding.ep_param_specs(cfg, whole, ep),
                                      grp.rank, ep))
        x = _rank_rows(x_all, group.rank, data, ep).clone().requires_grad_(True)
        ct = _rank_rows(ct_all, group.rank, data, ep)
        out, aux = M.moe_ffn(cfg, p, x, impl="torch", ep=grp)
        # the objective sum(out * ct) + aux split over the ranks that hold
        # each term, as shard_map divides a replicated output's cotangent by
        # the ranks that hold it: a token's output over its data row's ep
        # ranks (1/ep each), the aux, which every rank holds, over all N
        # (1/N each); the ranks' gradients of a leaf they share then sum to
        # the reference's
        (torch.sum(out * ct) / ep + aux / group.size).backward()
        _, _, plan = M.ep_dispatch(cfg, p, x.detach().reshape(-1, x.shape[-1]))
        res[name] = dict(out=out.detach().numpy(), aux=float(aux), gx=x.grad.numpy(),
                         g={k: v.grad.numpy() for k, v in _leaves(p).items()},
                         drops=int((~plan.keep).sum()))
    return res


def _plain_cases(np_params):
    """The plain version of every reference case (each rank's out and the
    aux), for the bit-for-bit check."""
    x_all, _ = _inputs()
    res = {}
    for name, ((data, ep), arch, cf) in CASES.items():
        cfg = _cfg(arch, cf)
        p = bridge.tree_to_torch(np_params[arch], "cpu")
        xs = [_rank_rows(x_all, r, data, ep) for r in range(N_RANKS)]
        with torch.no_grad():
            outs, aux = M.moe_ffn_ep_plain(cfg, p, xs, ep, impl="torch")
        res[name] = ([o.numpy() for o in outs], float(aux))
    return res


def _exchanges(group, layouts):
    """The all-to-all through the slots (one round; two rounds, past
    SLOT_BYTES) and through gloo (the same process group, no slots), each
    against the chunks every rank's seeded x sends this one; the rounds
    the slots took and the counters the calls left."""
    grp = layouts[(1, N_RANKS)]
    gloo = tp_pool.TPGroup(grp.rank, grp.size, "cpu", grp.backend, None, pg=grp.pg)
    out = {"has_slots": grp.slots is not None}
    for name, shape in {"one round": (N_RANKS * 24, 256),
                        "rounds": (N_RANKS * 520, 1024)}.items():
        xs = [torch.randn(shape, generator=torch.Generator().manual_seed(100 + r))
              for r in range(N_RANKS)]
        want = torch.cat([x.chunk(N_RANKS)[grp.rank] for x in xs])
        seq = grp.slots.seq if grp.slots is not None else 0
        counters = [(g.n_exchanges, g.exchange_bytes) for g in (grp, gloo)]
        via_slots = grp.all_to_all(xs[grp.rank])
        rounds = grp.slots.seq - seq if grp.slots is not None else None
        via_gloo = gloo.all_to_all(xs[grp.rank])
        counted = [(g.n_exchanges - n, g.exchange_bytes - b)
                   for g, (n, b) in zip((grp, gloo), counters)]
        out[name] = dict(slots=torch.equal(via_slots, want), gloo=torch.equal(via_gloo, want),
                         nbytes=xs[0].numel() * 4, rounds=rounds, counted=counted,
                         reduces=(grp.n_reduces, gloo.n_reduces))
    return out


def _own_tokens(group, layouts, np_params):
    """Ranks with tokens of their own (the (1, 4) layout, rank r the r-th
    quarter of a [16, 16, 256] batch) at dropless capacity, and
    ``moe_ffn`` on the same rank's tokens on one device."""
    x_all = torch.from_numpy(
        np.random.default_rng(3).standard_normal((16, 16, 256)).astype(np.float32))
    x = x_all[4 * group.rank:4 * (group.rank + 1)]
    res = {}
    for arch in ARCHS:
        cfg = _cfg(arch, "E/k")
        whole = bridge.tree_to_torch(np_params[arch], "cpu")
        grp = layouts[(1, N_RANKS)]
        p = sharding.shard_tree(whole, sharding.ep_param_specs(cfg, whole, N_RANKS),
                                grp.rank, N_RANKS)
        with torch.no_grad():
            ep_out, ep_aux = M.moe_ffn(cfg, p, x, impl="torch", ep=grp)
            one_out, one_aux = M.moe_ffn(cfg, whole, x, impl="torch")
        res[arch] = dict(ep=ep_out.numpy(), one=one_out.numpy(), ep_aux=float(ep_aux),
                         one_aux=float(one_aux))
    return res


def _models(group, layouts):
    """A smoke model of each MoE family (dropless) bound to its data row's
    ``ep = 2`` group, each rank with a batch of its own: the train forward's
    logits and loss, and the one-device run's on the same batch; then the
    loss's gradient with ``remat`` off and on, with the exchanges each
    backward made."""
    grp = layouts[(2, 2)]
    res = {}
    for arch in ARCHS:
        cfg = _cfg(arch, "E/k")
        one = get_model(cfg)
        params = one.init(torch.Generator().manual_seed(7), "cpu")
        gen = torch.Generator().manual_seed(50 + group.rank)
        tokens = torch.randint(0, cfg.vocab_size, (2, 9), generator=gen)
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        mine = sharding.shard_tree(params, sharding.ep_param_specs(cfg, params, 2), grp.rank, 2)
        ep_model = dataclasses.replace(one, ep=grp)
        with torch.no_grad():
            ep_logits, _, ep_aux = ep_model.forward(mine, batch, impl="torch")
            one_logits, _, one_aux = one.forward(params, batch, impl="torch")
            ep_loss, ep_parts = train_loop.loss_fn(ep_model, mine, batch, impl="torch")
            one_loss, one_parts = train_loop.loss_fn(one, params, batch, impl="torch")
        grads = {}
        for remat in (False, True):
            model = dataclasses.replace(ep_model, config=cfg.replace(remat=remat))
            live = _live(mine)
            before = grp.n_exchanges
            with torch.enable_grad():
                loss, _ = train_loop.loss_fn(model, live, batch, impl="torch")
                loss.backward()
            grads[remat] = dict(
                n=grp.n_exchanges - before,
                g={k: v.grad.numpy() for k, v in _leaves(live).items()
                   if v.grad is not None})
        n_moe = sum(1 for lp in params["layers"] if "moe" in lp)
        res[arch] = dict(ep_logits=ep_logits.numpy(), one_logits=one_logits.numpy(),
                         ep_ce=float(ep_parts["ce"]), one_ce=float(one_parts["ce"]),
                         ep_aux=float(ep_aux["aux_loss"]), one_aux=float(one_aux["aux_loss"]),
                         ep_loss=float(ep_loss), one_loss=float(one_loss),
                         grads=grads, n_moe=n_moe)
    return res


def _refusals(group, layouts, np_params):
    """``ep`` with ``tp``, E that does not split over the group, a shard of
    the wrong size, a non-MoE family bound to a group: each raises by
    name."""
    cfg = _cfg("qwen3-moe-30b-a3b")
    whole = bridge.tree_to_torch(np_params["qwen3-moe-30b-a3b"], "cpu")
    x = torch.zeros(1, 4, 256)
    grp = layouts[(2, 2)]
    out = {}
    for name, fn in {
        "ep with tp": lambda: M.moe_ffn(cfg, whole, x, ep=grp, tp=grp),
        "E over 3": lambda: sharding.ep_param_specs(cfg, whole, 3),
        "whole experts at ep 2": lambda: M.moe_ffn(cfg, whole, x, ep=grp),
        "dense family": lambda: dataclasses.replace(
            get_model(_cfg("llama3.2-1b")), ep=grp).forward(
                None, {"tokens": torch.zeros(1, 4, dtype=torch.long)}),
    }.items():
        try:
            fn()
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    return out


def _unequal_n(group, layouts, np_params):
    """The (1, 4) group's ranks with different token counts: every rank
    raises before any exchange."""
    cfg = _cfg("qwen3-moe-30b-a3b")
    whole = bridge.tree_to_torch(np_params["qwen3-moe-30b-a3b"], "cpu")
    grp = layouts[(1, N_RANKS)]
    p = sharding.shard_tree(whole, sharding.ep_param_specs(cfg, whole, N_RANKS), grp.rank,
                            N_RANKS)
    x = torch.zeros(1, 4 + (grp.rank == 2), 256)
    before = grp.n_exchanges
    try:
        M.moe_ffn(cfg, p, x, ep=grp)
        return None
    except ValueError as e:
        return str(e), grp.n_exchanges - before


def _ep_rank(group, np_params):
    """One rank's share of every check; rank 0 also runs the plain
    version of every reference case."""
    layouts = {(data, ep): tp_pool.ep_group(group, ep) for data, ep in MESHES.values()}
    out = {"layers": _layer_cases(group, layouts, np_params),
           "exchanges": _exchanges(group, layouts),
           "own": _own_tokens(group, layouts, np_params),
           "models": _models(group, layouts),
           "refusals": _refusals(group, layouts, np_params),
           "unequal": _unequal_n(group, layouts, np_params),
           "groups": {f"{d}x{e}": (g.rank, g.size, g.slots is not None, g.whole is group)
                      for (d, e), g in layouts.items()}}
    if group.rank == 0:
        out["plain"] = _plain_cases(np_params)
    return out


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def np_params():
    import jax

    from repro.configs import SMOKE_CONFIGS
    from repro.models import moe as jM

    return {arch: jax.tree.map(np.asarray, jM.init_moe(
        jax.random.PRNGKey(0), SMOKE_CONFIGS[arch].replace(dtype="float32"))) for arch in ARCHS}


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    """The reference's subprocess, started before the ranks so that both
    run at once; killed at the module's end if it still runs."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    path = tmp_path_factory.mktemp("ep_ref") / "ref.npz"
    cases = {name: (mesh, arch, _cfg(arch, cf).moe.capacity_factor if cf else None)
             for name, (mesh, arch, cf) in CASES.items()}
    proc = subprocess.Popen([sys.executable, "-c", _REF_SCRIPT, json.dumps(cases), str(path)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ranks(ref_run, np_params, tmp_path_factory):
    """Every check's work, done once by 4 spawned gloo ranks on the CPU."""
    store = tmp_path_factory.mktemp("ep_store") / "store"
    return tp_pool.spawn(_ep_rank, N_RANKS, np_params, devices=["cpu"] * N_RANKS,
                         init_file=str(store))


@pytest.fixture(scope="module")
def reference(ref_run):
    proc, path = ref_run
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0 and "EP_REF_DONE" in stdout, stdout[-4000:] + stderr[-4000:]
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@pytest.mark.parametrize("case", list(CASES))
def test_ep_out_and_aux_equal_the_reference(ranks, reference, case):
    """Each rank's output is its data row's rows of the reference's; the
    aux (each rank's own, averaged over all four) the reference's."""
    (data, ep), _, _ = CASES[case]
    want = reference[f"{case}/out"]
    for r, rank in enumerate(ranks):
        got = rank["layers"][case]
        np.testing.assert_allclose(got["out"], _rank_rows(want, r, data, ep), **F32)
        np.testing.assert_allclose(got["aux"], reference[f"{case}/aux"], **F32)


@pytest.mark.parametrize("case", list(CASES))
def test_ep_gradients_equal_the_reference(ranks, reference, case):
    """x's gradient summed over its data row's ranks, each expert block's
    over the data rows that hold it, the router's and the shared experts'
    over every rank: the reference's ``jax.grad``."""
    (data, ep), _, _ = CASES[case]
    got = [rank["layers"][case] for rank in ranks]
    b = X_SHAPE[0] // data
    for row in range(data):
        gx = sum(got[row * ep + j]["gx"] for j in range(ep))
        np.testing.assert_allclose(gx, reference[f"{case}/gx"][row * b:(row + 1) * b], **F32)
    for leaf in got[0]["g"]:
        want = reference[f"{case}/g/{leaf}"]
        if leaf in ("w1", "w3", "w2"):
            el = want.shape[0] // ep
            for j in range(ep):
                g = sum(got[row * ep + j]["g"][leaf] for row in range(data))
                np.testing.assert_allclose(g, want[j * el:(j + 1) * el], **F32, err_msg=leaf)
        else:
            np.testing.assert_allclose(sum(r["g"][leaf] for r in got), want, **F32,
                                       err_msg=leaf)
    assert set(got[0]["g"]) == {k[len(case) + 3:] for k in reference
                                if k.startswith(case + "/g/")}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_ep_drops_what_the_reference_drops(ranks, reference, mesh, arch):
    """At capacity factor 0.5 each rank drops its data row's dropped
    assignments, some; dropless drops none."""
    data, ep = MESHES[mesh]
    want = reference[f"{mesh}/{arch}/0.5/drops"]
    assert want.min() > 0
    for r, rank in enumerate(ranks):
        assert rank["layers"][f"{mesh}/{arch}/0.5"]["drops"] == want[r // ep]
        assert rank["layers"][f"{mesh}/{arch}/dropless"]["drops"] == 0
    assert not reference[f"{mesh}/{arch}/dropless/drops"].any()


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_is_the_ranks_bit_for_bit(ranks, case):
    """The plain version (every rank in one process, the all-to-alls as
    reshapes) gives each rank's output bit for bit, and the aux too where
    the ranks sum it in rank order through the shared slots (x86-64)."""
    outs, aux = ranks[0]["plain"][case]
    for r, rank in enumerate(ranks):
        np.testing.assert_array_equal(rank["layers"][case]["out"], outs[r])
        if ranks[0]["groups"]["1x4"][2]:
            assert rank["layers"][case]["aux"] == aux
        else:
            np.testing.assert_allclose(rank["layers"][case]["aux"], aux, **F32)


@pytest.mark.parametrize("size", ["one round", "rounds"])
def test_all_to_all_through_slots_and_gloo_alike(ranks, size):
    """Chunk j of rank i lands as chunk i of rank j, through the slots (in
    two rounds past SLOT_BYTES) and through gloo alike, bit for bit; each
    call counted once with the bytes the rank sent, and as no reduce."""
    for rank in ranks:
        got = rank["exchanges"][size]
        assert got["slots"] and got["gloo"]
        assert got["counted"] == [(1, got["nbytes"])] * 2
        assert got["reduces"] == (0, 0)
        if rank["exchanges"]["has_slots"]:
            assert got["rounds"] == (1 if size == "one round" else 2)
        assert (got["nbytes"] > tp_pool.SLOT_BYTES) == (size == "rounds")
    assert ranks[0]["exchanges"]["has_slots"] == (platform.machine() == "x86_64")


@pytest.mark.parametrize("arch", ARCHS)
def test_own_tokens_at_dropless_capacity_equal_moe_ffn(ranks, arch):
    """Ranks with tokens of their own, dropless: each rank's output is
    ``moe_ffn`` on its tokens, and the aux the mean of the ranks' own."""
    for rank in ranks:
        got = rank["own"][arch]
        np.testing.assert_allclose(got["ep"], got["one"], **F32)
        np.testing.assert_allclose(got["ep_aux"], np.mean([r["own"][arch]["one_aux"]
                                                           for r in ranks]), **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_bound_to_ep_gives_the_one_device_logits_and_loss(ranks, arch):
    """A smoke model (dropless) bound to ``ep = 2``, each rank with its own
    batch: the one-device logits and cross entropy on that batch; its aux
    the mean over the four ranks of the one-device aux."""
    mean_aux = np.mean([r["models"][arch]["one_aux"] for r in ranks])
    for rank in ranks:
        got = rank["models"][arch]
        np.testing.assert_allclose(got["ep_logits"], got["one_logits"], atol=1e-4, rtol=1e-3)
        np.testing.assert_allclose(got["ep_ce"], got["one_ce"], **F32)
        np.testing.assert_allclose(got["ep_aux"], mean_aux, **F32)
        np.testing.assert_allclose(got["ep_loss"], got["one_ce"] + mean_aux, **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_backward_exchanges_again(ranks, arch):
    """Two exchanges a MoE layer forward and two backward; under ``remat``
    the recomputed layers exchange twice more. The gradients are the
    same."""
    for rank in ranks:
        got = rank["models"][arch]
        plain, remat = got["grads"][False], got["grads"][True]
        assert plain["n"] == 4 * got["n_moe"] and remat["n"] == 6 * got["n_moe"]
        assert set(plain["g"]) == set(remat["g"])
        for k in plain["g"]:
            np.testing.assert_allclose(remat["g"][k], plain["g"][k], **F32, err_msg=k)


def test_layouts_and_refusals(ranks):
    """Each layout's group: rank r at r % ep of ep, the whole group its
    ``whole``. ``ep`` with ``tp``, E = 4 over 3 ranks, whole experts on a
    rank of 2 and a dense model bound to a group raise by name; ranks with
    different token counts raise on every rank before any exchange."""
    for r, rank in enumerate(ranks):
        for name, (data, ep) in MESHES.items():
            g_rank, g_size, _, whole = rank["groups"][name]
            assert (g_rank, g_size, whole) == (r % ep, ep, True)
        why = rank["refusals"]
        assert "ep and tp together" in why["ep with tp"]
        assert "moe.n_experts = 4 does not split over ep = 3" in why["E over 3"]
        assert "moe.n_experts = 4" in why["whole experts at ep 2"]
        assert why["dense family"].startswith("NotImplementedError")
        msg, exchanged = rank["unequal"]
        assert "different count" in msg and exchanged == 0


def test_ep_group_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp_pool.ep_group(tp_pool.TPGroup(0, 2, "cuda"), 2)


def test_ep_specs_split_only_the_routed_experts():
    """The reference's ``pspec``: ``w1`` / ``w3`` / ``w2`` on the expert
    axis, the router and the shared experts whole; in a whole model every
    MoE layer's experts, nothing else."""
    cfg = _cfg("deepseek-v2-236b")
    params = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    flat = sharding.flat_specs(sharding.ep_param_specs(cfg, params, 2))
    split = sorted(k for k, v in flat.items() if v)
    assert split == [f"layers/1/moe/{w}" for w in ("w1", "w2", "w3")]
    assert all(flat[k] == ("model", None, None) for k in split)
    assert flat["layers/1/moe/shared/w1/w"] == () and flat["layers/1/moe/router/w"] == ()
