"""The port's training stack against the JAX package's, on the CPU.

The reference's inits (``init(PRNGKey(0))``) cross by ``repro_torch.bridge``
without the serving-only ``table_f32`` (``layers.drop_f32_table``); batches
are made with numpy and handed to both sides. The JAX side trains on its
XLA path (jitted), as it does on any host but a TPU: ``jax.grad`` cannot
differentiate a Pallas kernel.

- ``data.token_stream``: the same batches for seeds, ranks and world sizes;
- ``layers.cross_entropy_loss`` with and without a mask (an all-zero one
  too), ``optimizer.lr_at`` over the warmup, the decay and the tail,
  ``global_norm``, and the decay mask over every leaf path of every family;
- ``optimizer.apply_updates`` given the reference's gradients for bf16 and
  f32 params and both moment dtypes: f32 results at atol 2e-5 / rtol 2e-4,
  bf16 params bit for bit;
- ``loss_fn`` and every gradient leaf against ``jax.value_and_grad`` for
  the f32 smoke config of each of the twelve architectures (HSTU among
  them; MoE's aux loss in the loss), ``remat`` against no remat, and one
  whole ``make_train_step`` step;
- the bf16 smoke step of every architecture (finite, params moved);
- ``.npz`` checkpoints across the two packages in both directions, and one
  step trained in each package from the same weights saving the same file;
- the launcher, the kernel dispatch's refusal under autograd, and the
  trained params served again."""
import dataclasses
import io
import re
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_CONFIGS
from repro.models import get_model as jget_model
from repro.models import layers as JL
from repro.training import checkpoint as jckpt
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro.training import train_loop as jtl
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core import engine
from repro_torch.kernels import ops
from repro_torch.launch import train as train_launch
from repro_torch.models import get_model
from repro_torch.models import layers as L
from repro_torch.training import checkpoint, data, optimizer as opt
from repro_torch.training import train_loop as tl

ARCHS = list(SMOKE_CONFIGS)  # the twelve architectures, HSTU among them
F32 = dict(atol=2e-5, rtol=2e-4)
B, T = 2, 8
#: one warmup step, so the first step's update is the full lr (1e-3), not a
#: warmup fraction of it that any tolerance would hide
OCFG = dict(lr=1e-3, warmup_steps=1, total_steps=10)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while the module runs (the ops are tiny)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(cfg):
    """The f32 config, MoE at dropless capacity (``tests/test_cache.py:22``)."""
    cfg = cfg.replace(dtype="float32")
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    return cfg


def jpath(path) -> str:
    """A JAX key path as the reference's checkpoint and decay mask spell it."""
    return "/".join(str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p))))
                    for p in path)


def jflat(tree) -> dict:
    return {jpath(p): np.asarray(x) for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def tflat(tree) -> dict:
    return {opt.path_str(p): x.detach().float().numpy() if x.dtype == torch.bfloat16
            else x.detach().numpy() for p, x in opt.tree_items(tree)}


def to_np32(tree) -> dict:
    return {k: np.asarray(v, np.float32) for k, v in jflat(tree).items()}


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)}
    if cfg.family in ("encdec", "seamless"):  # the encoder's stub frames
        batch["frames"] = rng.standard_normal(
            (B, cfg.encdec.n_frames, cfg.d_model)).astype(np.float32)
    return batch


_RUNS = {}


def reference_run(arch):
    """For ``arch``'s f32 smoke config: (the JAX model, its params, the port
    model, the bridged params, the batch, the reference's jitted
    ``value_and_grad`` and ``make_train_step`` step on it). One compile."""
    if arch not in _RUNS:
        jcfg = _f32(SMOKE_CONFIGS[arch])
        jmodel = jget_model(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        model = get_model(_f32(get_smoke_config(arch)))
        params = L.drop_f32_table(
            bridge.params_to_torch(model.config, jax.tree.map(np.asarray, jparams), "cpu"))
        batch = _batch(jcfg)
        ocfg = jopt.OptimizerConfig(**OCFG)
        step = jtl.make_train_step(jmodel, ocfg)

        def both(p, s, b):
            vg = jax.value_and_grad(lambda q: jtl.loss_fn(jmodel, q, b), has_aux=True)(p)
            return vg, step(p, s, b)

        out = jax.jit(both)(jparams, jopt.init_state(jparams, ocfg),
                            {k: jnp.asarray(v) for k, v in batch.items()})
        _RUNS[arch] = (jmodel, jparams, model, params, batch, jax.device_get(out))
    return _RUNS[arch]


def tbatch(batch):
    return tl.to_batch(batch, "cpu")


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("seed,rank,world", [(0, 0, 1), (3, 1, 4), (7, 3, 4)])
def test_token_stream_matches_reference(seed, rank, world):
    jcfg, cfg = SMOKE_CONFIGS["llama3.2-1b"], get_smoke_config("llama3.2-1b")
    want = jdata.token_stream(jcfg, batch=3, seq_len=17, seed=seed, rank=rank, world=world)
    got = data.token_stream(cfg, batch=3, seq_len=17, seed=seed, rank=rank, world=world)
    for _ in range(3):
        w, g = next(want), next(got)
        assert set(g) == set(w) == {"tokens", "labels"}
        for k in w:
            assert g[k].dtype == w[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], w[k])
        np.testing.assert_array_equal(g["labels"][:, :-1], g["tokens"][:, 1:])


# ------------------------------------------------------------ loss, lr, norm
@pytest.mark.parametrize("mask", ["none", "random", "zeros"])
def test_cross_entropy_loss_matches_reference(mask):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    m = {"none": None, "random": (rng.random((3, 7)) < 0.5).astype(np.float32),
         "zeros": np.zeros((3, 7), np.float32)}[mask]
    want = JL.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                 None if m is None else jnp.asarray(m))
    got = L.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                               None if m is None else torch.from_numpy(m))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    if mask == "zeros":
        assert float(got) == 0.0


def test_lr_at_matches_reference():
    cfg = opt.OptimizerConfig(lr=3e-4, warmup_steps=10, total_steps=50, min_lr_frac=0.1)
    jcfg = jopt.OptimizerConfig(lr=3e-4, warmup_steps=10, total_steps=50, min_lr_frac=0.1)
    for s in range(0, 60):  # warmup, decay, tail
        want = np.asarray(jopt.lr_at(jnp.asarray(s, jnp.int32), jcfg))
        got = opt.lr_at(torch.tensor(s, dtype=torch.int32), cfg)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert float(opt.lr_at(torch.tensor(59, dtype=torch.int32), cfg)) == pytest.approx(3e-5)


def test_global_norm_matches_reference():
    _, jparams, _, params, _, _ = reference_run("llama3.2-1b")
    np.testing.assert_allclose(opt.global_norm(params).numpy(),
                               np.asarray(jopt.global_norm(jparams)), **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_decay_mask_matches_reference_on_every_leaf(arch):
    """The same leaf paths as the reference's tree (no ``table_f32``), and
    the same decision on each: the substring rule with its ``"/b"`` and
    ``"D"``."""
    _, jparams, _, params, _, _ = reference_run(arch)
    want = {jpath(p): jopt._is_decayed(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    got = {opt.path_str(p): opt._is_decayed(p) for p, _ in opt.tree_items(params)}
    assert got == want
    assert not any("table_f32" in k for k in got)


# ------------------------------------------------------------ apply_updates
@pytest.mark.parametrize("pdt,mdt,clip", [
    ("float32", "float32", False), ("float32", "float32", True),
    ("float32", "bfloat16", False), ("float32", "bfloat16", True),
    ("bfloat16", "float32", False), ("bfloat16", "bfloat16", False)])
def test_apply_updates_given_the_same_gradients(pdt, mdt, clip):
    """Three steps of both optimizers fed the reference's gradients (the
    f32 llama smoke's, cast to the params' type), through the warmup and
    into the decay (warmup 2, total 5): the metrics, f32 params and every
    moment at f32 tolerance, bf16 params bit for bit after the cast.
    ``clip``: the raw gradients (norm ~175, clipped to 1); otherwise scaled
    to norm 0.5, so the clip's scale is exactly 1 in both packages. Clipped,
    the scale carries the norm's summation order: XLA's f32 sum of the
    squares is 8e-7 off the f64 value here, the port's rounds it correctly,
    so bf16 params are compared only unclipped."""
    _, jparams, _, _, _, (((_, _), jgrads), _) = reference_run("llama3.2-1b")
    jcfg = jopt.OptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=5, moment_dtype=mdt)
    cfg = opt.OptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=5, moment_dtype=mdt)
    norm = float(jopt.global_norm(jgrads))
    jp = jax.tree.map(lambda x: x.astype(pdt), jparams)
    jg = jax.tree.map(lambda x: (x if clip else x * (0.5 / norm)).astype(pdt), jgrads)
    tcfg = get_smoke_config("llama3.2-1b").replace(dtype=pdt)
    tp = L.drop_f32_table(bridge.params_to_torch(tcfg, jax.tree.map(np.asarray, jp), "cpu"))
    tg = L.drop_f32_table(bridge.params_to_torch(tcfg, jax.tree.map(np.asarray, jg), "cpu"))
    assert (float(opt.global_norm(tg)) > 1.0) == clip
    jstate, tstate = jopt.init_state(jp, jcfg), opt.init_state(tp, cfg)
    for _ in range(3):
        jp, jstate, jm = jopt.apply_updates(jp, jg, jstate, jcfg)
        tp, tstate, tm = opt.apply_updates(tp, tg, tstate, cfg)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), **F32)
        assert int(tstate.step) == int(jstate.step)
        want, got = jflat(jp), tflat(tp)
        for k in want:
            if pdt == "bfloat16":
                np.testing.assert_array_equal(got[k], np.asarray(want[k], np.float32),
                                              err_msg=k)
            else:
                np.testing.assert_allclose(got[k], want[k], **F32, err_msg=k)
        for mine, ref in ((tstate.mu, jstate.mu), (tstate.nu, jstate.nu)):
            want, got = to_np32(ref), tflat(mine)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], **F32, err_msg=k)
    for _, x in opt.tree_items(tstate.mu):
        assert x.dtype == (torch.bfloat16 if mdt == "bfloat16" else torch.float32)


# ------------------------------------------------------- loss and gradients
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    """``loss_fn`` (MoE's aux loss in it) within atol 2e-5 / rtol 2e-4, and
    each gradient leaf within atol 2e-5 + 2e-4 max|g| of the reference's;
    the leaves the loss does not reach get zeros, as in the reference."""
    _, _, model, params, batch, (((jloss, jparts), jgrads), _) = reference_run(arch)
    loss, parts, grads = tl.value_and_grad(model, params, tbatch(batch))
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), **F32)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(parts[k].numpy(), np.asarray(jparts[k]), **F32)
    if model.config.moe is not None:
        assert float(parts["aux"]) > 0
    want, got = jflat(jgrads), tflat(grads)
    assert set(got) == set(want)
    for k, g in want.items():
        tol = 2e-5 + 2e-4 * float(np.abs(g).max())
        err = float(np.abs(got[k] - g).max())
        assert err <= tol, f"{arch} {k}: |dgrad| {err} > {tol}"


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-v2-236b"])
def test_remat_gives_the_same_loss_and_gradients(arch):
    _, _, model, params, batch, _ = reference_run(arch)
    remat = get_model(model.config.replace(remat=True))
    loss, _, grads = tl.value_and_grad(model, params, tbatch(batch))
    rloss, _, rgrads = tl.value_and_grad(remat, params, tbatch(batch))
    assert torch.equal(loss, rloss)
    for (p, g), (_, rg) in zip(opt.tree_items(grads), opt.tree_items(rgrads)):
        assert torch.equal(g, rg), opt.path_str(p)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, capsys):
    """One ``make_train_step`` step (lr 1e-3 from the first step): the
    metrics at f32 tolerance, the moments and new params at atol 2e-5 /
    rtol 2e-4. Adam's first step moves an element by about lr * sign(g): an
    element whose reference gradient lies within the gradient tolerance
    (rounding noise) may take the other sign, so it is held to |dparam| <=
    2 lr instead, and their number is printed."""
    _, jparams, model, params, batch, (_, (jnew, jstate, jmetrics)) = reference_run(arch)
    (_, _), jgrads = reference_run(arch)[5][0]
    cfg = opt.OptimizerConfig(**OCFG)
    step = tl.make_train_step(model, cfg)
    new, state, metrics = step(params, opt.init_state(params, cfg), tbatch(batch))
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(jmetrics[k]), **F32,
                                   err_msg=k)
    assert int(state.step) == int(jstate.step) == 1
    want, got, grads = jflat(jnew), tflat(new), jflat(jgrads)
    flips = 0
    for k, w in want.items():
        g = grads[k]
        noise = np.abs(g) <= 2e-5 + 2e-4 * float(np.abs(g).max())
        d = np.abs(got[k] - w)
        assert bool((d[noise] <= 2 * OCFG["lr"]).all()), k
        ok = np.isclose(got[k], w, **F32)
        flips += int((~ok & noise).sum())
        assert bool(ok[~noise].all()), f"{arch} {k}: max |dparam| {float(d[~noise].max())}"
    for mine, ref in ((state.mu, jstate.mu), (state.nu, jstate.nu)):
        w, g = to_np32(ref), tflat(mine)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], atol=2e-5, rtol=2e-4, err_msg=k)
    with capsys.disabled():
        print(f"\n[train step {arch}] elements at rounding-noise gradients that took "
              f"another update: {flips}")


# ------------------------------------------------------------ bf16 smoke step
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_smoke_train_step(arch):
    """``tests/test_smoke_archs.py:52`` on the port: the bf16 smoke config's
    own init, one step: finite loss and gradient norm, step 1, params
    moved."""
    cfg = get_smoke_config(arch)
    model = get_model(cfg)
    params = L.drop_f32_table(model.init(torch.Generator().manual_seed(0), "cpu"))
    ocfg = opt.OptimizerConfig(lr=1e-3, total_steps=10)
    tb = tbatch(_batch(cfg, seed=1))
    if "frames" in tb:
        tb["frames"] = tb["frames"].to(torch.bfloat16)
    new, state, metrics = tl.make_train_step(model, ocfg)(params, opt.init_state(params, ocfg),
                                                          tb)
    assert bool(torch.isfinite(metrics["loss"])) and bool(torch.isfinite(metrics["grad_norm"]))
    assert int(state.step) == 1
    assert any(not torch.equal(a, b) for a, b in zip(opt.leaf_list(new), opt.leaf_list(params)))
    assert all(a.dtype == b.dtype for a, b in zip(opt.leaf_list(new), opt.leaf_list(params)))


# ------------------------------------------------------------ checkpoints
def _bf16_pair():
    """The bf16 llama smoke (tied: the port's tree holds ``table_f32``) in
    both packages, with an optimizer state two steps in."""
    jcfg = SMOKE_CONFIGS["llama3.2-1b"]
    jmodel = jget_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config("llama3.2-1b")
    params = bridge.params_to_torch(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    assert "table_f32" in params["embed"]
    return jmodel, jparams, get_model(cfg), params


@pytest.mark.parametrize("mdt", ["float32", "bfloat16"])
def test_checkpoint_from_jax_restores_in_the_port(tmp_path, mdt):
    jmodel, jparams, model, params = _bf16_pair()
    jcfg = jopt.OptimizerConfig(moment_dtype=mdt)
    grads = jax.tree.map(lambda x: jnp.full_like(x, 0.01), jparams)
    jstate = jopt.init_state(jparams, jcfg)
    jparams, jstate, _ = jopt.apply_updates(jparams, grads, jstate, jcfg)
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, jparams, jstate, step=7)
    like = opt.init_state(L.drop_f32_table(params), opt.OptimizerConfig(moment_dtype=mdt))
    got, state, step = checkpoint.restore(path, params, like)
    assert step == 7 and int(state.step) == 1
    want = jflat(jparams)
    for k, v in tflat(L.drop_f32_table(got)).items():
        np.testing.assert_array_equal(v, np.asarray(want[k], np.float32), err_msg=k)
    for p, x in opt.tree_items(L.drop_f32_table(got)):
        assert x.dtype == torch.bfloat16, opt.path_str(p)
    assert torch.equal(got["embed"]["table_f32"], got["embed"]["table"].float())
    for mine, ref in ((state.mu, jstate.mu), (state.nu, jstate.nu)):
        w = to_np32(ref)
        for k, v in tflat(mine).items():
            np.testing.assert_array_equal(v, w[k], err_msg=k)


@pytest.mark.parametrize("mdt", ["float32", "bfloat16"])
def test_checkpoint_from_the_port_restores_in_jax(tmp_path, mdt):
    jmodel, jparams, model, params = _bf16_pair()
    cfg = opt.OptimizerConfig(moment_dtype=mdt)
    tp = L.drop_f32_table(params)
    grads = opt.tree_map(lambda _, x: torch.full_like(x, 0.01), tp)
    tp, state, _ = opt.apply_updates(tp, grads, opt.init_state(tp, cfg), cfg)
    path = str(tmp_path / "port.npz")
    checkpoint.save(path, dict(tp, embed=dict(tp["embed"], table_f32=tp["embed"]["table"]
                                              .float())), state, step=3)
    with np.load(path) as z:
        keys = set(z.files)
    assert not any("table_f32" in k for k in keys)
    assert {"__step__", "opt/step", "params/embed/table__bf16__"} <= keys
    jlike = jopt.init_state(jparams, jopt.OptimizerConfig(moment_dtype=mdt))
    jgot, jstate, step = jckpt.restore(path, jparams, jlike)
    assert step == 3 and int(jstate.step) == 1
    want = tflat(tp)
    for k, v in jflat(jgot).items():
        assert v.dtype == jnp.bfloat16
        np.testing.assert_array_equal(np.asarray(v, np.float32), want[k], err_msg=k)
    for ref, mine in ((jstate.mu, state.mu), (jstate.nu, state.nu)):
        w = tflat(mine)
        for k, v in to_np32(ref).items():
            np.testing.assert_array_equal(v, w[k], err_msg=k)


def test_one_step_in_each_package_saves_the_same_file(tmp_path):
    """Weights across and back: the reference's f32 llama init, one step in
    each package on the same batch (``test_train_step_matches_jax``'s),
    each saved by its own package: the same keys, dtypes and shapes, the
    moments at f32 tolerance, the params too but where the reference's
    gradient is rounding noise (there within 2 lr)."""
    _, _, model, params, batch, ((_, jgrads), (jnew, jstate, _)) = reference_run("llama3.2-1b")
    cfg = opt.OptimizerConfig(**OCFG)
    new, state, _ = tl.make_train_step(model, cfg)(params, opt.init_state(params, cfg),
                                                   tbatch(batch))
    jckpt.save(str(tmp_path / "jax.npz"), jnew, jstate, step=1)
    checkpoint.save(str(tmp_path / "port.npz"), new, state, step=1)
    grads = jflat(jgrads)
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            x, y = a[k], b[k]
            assert x.dtype == y.dtype and x.shape == y.shape, k
            if k.startswith("params/"):
                g = grads[k[len("params/"):]]
                noise = np.abs(g) <= 2e-5 + 2e-4 * float(np.abs(g).max())
                assert bool(np.isclose(y, x, **F32)[~noise].all()), k
                assert float(np.abs(x - y)[noise].max(initial=0)) <= 2 * OCFG["lr"], k
            else:
                np.testing.assert_allclose(y, x, **F32, err_msg=k)


# ------------------------------------------------------------ launcher
def test_train_launcher_prints_the_reference_lines(tmp_path):
    path = str(tmp_path / "ck.npz")
    out = io.StringIO()
    with redirect_stdout(out):
        params, state = train_launch.main(
            ["--arch", "llama3.2-1b", "--smoke", "--steps", "3", "--device", "cpu",
             "--log-every", "1", "--ckpt", path, "--batch", "2", "--seq", "16"])
    lines = out.getvalue().splitlines()
    assert re.fullmatch(r"\[train\] arch=llama3\.2-1b-smoke params=[\d.]+M device=cpu "
                        r"impl=torch", lines[0])
    steps = [ln for ln in lines if ln.startswith("step")]
    assert len(steps) == 3
    for i, ln in enumerate(steps):
        assert re.fullmatch(rf"step {i:5d} loss \d+\.\d{{4}} gnorm \d+\.\d{{3}} "
                            r"\(\d+ tok/s\)", ln), ln
    assert lines[-1] == f"[train] checkpoint -> {path}"
    cfg = get_smoke_config("llama3.2-1b")
    like = L.drop_f32_table(get_model(cfg).init(torch.Generator().manual_seed(1), "cpu"))
    got, st, step = checkpoint.restore(path, like, opt.init_state(like, opt.OptimizerConfig()))
    assert step == 3 and int(st.step) == 3
    for a, b in zip(opt.leaf_list(got), opt.leaf_list(params)):
        assert torch.equal(a, b)


# ------------------------------------------------------- guard and serving
def test_kernel_dispatch_refuses_inputs_that_need_a_gradient():
    """``impl="cuda"`` (what ``auto`` picks for a CUDA tensor) refuses an
    input that requires a gradient while grad mode is on: the kernels have
    no backward. Without grad mode the dispatch goes on to the wrapper
    (which refuses a CPU tensor for its own reason)."""
    x = torch.randn(4, 64, requires_grad=True)
    w = torch.ones(64)
    q = torch.randn(1, 3, 2, 32, requires_grad=True)
    calls = [lambda: ops.rmsnorm(x, w, impl="cuda"),
             lambda: ops.add_rmsnorm(x, x, w, impl="cuda"),
             lambda: ops.flash_attention(q, q, q, impl="cuda")]
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            with pytest.raises(Exception) as e:
                call()
            assert "no backward" not in str(e.value)
    assert ops.rmsnorm(x, w).requires_grad  # the CPU plain path differentiates


def test_trained_params_serve_again():
    """``train`` returns the reference's tree; ``layers.with_f32_table``
    gives the tied table its unembed copy back, and the params serve."""
    cfg = get_smoke_config("llama3.2-1b")
    stream = data.token_stream(cfg, batch=2, seq_len=8)
    with redirect_stdout(io.StringIO()):
        res = tl.train(cfg, data=stream, steps=2, device="cpu", log_every=1)
    assert "table_f32" not in res.params["embed"] and len(res.metrics_history) == 2
    served = L.with_f32_table(cfg, res.params)
    assert torch.equal(served["embed"]["table_f32"], res.params["embed"]["table"].float())
    out = engine.generate(get_model(cfg), served, torch.zeros((2, 4), dtype=torch.int32),
                          max_new_tokens=3)
    assert tuple(out["tokens"].shape) == (2, 3)
