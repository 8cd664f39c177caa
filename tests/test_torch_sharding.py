"""Port's sharding rules (``repro_torch.distributed.sharding``) against the
JAX package's (``repro.distributed.sharding``), and the TP pool's
refusals.

- Spec parity, pure: for every registered config at full size (shapes
  from the port's init on the meta device, the reference's from
  ``abstract_params`` / ``abstract_cache``), ``param_specs`` (the
  size gate and ``enable_tp``), ``opt_state_specs``, ``cache_specs``,
  ``cache_specs_tp`` and ``cache_specs_seqsharded`` equal the reference's
  on the shape-only meshes of ``tests/test_tp.py`` (model 1, 2, 8, 13,
  16), leaf for leaf; ``batch_spec``, ``fsdp_upgrade`` and
  ``replica_devices`` too.
- Shards: ``shard_tree`` of the bridged f32 smoke llama at TP = 2 equals
  ``numpy.split`` of the reference's leaves along the reference's spec,
  every leaf, both ranks (the port's ``table_f32`` split as its table).
- Refusals: every family outside ``dense``, ``vlm``, ``moe`` and
  ``mla_moe``, and a width not divisible by ``tp`` (KV heads, experts, the
  shared experts' width, ``d_ff_dense``), raise naming the ROADMAP item; a
  rank's single KV head is not taken for MLA's latent.
- AutoQuant'd trees: ``w_q_*`` leaves split as their weights, ``w_scale``
  with a column-parallel leaf's columns and whole beside a row-parallel
  one; a rank's MoE / MLA widths (all experts kept in its config)."""
import dataclasses
import re

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import CONFIGS as JCONFIGS
from repro.configs import SMOKE_CONFIGS as JSMOKE
from repro.distributed import sharding as jsh
from repro.models import get_model as jget_model
from repro.training import optimizer as joptim
from repro_torch import bridge
from repro_torch.configs import CONFIGS, get_smoke_config
from repro_torch.distributed import sharding as sh
from repro_torch.distributed import tp_pool
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import get_model
from repro_torch.training import optimizer as optim


class FakeMesh:
    """Shape-only mesh (``tests/test_tp.py``'s), given to both packages."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {"model1": FakeMesh({"data": 4, "model": 1}),
          "model2": FakeMesh({"data": 1, "model": 2}),
          "model8": FakeMesh({"data": 2, "model": 8}),
          "model13": FakeMesh({"data": 1, "model": 13}),
          "model16": FakeMesh({"data": 16, "model": 16}),
          "pod": FakeMesh({"pod": 2, "data": 16, "model": 16})}


def _jflat(specs):
    """{path: spec as a tuple} of a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, P))
    return {jsh._path_str(path): tuple(s) for path, s in flat}


def _same(port, ref, extra=("embed/table_f32",)):
    """The port's spec tree equals the reference's leaf for leaf (the port's
    own serving leaves aside)."""
    got = {k: v for k, v in sh.flat_specs(port).items() if k not in extra}
    assert got == _jflat(ref)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def full(request):
    """(port config, port meta params, reference config, reference model,
    reference abstract params)."""
    name = request.param
    cfg = CONFIGS[name]
    with torch.device("meta"):
        params = get_model(cfg).init(None, "meta")
    jmodel = jget_model(JCONFIGS[name])
    return cfg, params, JCONFIGS[name], jmodel, jmodel.abstract_params()


def test_param_and_opt_specs_match_the_reference(full):
    """Every config: the size-gated and the serving (``enable_tp``) param
    specs, and the Adam state's, on every mesh."""
    cfg, params, jcfg, _, jparams = full
    opt = optim.init_state(params, optim.OptimizerConfig())
    # the reference's state by its structure: specs read shapes only
    jopt = joptim.AdamState(step=jax.ShapeDtypeStruct((), np.int32), mu=jparams, nu=jparams)
    for mesh in MESHES.values():
        for enable in (None, True):
            _same(sh.param_specs(cfg, params, mesh, enable_tp=enable),
                  jsh.param_specs(jcfg, jparams, mesh, enable_tp=enable))
            _same(sh.opt_state_specs(cfg, opt, mesh, enable_tp=enable),
                  jsh.opt_state_specs(jcfg, jopt, mesh, enable_tp=enable),
                  extra=("mu/embed/table_f32", "nu/embed/table_f32"))


def test_cache_specs_match_the_reference(full):
    """Every config with a cache: the batch rule, the TP pool's head axis
    (with its sequence fallback) and the sequence-split variant, on every
    mesh, at two batch sizes; HSTU's cache refused by both."""
    cfg, _, jcfg, jmodel, _ = full
    if not jcfg.is_autoregressive:  # HSTU: no cache in either package
        with pytest.raises(NotImplementedError):
            get_model(cfg).init_cache(4, 64, "meta")
        with pytest.raises(NotImplementedError):
            jmodel.abstract_cache(4, 64)
        return
    for batch, max_len in ((4, 64), (128, 32768)):
        cache = get_model(cfg).init_cache(batch, max_len, "meta")
        jcache = jmodel.abstract_cache(batch, max_len)
        for mesh in MESHES.values():
            for fn in ("cache_specs", "cache_specs_tp", "cache_specs_seqsharded"):
                _same(getattr(sh, fn)(cfg, cache, mesh, batch),
                      getattr(jsh, fn)(jcfg, jcache, mesh, batch))


def test_fsdp_upgrade_matches_the_reference(full):
    cfg, params, jcfg, _, jparams = full
    mesh = MESHES["model16"]
    for axes in (("data",), ("data", "model")):
        _same(sh.fsdp_upgrade(cfg, params, sh.param_specs(cfg, params, mesh), mesh, axes),
              jsh.fsdp_upgrade(jcfg, jparams, jsh.param_specs(jcfg, jparams, mesh), mesh,
                               axes))


@pytest.mark.parametrize("batch", [1, 3, 16, 32])
def test_batch_spec_matches_the_reference(batch):
    for mesh in MESHES.values():
        for rank in (1, 2, 3):
            for include_model in (False, True):
                assert sh.batch_spec(mesh, batch, rank, include_model) == tuple(
                    jsh.batch_spec(mesh, batch, rank, include_model))
        assert sh.data_axes(mesh) == jsh.data_axes(mesh)


@pytest.mark.parametrize("n,group_size", [(2, 2), (3, 2), (4, 1), (2, 1), (5, 3)])
def test_replica_devices_match_the_reference(n, group_size):
    """Whole groups round-robin, never a partial overlap
    (``tests/test_tp.py:141-165``)."""
    devs = ["d0", "d1", "d2", "d3"]
    assert sh.replica_devices(n, devs, group_size=group_size) == jsh.replica_devices(
        n, devs, group_size=group_size)
    with pytest.raises(ValueError):
        sh.replica_devices(1, ["d0"], group_size=2)
    with pytest.raises(ValueError):
        sh.replica_devices(1, [])


@pytest.fixture(scope="module")
def smoke():
    """The reference's f32 smoke llama (numpy leaves) and the port's
    bridged params."""
    jcfg = JSMOKE["llama3.2-1b"].replace(dtype="float32")
    jmodel = jget_model(jcfg)
    jparams = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    cfg = get_smoke_config("llama3.2-1b").replace(dtype="float32")
    return cfg, jcfg, jmodel, jparams, bridge.params_to_torch(cfg, jparams, "cpu")


@pytest.mark.parametrize("rank", [0, 1])
def test_shard_tree_is_numpy_split_along_the_reference_spec(smoke, rank):
    cfg, jcfg, jmodel, jparams, params = smoke
    jspecs = _jflat(jsh.param_specs(jcfg, jmodel.abstract_params(), MESHES["model2"],
                                    enable_tp=True))
    shard = sh.flat_specs(sh.map_with_path(
        lambda path, leaf: (leaf.numpy(),),
        sh.shard_tree(params, sh.tp_param_specs(cfg, params, 2), rank, 2)))
    flat_ref = sh.flat_specs(sh.map_with_path(lambda path, leaf: (leaf,), jparams))
    assert set(shard) == set(flat_ref)
    n_split = 0
    for path, (got,) in shard.items():
        spec, want = jspecs[path], flat_ref[path][0]
        if "model" in spec:
            want = np.split(want, 2, axis=spec.index("model"))[rank]
            n_split += 1
        np.testing.assert_array_equal(got, want, err_msg=path)
    assert n_split == 1 + 7 * cfg.n_layers  # the table and 7 linears a layer


def test_shard_tree_slices_the_f32_table_copy():
    """A bf16 tied table's f32 unembed copy is split as its table: the
    rank's slice of the copy is the copy of the rank's slice."""
    cfg = get_smoke_config("llama3.2-1b")
    params = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    specs = sh.tp_param_specs(cfg, params, 2)
    assert sh.flat_specs(specs)["embed/table_f32"] == ("model", None)
    for rank in (0, 1):
        embed = sh.shard_tree(params, specs, rank, 2)["embed"]
        assert embed["table"].shape == (cfg.vocab_size // 2, cfg.d_model)
        assert torch.equal(embed["table_f32"], embed["table"].float())


def test_tp_param_specs_split_qkv_biases_with_their_columns():
    """qwen2.5-3b's 1-D q/k/v biases: whole in the reference's rules, split
    with their weight's columns in the port's serving specs."""
    cfg = CONFIGS["qwen2.5-3b"]
    with torch.device("meta"):
        params = get_model(cfg).init(None, "meta")
    flat = sh.flat_specs(sh.tp_param_specs(cfg, params, 2))
    for name in ("wq", "wk", "wv"):
        assert flat[f"layers/0/attn/{name}/b"] == ("model",)
        assert flat[f"layers/0/attn/{name}/w"] == (None, "model")
    assert sh.flat_specs(sh.param_specs(cfg, params, MESHES["model2"],
                                        enable_tp=True))["layers/0/attn/wq/b"] == ()


@pytest.mark.parametrize("arch", sorted(a for a, c in CONFIGS.items()
                                        if c.family not in tp_pool.FAMILIES))
def test_tp_refuses_other_families_by_name(arch):
    cfg = get_smoke_config(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1, step 6"):
        tp_pool.check_supported(cfg, 2)


@pytest.mark.parametrize("arch", sorted(a for a, c in CONFIGS.items()
                                        if c.family in tp_pool.FAMILIES))
def test_tp_serves_the_transformer_families(arch):
    """Every dense, vlm, moe, mla_moe, ssm, encdec, seamless and hybrid
    config splits at TP = 2, published and smoke widths alike (whisper-base's
    odd vocabulary stays whole)."""
    tp_pool.check_supported(CONFIGS[arch], 2)
    tp_pool.check_supported(get_smoke_config(arch), 2)


@pytest.mark.parametrize("arch,field,value,what", [
    ("qwen3-moe-30b-a3b", "n_experts", 5, "moe.n_experts = 5"),
    ("deepseek-v2-236b", "n_experts", 7, "moe.n_experts = 7"),
    ("deepseek-v2-236b", "d_ff_expert", 129, "the shared experts' width = 129"),
    ("deepseek-v2-236b", "d_ff_dense", 511, "moe.d_ff_dense = 511"),
])
def test_tp_refuses_moe_widths_that_do_not_split(arch, field, value, what):
    """An expert count, shared width or dense-layer width that does not
    split over the ranks: the reference's ``_spec_for`` would replicate it."""
    cfg = get_smoke_config(arch)
    bad = cfg.replace(moe=dataclasses.replace(cfg.moe, **{field: value}))
    tp_pool.check_supported(cfg, 2)
    with pytest.raises(NotImplementedError, match=f"{re.escape(what)} does not split.*ROADMAP"):
        tp_pool.check_supported(bad, 2)


def test_tp_refuses_kv_heads_that_do_not_split():
    cfg = get_smoke_config("llama3.2-1b").replace(dtype="float32")  # 2 KV heads
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="n_kv_heads = 2 does not split"):
        tp_pool.TPContext(model, params, tp_pool.TPGroup(0, 4, "cpu"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tp_pool.check_supported(cfg.replace(n_kv_heads=1), 2)


@pytest.mark.parametrize("mode", ["wo", "dyn"])
def test_tp_autoquant_shard_specs(mode):
    """AutoQuant'd leaves under the serving specs: ``w_q_*`` as its weight
    (the reference's rules), ``w_scale`` [N] with a column-parallel leaf's
    columns and whole beside a row-parallel one (the reference keeps every
    1-D leaf whole); each rank's slice is the whole tree's codes cut."""
    from repro_torch.core.quantization import quantize_params

    cfg = get_smoke_config("llama3.2-1b").replace(dtype="float32")
    params = quantize_params(get_model(cfg).init(torch.Generator().manual_seed(0), "cpu"),
                             mode)
    flat = sh.flat_specs(sh.tp_param_specs(cfg, params, 2))
    q = f"w_q_{mode}"
    for name in ("attn/wq", "attn/wk", "attn/wv", "ffn/w1", "ffn/w3"):
        assert flat[f"layers/0/{name}/{q}"] == (None, "model")
        assert flat[f"layers/0/{name}/w_scale"] == ("model",)
    for name in ("attn/wo", "ffn/w2"):
        assert flat[f"layers/0/{name}/{q}"] == ("model", None)
        assert flat[f"layers/0/{name}/w_scale"] == ()
    ref = sh.flat_specs(sh.param_specs(cfg, params, MESHES["model2"], enable_tp=True))
    assert ref["layers/0/attn/wq/w_scale"] == ()
    for rank in (0, 1):
        ffn = sh.shard_tree(params, sh.tp_param_specs(cfg, params, 2), rank, 2)[
            "layers"][0]["ffn"]
        whole = params["layers"][0]["ffn"]
        n = cfg.d_ff // 2
        assert torch.equal(ffn["w1"][q], whole["w1"][q][:, rank * n:(rank + 1) * n])
        assert torch.equal(ffn["w1"]["w_scale"], whole["w1"]["w_scale"][rank * n:(rank + 1) * n])
        assert torch.equal(ffn["w2"][q], whole["w2"][q][rank * n:(rank + 1) * n])
        assert torch.equal(ffn["w2"]["w_scale"], whole["w2"]["w_scale"])


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "deepseek-v2-236b"])
def test_rank_context_keeps_every_expert(arch):
    """A MoE rank's config keeps all ``n_experts`` (the router, top-k and
    capacity are the whole model's) while its params hold E / tp experts;
    deepseek's dense first layer runs at ``d_ff_dense / tp`` and its MLA
    at the rank's heads over the whole latent."""
    cfg = get_smoke_config(arch).replace(dtype="float32")
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tp = tp_pool.TPContext(model, params, tp_pool.TPGroup(1, 2, "cpu"))
    local, m = tp.model.config, cfg.moe
    assert local.moe.n_experts == m.n_experts and local.n_heads == cfg.n_heads // 2
    moe = tp.params["layers"][m.first_dense_layers]["moe"]
    assert moe["w1"].shape[0] == m.n_experts // 2
    assert torch.equal(moe["w1"], params["layers"][m.first_dense_layers]["moe"]["w1"][
        m.n_experts // 2:])
    if cfg.mla is not None:
        assert local.moe.d_ff_dense == m.d_ff_dense // 2
        assert tp.params["layers"][0]["ffn"]["w1"]["w"].shape[1] == m.d_ff_dense // 2
        cache = tp.model.init_cache(3, 16, "cpu")
        assert cache["layers"][0]["latent"].shape == (
            3, 16, cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim)


def test_rank_context_widths_and_shapes():
    """A rank's local config and param shapes at TP = 2 (no process group:
    construction issues no collective)."""
    cfg = get_smoke_config("llama3.2-1b").replace(dtype="float32")
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tp = tp_pool.TPContext(model, params, tp_pool.TPGroup(1, 2, "cpu"))
    local = tp.model.config
    assert (local.n_heads, local.n_kv_heads, local.d_ff, local.head_dim) == (
        cfg.n_heads // 2, cfg.n_kv_heads // 2, cfg.d_ff // 2, cfg.head_dim)
    attn = tp.params["layers"][0]["attn"]
    assert attn["wq"]["w"].shape == (cfg.d_model, cfg.d_model // 2)
    assert attn["wo"]["w"].shape == (cfg.d_model // 2, cfg.d_model)
    assert tp.params["embed"]["table"].shape == (cfg.vocab_size // 2, cfg.d_model)
    cache = tp.model.init_cache(3, 16, "cpu")
    assert cache["layers"][0]["k"].shape == (3, 16, cfg.n_kv_heads // 2, cfg.head_dim)


def test_a_ranks_single_kv_head_is_not_the_latent():
    """At the smoke widths TP = 2 leaves one KV head a rank, V its own
    tensor: the wrappers' ``is_latent`` must not take it for MLA's."""
    k = torch.zeros(2, 16, 1, 32)
    assert not fa.is_latent(k, torch.zeros(2, 16, 1, 32))
    assert not fa.is_latent(k, k)
    latent = torch.zeros(2, 16, 1, 96)
    assert fa.is_latent(latent, latent[..., :64])
