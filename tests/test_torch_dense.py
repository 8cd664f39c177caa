"""The dense configs of the port against the JAX package: ``qwen2.5-3b``
(q/k/v bias), ``yi-34b`` (G = 7) and ``llama3-405b`` (G = 16 at D = 128).

- each config's ``CONFIG`` and ``SMOKE`` equal the reference's field by
  field, with the same ``n_params``; the smoke params' element count is
  that count;
- ``qwen2.5-3b-smoke`` in f32, the reference's init with non-zero random
  q/k/v biases (its own init makes them zero, which checks nothing),
  bridged: the biases cross the bridge, and the logits match the
  reference's in train, prefill, decode, verify and on a paged pool's
  decode, mixed and verify steps at atol 2e-5 / rtol 2e-4; AutoQuant keeps
  each bias beside its int8 weight, and the quantized model's logits match
  the reference's quantized model's at atol 1e-4 / rtol 1e-3 (the whole
  model tolerance of tests/test_torch_quant.py);
- ``yi-34b-smoke`` and ``llama3-405b-smoke`` served by the port's and the
  reference's ``Scheduler`` on the paged + chunked pool (which preempts)
  and on the contiguous one: the same tokens, finish order and host
  counts (steps, prefills, mixed steps, chunks, preemptions, peak blocks,
  occupancy), no block left owned."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS
from repro.configs import SMOKE_CONFIGS as JSMOKE
from repro.core import quantization as JQ
from repro.core.scheduler import Scheduler as JScheduler
from repro.core.scheduler import ServeRequest as JRequest
from repro.models import get_model as jget_model
from repro_torch import bridge
from repro_torch.configs import CONFIGS, SMOKE_CONFIGS
from repro_torch.core import prng
from repro_torch.core import quantization as Q
from repro_torch.core.kv_cache import leaves
from repro_torch.core.scheduler import Scheduler, ServeRequest
from repro_torch.models import get_model
from tests.test_torch_moe import ARMS, COUNTERS, _traffic, check_model_modes, close

ARCHS = ("qwen2.5-3b", "yi-34b", "llama3-405b")
F32 = dict(atol=2e-5, rtol=2e-4)
LOGITS = dict(atol=1e-4, rtol=1e-3)
MODES = ["prefill+decode", "verify", "paged decode", "paged mixed", "paged verify"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while the module runs: its serving loops are
    many tiny eager ops, which a thread pool only slows beside other test
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch, biases=False):
    """(JAX model, JAX params, port model, port params) of ``arch``'s f32
    smoke config, the reference's init bridged; with ``biases`` every
    attention bias is redrawn N(0, 0.5^2) from numpy first."""
    jcfg = JSMOKE[arch].replace(dtype="float32")
    jmodel = jget_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    if biases:
        rng = np.random.default_rng(5)

        def redraw(path, a):
            if jax.tree_util.keystr(path).endswith("['b']"):
                return jnp.asarray(0.5 * rng.standard_normal(a.shape), a.dtype)
            return a
        jparams = jax.tree_util.tree_map_with_path(redraw, jparams)
    tcfg = SMOKE_CONFIGS[arch].replace(dtype="float32")
    tparams = bridge.params_to_torch(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, get_model(tcfg), tparams


_PAIRS = {}


def pair_of(arch, biases=False):
    if (arch, biases) not in _PAIRS:
        _PAIRS[arch, biases] = _pair(arch, biases)
    return _PAIRS[arch, biases]


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    for port, ref in ((CONFIGS[arch], JCONFIGS[arch]), (SMOKE_CONFIGS[arch], JSMOKE[arch])):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.n_params() == ref.n_params()
        assert port.n_active_params() == ref.n_active_params()
    assert CONFIGS[arch].qkv_bias == (arch == "qwen2.5-3b")


def test_param_counts():
    """The published sizes: ~3.4 B, 34.39 B and 405.85 B parameters."""
    assert CONFIGS["qwen2.5-3b"].n_params() == 3_397_101_568
    assert CONFIGS["yi-34b"].n_params() == 34_388_910_080
    assert CONFIGS["llama3-405b"].n_params() == 405_853_372_416
    # the chip smoke's depth cut of llama3-405b: 4 layers, untied embed and head
    assert CONFIGS["llama3-405b"].replace(n_layers=4).n_params() == 16_953_507_840


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_params_count_and_bias(arch):
    cfg = SMOKE_CONFIGS[arch]
    params = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    # the reference's count leaves out the final norm's d_model scales
    assert sum(p.numel() for p in leaves(params)) == cfg.n_params() + cfg.d_model
    attn = params["layers"][0]["attn"]
    for name in ("wq", "wk", "wv"):
        assert ("b" in attn[name]) == cfg.qkv_bias
        if cfg.qkv_bias:
            assert attn[name]["b"].shape == (attn[name]["w"].shape[1],)
            assert attn[name]["b"].dtype == attn[name]["w"].dtype
            assert not attn[name]["b"].any()  # zero, as the reference inits it
    assert "b" not in attn["wo"]


# ---------------------------------------------------------- qwen2.5 bias
def test_bias_crosses_the_bridge():
    jmodel, jparams, model, params = pair_of("qwen2.5-3b", biases=True)
    for i, lp in enumerate(params["layers"]):
        jl = jparams["layers"][i]["attn"]
        for name in ("wq", "wk", "wv"):
            want = np.asarray(jl[name]["b"])
            assert np.abs(want).max() > 0.1
            np.testing.assert_array_equal(lp["attn"][name]["b"].numpy(), want)


@pytest.mark.parametrize("mode", MODES)
def test_qwen_bias_logits_match_jax(mode):
    check_model_modes(pair_of("qwen2.5-3b", biases=True), mode, F32)


def test_qwen_bias_changes_the_logits():
    """The biases reach the logits: the same model with them zeroed differs."""
    _, _, model, params = pair_of("qwen2.5-3b", biases=True)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 512, (2, 9)).astype(np.int32))
    zero = dict(params)
    zero["layers"] = [dict(lp, attn={k: (dict(v, b=torch.zeros_like(v["b"])) if "b" in v
                                         else v) for k, v in lp["attn"].items()})
                      for lp in params["layers"]]
    with torch.inference_mode():
        a = model.forward(params, {"tokens": toks}, mode="train")[0]
        b = model.forward(zero, {"tokens": toks}, mode="train")[0]
    assert float((a - b).abs().max()) > 1e-2


@pytest.mark.parametrize("tokens_per_step,mode", [(8, "wo"), (1024, "dyn")])
def test_autoquant_keeps_the_bias(tokens_per_step, mode):
    jmodel, jparams, model, params = pair_of("qwen2.5-3b", biases=True)
    qp, counts = Q.autoquant(params, tokens_per_step=tokens_per_step)
    jqp, jcounts = JQ.autoquant(jparams, tokens_per_step=tokens_per_step)
    assert counts == jcounts and counts[mode] > 0 and counts[{"wo": "dyn", "dyn": "wo"}[mode]] == 0
    for i, lp in enumerate(qp["layers"]):
        for name in ("wq", "wk", "wv", "wo"):
            p = lp["attn"][name]
            assert f"w_q_{mode}" in p and "w" not in p
            assert ("b" in p) == (name != "wo")
            if name != "wo":
                assert p["b"] is params["layers"][i]["attn"][name]["b"]
    toks = np.random.default_rng(4).integers(0, 512, (2, 9)).astype(np.int32)
    jl, _, _ = jmodel.forward(jqp, {"tokens": jnp.asarray(toks)}, mode="train")
    with torch.inference_mode():
        tl, _, _ = model.forward(qp, {"tokens": torch.from_numpy(toks)}, mode="train")
    close(tl, jl, LOGITS)


# --------------------------------------------------------- served tokens
@pytest.mark.parametrize("arm", ["chunked", "contiguous"])
@pytest.mark.parametrize("arch", ["yi-34b", "llama3-405b"])
def test_served_tokens_match_jax_scheduler(arch, arm):
    """Greedy requests of 3-8 prompt tokens and 3-8 new ones, all at t = 0,
    through both schedulers: exact tokens and host counts."""
    jmodel, jparams, model, params = pair_of(arch)
    _, _, geometry = ARMS[arm]
    kw = dict(slots=2, pad_to=8, max_new_cap=8, **geometry)
    traffic = _traffic(2, 6, [8, 3, 6, 5], model.config.vocab_size)
    js = JScheduler(jmodel, jparams, base_key=jax.random.PRNGKey(9), **kw)
    ts = Scheduler(model, params, device="cpu", base_key=prng.PRNGKey(9), **kw)
    jdone = js.run([JRequest(rid=i, prompt=p, max_new=m) for i, p, m in traffic])
    tdone = ts.run([ServeRequest(rid=i, prompt=p, max_new=m) for i, p, m in traffic])
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    for r, jr in zip(tdone, jdone):
        assert [int(x) for x in r.tokens] == [int(x) for x in jr.tokens], r.rid
        assert len(r.tokens) == r.max_new
    for name in COUNTERS:
        assert getattr(ts, name) == getattr(js, name), name
    if geometry.get("paged"):
        assert ts.n_preemptions >= 1 and ts.n_mixed_steps >= 1
        assert ts.pool.n_used_blocks == 0
        assert not ts.pool._ref.any()
