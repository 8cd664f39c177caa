"""AutoQuant over every family: the port's ``quantize_params`` and its
quantized forward against the reference's, on the f32 smoke configs of
qwen3-moe, deepseek-v2, mamba2, recurrentgemma and chameleon (the dense
llama is ``test_torch_quant.py``'s), in both modes (``wo``: weight-only;
``dyn``: dynamic per-row activation quantization). Params come from the
reference's ``init(PRNGKey(0))``, bridged; tokens from numpy.

The quantized trees must be equal element for element, and the ``train``
mode logits equal at the whole-model tolerance (atol 1e-4 / rtol 1e-3).
Under ``dyn`` one upstream ulp can move an activation across a rounding
boundary of its int8 code (x / x_scale at k + 0.5), and that one code moves
every later position of its row (chameleon's smoke config, 2 of 6 draws:
-5.4999948 in the reference against -5.5000067 in the port, 9.5e-7 apart
upstream). So a ``dyn`` run whose logits differ is run again with every
code that differs from the reference's replaced by the reference's, each
such code accepted only where the reference's x / x_scale lies within
FLIP of k + 0.5, and then the logits must agree; each flip is reported.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_CONFIGS
from repro.core import quantization as JQ
from repro.kernels import ops as jops
from repro.models import get_model as jget_model
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core import quantization as Q
from repro_torch.kernels import ops
from repro_torch.models import get_model

LOGITS = dict(atol=1e-4, rtol=1e-3)
#: the most a flipped code's reference x / x_scale may lie from k + 0.5
FLIP = 1e-4
ARCHS = ["qwen3-moe-30b-a3b", "deepseek-v2-236b", "mamba2-130m", "recurrentgemma-2b",
         "chameleon-34b"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _paths(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _paths(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(reference model, its params from PRNGKey(0), port model, the params
    bridged) of ``arch``'s f32 smoke config, shared by both modes."""
    jcfg = SMOKE_CONFIGS[arch].replace(dtype="float32")
    jmodel = jget_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = get_smoke_config(arch).replace(dtype="float32")
    np_params = jax.tree.map(np.asarray, jparams)
    return jmodel, jparams, get_model(tcfg), bridge.params_to_torch(tcfg, np_params, "cpu")


def _ratios(x: np.ndarray) -> np.ndarray:
    """x / x_scale per row in f32, the reference's formula."""
    x = x.astype(np.float32).reshape(-1, x.shape[-1])
    return x / (np.maximum(np.abs(x).max(-1, keepdims=True), np.float32(1e-8)) / np.float32(127))


@pytest.mark.parametrize("mode", ["wo", "dyn"])
@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_forward_matches_jax_on_every_family(arch, mode, monkeypatch):
    jmodel, jparams, tmodel, tparams = _pair(arch)
    jcfg, tcfg = jmodel.config, tmodel.config
    tq = Q.quantize_params(tparams, mode)
    jq = JQ.quantize_params(jparams, mode)
    bridged = _paths(bridge.params_to_torch(tcfg, jax.tree.map(np.asarray, jq), "cpu"))
    own = _paths(tq)
    assert set(own) == set(bridged) and any(f"w_q_{mode}" in k for k in own)
    for name, v in bridged.items():
        assert own[name].dtype == v.dtype and torch.equal(own[name], v), name

    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    jlog = np.asarray(jax.jit(lambda p, t: jmodel.forward(p, {"tokens": t}, mode="train")[0])(
        jq, jnp.asarray(tokens)))
    with torch.inference_mode():
        tlog = tmodel.forward(tq, {"tokens": torch.from_numpy(tokens)}, mode="train")[0]
    if np.allclose(tlog.numpy(), jlog, **LOGITS):
        return
    assert mode == "dyn", f"{arch} {mode}: max |dlogit| {np.abs(tlog.numpy() - jlog).max()}"

    # the reference again, eagerly, its activations at each dynamic GEMM kept
    seen = []
    real = jops.int8_matmul_dynamic

    def spy(x, *a, **kw):
        seen.append(np.asarray(x))
        return real(x, *a, **kw)
    monkeypatch.setattr(jops, "int8_matmul_dynamic", spy)
    eager = np.asarray(jmodel.forward(jq, {"tokens": jnp.asarray(tokens)}, mode="train")[0])
    np.testing.assert_allclose(eager, jlog, **LOGITS)

    # again, every int8 code that differs from the reference's taken from it,
    # each only at a rounding boundary of the reference's x / x_scale
    flips, calls = [], iter(range(len(seen)))
    real_rows = ops.quantize_rows

    def forced(x, amax_reduce=None):
        x_q, x_scale = real_rows(x, amax_reduce)
        i = next(calls)
        ref = _ratios(seen[i])
        ref_q = np.clip(np.round(ref), -127, 127).astype(np.int8)
        mine = x_q.reshape(-1, x_q.shape[-1]).numpy()
        for r, c in np.argwhere(mine != ref_q):
            dist = abs(abs(float(ref[r, c])) % 1.0 - 0.5)
            assert dist < FLIP, (f"{arch}: call {i} row {r} col {c}: code {mine[r, c]} against "
                                 f"the reference's {ref_q[r, c]} away from a rounding "
                                 f"boundary (x / x_scale {ref[r, c]!r})")
            flips.append((i, int(r), int(c), float(ref[r, c]), dist))
        return torch.from_numpy(ref_q).reshape(x_q.shape), x_scale
    monkeypatch.setattr(ops, "quantize_rows", forced)
    with torch.inference_mode():
        tlog = tmodel.forward(tq, {"tokens": torch.from_numpy(tokens)}, mode="train")[0]
    assert flips, f"{arch} dyn: the logits differ but no int8 code does"
    np.testing.assert_allclose(tlog.numpy(), jlog, **LOGITS)
    for i, r, c, ratio, dist in flips:
        print(f"[{arch} dyn] int8 code flipped at a rounding boundary: GEMM {i}, token "
              f"{r // tokens.shape[1]}/{r % tokens.shape[1]}, column {c}, the reference's "
              f"x / x_scale {ratio!r} ({dist:.2e} from k + 0.5)")
