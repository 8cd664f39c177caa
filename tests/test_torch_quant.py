"""AutoQuant in the port vs the JAX package: ``ops.quantize_int8``, the
two int8 GEMMs' plain versions and dispatch, ``core/quantization.py``
(roofline choice, ``autoquant`` walk, ``quantize_params``), the bridge of
quantized trees, and the quantized llama3.2-1b smoke model through the
forward pass, greedy ``generate`` and the ``Scheduler``. The same numpy
inputs (or the reference's ``init(PRNGKey(0))`` params, bridged) go to
both sides.

Tolerances: kernels as in tests/test_kernels.py (f32 atol 2e-5 / rtol
2e-4, bf16 atol = rtol = 2e-2); whole-model logits as in
test_torch_model.py (atol 1e-4 / rtol 1e-3); tokens exact up to a
reference near tie (top-1/top-2 gap < 1e-4), as in test_torch_serve.py.
On the CPU no kernel launches: every wrapper takes its plain version, and
``impl="cuda"`` raises."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_CONFIGS
from repro.core import engine as jengine
from repro.core import quantization as JQ
from repro.core import sampling as jsampling
from repro.core.scheduler import Scheduler as JScheduler
from repro.core.scheduler import ServeRequest as JRequest
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import get_model as jget_model
from repro.models import layers as jL
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core import engine
from repro_torch.core import quantization as Q
from repro_torch.core.scheduler import Scheduler, ServeRequest
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import int8_matmul as im
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rn
from repro_torch.models import get_model
from repro_torch.models import layers as L

ARCH = "llama3.2-1b"
F32 = dict(atol=2e-5, rtol=2e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)
LOGITS = dict(atol=1e-4, rtol=1e-3)
NEAR_TIE = 1e-4
PAD_TO = 8
SHAPES = [(8, 32, 16), (37, 100, 53), (128, 256, 64)]


def _counts():
    return (rn.LAUNCHES, fa.LAUNCHES, da.LAUNCHES, im.LAUNCHES_WO, im.LAUNCHES_DYN)


@pytest.fixture(autouse=True)
def no_launches():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    before = _counts()
    yield
    assert _counts() == before == (0, 0, 0, 0, 0)


def t(a):
    return torch.from_numpy(np.array(a))


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close(got, want, tol):
    np.testing.assert_allclose(f32(got), f32(want), **tol)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _paths(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _paths(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _pair(dtype="float32", scan=False, seed=0):
    jcfg = SMOKE_CONFIGS[ARCH].replace(dtype=dtype, scan_layers=scan)
    jmodel = jget_model(jcfg)
    np_params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    tcfg = get_smoke_config(ARCH).replace(dtype=dtype)
    return jcfg, jmodel, np_params, tcfg, get_model(tcfg)


@pytest.fixture(scope="module")
def quantized():
    """mode -> (jmodel, reference-quantized params, port model, bridged)."""
    _, jmodel, np_params, tcfg, tmodel = _pair()
    out = {}
    for mode in ("wo", "dyn"):
        jq = JQ.quantize_params(jax.tree.map(jnp.asarray, np_params), mode)
        tq = bridge.params_to_torch(tcfg, jax.tree.map(np.asarray, jq), "cpu")
        out[mode] = (jmodel, jq, tmodel, tq)
    return out


# ------------------------------------------------------------ quantize_int8
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,axis", [((64, 48), 0), ((3, 64, 48), 1)])
def test_quantize_int8_bit_identical(shape, axis, dtype):
    w = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32)
    w[..., 5] = 0.0  # an all-zero channel takes the 1e-8 floor
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jq, js = jops.quantize_int8(jnp.asarray(w).astype(jd), axis=axis)
    tq, ts = ops.quantize_int8(t(w).to(td), axis=axis)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# ------------------------------------------------------------- int8 GEMMs
def _operands(m, k, n):
    rng = np.random.default_rng(m * 7 + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    wq, ws = (np.asarray(a) for a in jops.quantize_int8(jnp.asarray(w), axis=0))
    return x, wq, ws


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_int8_weight_only_matches_jax(m, k, n, name):
    x, wq, ws = _operands(m, k, n)
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[name]
    tol = F32 if name == "float32" else BF16
    xj, xt = jnp.asarray(x).astype(jd), t(x).to(td)
    want = jref.int8_matmul_ref(xj, jnp.asarray(wq), jnp.asarray(ws))
    pallas = jops.int8_matmul_weight_only(xj, jnp.asarray(wq), jnp.asarray(ws), impl="pallas")
    wqt, wst = t(wq), t(ws)
    ported = {
        "ref": ref.int8_matmul_ref(xt, wqt, wst),
        "plain": im.int8_matmul_weight_only_plain(xt, wqt, wst),
        "ops-auto": ops.int8_matmul_weight_only(xt, wqt, wst),
        "ops-torch": ops.int8_matmul_weight_only(xt, wqt, wst, impl="torch"),
    }
    for label, got in ported.items():
        assert got.dtype == td and got.shape == (m, n), label
        close(got, want, tol)
        close(got, pallas, tol)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_int8_dynamic_matches_jax(m, k, n):
    """Activation quantization bit for bit, the plain version exactly equal
    to the integer oracle, and the f32 outputs against the reference's
    Pallas kernel (interpret mode) and oracle."""
    x, wq, ws = _operands(m, k, n)
    xj, xt = jnp.asarray(x), t(x)
    wqj, wsj, wqt, wst = jnp.asarray(wq), jnp.asarray(ws), t(wq), t(ws)
    amax = jnp.max(jnp.abs(xj), axis=-1, keepdims=True)
    jxs = jnp.maximum(amax, 1e-8) / 127.0
    jxq = jnp.clip(jnp.round(xj / jxs), -127, 127).astype(jnp.int8)
    pallas = jops.int8_matmul_dynamic(xj, wqj, wsj, impl="pallas")
    want = jops.int8_matmul_dynamic(xj, wqj, wsj, impl="ref")

    txq, txs = ops.quantize_rows(xt)
    assert txs.shape == (m, 1)
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(txs.numpy(), np.asarray(jxs))
    plain = im.int8_matmul_dynamic_plain(txq, wqt, wst, txs)
    np.testing.assert_array_equal(plain.numpy(), ref.int8_matmul_ref(txq, wqt, wst, txs).numpy())
    np.testing.assert_array_equal(
        plain.numpy(), np.asarray(jref.int8_matmul_ref(jxq, wqj, wsj, x_scale=jxs)))
    for label, got in {"plain": plain, "ops-auto": ops.int8_matmul_dynamic(xt, wqt, wst),
                       "ops-torch": ops.int8_matmul_dynamic(xt, wqt, wst, impl="torch")}.items():
        assert got.dtype == torch.float32 and got.shape == (m, n), label
        close(got, want, F32)
        close(got, pallas, F32)


@pytest.mark.parametrize("kernel", ["weight_only", "dynamic"])
def test_int8_cuda_impl_on_cpu_tensor_raises(kernel):
    x, wq, ws = (t(a) for a in _operands(8, 32, 16))
    xq = torch.zeros((8, 32), dtype=torch.int8)
    calls = {
        "weight_only": [lambda: ops.int8_matmul_weight_only(x, wq, ws, impl="cuda"),
                        lambda: im.int8_matmul_weight_only_cuda(x, wq, ws)],
        "dynamic": [lambda: ops.int8_matmul_dynamic(x, wq, ws, impl="cuda"),
                    lambda: im.int8_matmul_dynamic_cuda(xq, wq, ws, torch.ones(8, 1))],
    }
    for call in calls[kernel]:
        with pytest.raises(ValueError, match="CUDA"):
            call()


@pytest.mark.parametrize("m,k,n", [(8, 2048, 2048), (8, 2048, 512), (8, 8192, 2048),
                                   (256, 2048, 8192), (37, 100, 53), (8, 300, 100), (1, 0, 4)])
def test_split_k_plan_covers_k(m, k, n):
    """The kernels' K split: whole 128-row chunks covering K, none empty,
    and no split once the M x N tiles reach two blocks per SM."""
    splits, chunk = im.split_k(m, n, k, 132)
    assert splits >= 1 and chunk % 128 == 0 and chunk > 0
    assert splits * chunk >= k and (splits - 1) * chunk < max(k, 1)
    tiles = -(-n // 128) * -(-m // 8)
    if tiles >= 2 * 132:
        assert splits == 1
    assert im.split_k(8, 2048, 2048, 132) == (16, 128)


LLAMA_LINEARS = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)]  # (K, N)


@pytest.mark.parametrize("m,k,n", [(m, k, n) for m in (8, 256) for k, n in LLAMA_LINEARS]
                         + [(1, 2048, 2048), (37, 100, 53), (8, 300, 100), (128, 256, 64),
                            (48, 200, 96), (17, 64, 4096), (300, 0, 64)])
def test_dynamic_split_covers_k(m, k, n):
    """The dynamic (tensor-core) kernel's K split, at the served decode
    (M = 8) and prefill (M = 256) linears and edge shapes: chunks of whole
    64-byte stages that cover every K row exactly once, none empty, at
    least 4 stages each, and no split once the 64 x 128 tiles fill the
    SMs."""
    splits, chunk = im.split_k_dynamic(m, n, k, 132)
    assert splits >= 1 and chunk % 64 == 0 and chunk > 0
    covered = np.zeros(k, np.int64)
    for z in range(splits):
        lo = z * chunk
        assert lo < k or k == 0  # no empty split
        covered[lo:min(k, lo + chunk)] += 1
    assert (covered == 1).all()
    if -(-n // 128) * -(-m // 64) >= 132:
        assert splits == 1
    if k:
        assert chunk >= min(256, -(-k // 64) * 64)
    assert im.split_k_dynamic(256, 8192, 2048, 132) == (1, 2048)
    assert im.split_k_dynamic(8, 8192, 2048, 132) == (3, 704)


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(m, k, n) for m in (8, 256) for k, n in LLAMA_LINEARS]
                         + [(1, 2048, 2048), (37, 100, 53), (8, 300, 100), (128, 256, 64),
                            (16, 200, 96), (17, 64, 4096), (300, 0, 64)])
def test_weight_only_plan_covers_k(m, k, n, name):
    """The weight-only route and K split: f32 x on the CUDA-core template
    (8-row tiles, whole 128-row chunks), bf16 x on the tensor cores
    (16-row tiles up to 16 rows, 64-row tiles above; chunks of whole
    64-element stages, at least 2 each for 16-row tiles and 4 for 64-row
    tiles, no split once the tiles reach two blocks per SM or one);
    every K row covered exactly once, no split empty."""
    dtype = torch.float32 if name == "float32" else torch.bfloat16
    tile_m, splits, chunk = im.plan_weight_only(m, n, k, dtype, 132)
    want_tile = 8 if name == "float32" else (16 if m <= 16 else 64)
    assert tile_m == want_tile and (tile_m, splits, chunk) == (
        tile_m, *im.split_k_weight_only(m, n, k, 132, tile_m))
    step = 128 if tile_m == 8 else 64
    assert splits >= 1 and chunk % step == 0 and chunk > 0
    covered = np.zeros(k, np.int64)
    for z in range(splits):
        lo = z * chunk
        assert lo < k or k == 0  # no empty split
        covered[lo:min(k, lo + chunk)] += 1
    assert (covered == 1).all()
    if tile_m != 8:
        per_sm, stages = (2, 2) if tile_m == 16 else (1, 4)
        if -(-n // 128) * -(-m // tile_m) >= per_sm * 132:
            assert splits == 1
        if k:
            assert chunk >= min(64 * stages, -(-k // 64) * 64)
    assert im.plan_weight_only(256, 8192, 2048, torch.bfloat16, 132) == (64, 1, 2048)
    assert im.plan_weight_only(256, 2048, 8192, torch.bfloat16, 132) == (64, 3, 2752)
    assert im.plan_weight_only(8, 2048, 2048, torch.float32, 132) == (8, 16, 128)
    assert im.plan_weight_only(8, 8192, 2048, torch.bfloat16, 132) == (16, 5, 448)


def test_weight_only_route_matches_the_c_entry():
    """The wrapper plans its K split for the route the C entry launches:
    both take it from x's type and M, with one small-M bound
    (``WO_SMALL_M`` here, ``kWoSmallM`` in the source)."""
    src = (Path(im.__file__).parent / "csrc" / "int8_matmul.cu").read_text()
    bound = re.search(r"constexpr int kWoSmallM = (\d+);", src)
    assert bound is not None and int(bound.group(1)) == im.WO_SMALL_M
    small = im.WO_SMALL_M
    assert [im.wo_tile_m(m, torch.bfloat16) for m in (1, small, small + 1, 256)] == [
        16, 16, 64, 64]
    assert {im.wo_tile_m(m, torch.float32) for m in (1, small, small + 1, 256)} == {8}


def _dequant8(chunk: np.ndarray) -> np.ndarray:
    """The tensor-core weight-only kernel's int8 -> bf16 step in numpy, on
    16 int8 weights: each little-endian word is sign-flipped (^ 0x80808080),
    byte j is placed in the mantissa of 2^23 (0x4B0000jj), 2^23 + 128 is
    subtracted in f32, and each pair is rounded to bf16 (to nearest even),
    the lower column in the lower half. Returns the 16 bf16 bit patterns in
    column order."""
    words = chunk.view(np.uint32) ^ np.uint32(0x80808080)
    out = []
    for wd in words:
        for j in range(4):
            f = ((wd >> np.uint32(8 * j)) & np.uint32(0xFF)) | np.uint32(0x4B000000)
            val = np.array([f], np.uint32).view(np.float32)[0] - np.float32(8388736.0)
            out.append(torch.tensor([float(val)], dtype=torch.float32).to(torch.bfloat16))
    return torch.cat(out).view(torch.int16).numpy()


def test_int8_to_bf16_conversion_is_exact():
    """Every one of the 256 byte values comes out of the kernel's
    conversion as exactly its own value in bf16 (and so in f32), in column
    order: a bf16 x bf16 product is then exact in f32, and the tensor-core
    result differs from the f32 dot only in the order of its sum."""
    values = np.arange(-128, 128, dtype=np.int8)
    got = np.concatenate([_dequant8(values[i:i + 16].copy()) for i in range(0, 256, 16)])
    got_f = torch.from_numpy(got).view(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got_f, values.astype(np.float32))
    want = torch.from_numpy(values.astype(np.float32)).to(torch.bfloat16).view(torch.int16)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("m,k,n", [(256, 512, 192), (8, 300, 100)])
def test_weight_only_tensor_core_order_fits_the_tolerance(m, k, n):
    """The bf16 tensor-core kernel's arithmetic in plain torch (bf16 x,
    weights dequantized exactly to bf16, f32 sums per 64-deep stage and per
    K split of its plan, the split sums added in split order, the scale in
    the f32 epilogue, then bf16) against the JAX package's Pallas kernel
    (interpret) and oracle at the bf16 tolerance."""
    x, wq, ws = _operands(m, k, n)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = t(x).to(torch.bfloat16)
    tile_m, splits, chunk = im.plan_weight_only(m, n, k, torch.bfloat16, 132)
    wb = t(wq).to(torch.bfloat16).float()
    total = torch.zeros((m, n))
    for z in range(splits):
        part = torch.zeros((m, n))
        for k0 in range(z * chunk, min(k, (z + 1) * chunk), 64):
            part = part + xt[:, k0:k0 + 64].float() @ wb[k0:k0 + 64]
        total = total + part
    got = (total * t(ws)).to(torch.bfloat16)
    for want in (jops.int8_matmul_weight_only(xj, jnp.asarray(wq), jnp.asarray(ws),
                                              impl="pallas"),
                 jref.int8_matmul_ref(xj, jnp.asarray(wq), jnp.asarray(ws)),
                 im.int8_matmul_weight_only_plain(xt, t(wq), t(ws))):
        close(got, want, BF16)


# -------------------------------------------------------- mode selection
def test_roofline_mode_uses_the_h100_ridge():
    assert Q.RIDGE_TOKENS == pytest.approx(989e12 / 3.35e12 / 2)
    for tokens in (1, 8, 4096):
        assert Q.roofline_mode(tokens) == JQ.roofline_mode(tokens)
    assert (Q.roofline_mode(147), Q.roofline_mode(148)) == ("wo", "dyn")
    differ = [n for n in range(1, 4097) if Q.roofline_mode(n) != JQ.roofline_mode(n)]
    assert differ == list(range(121, 148))  # the reference's v5e ridge is ~120.3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tokens", [4, 256])
def test_autoquant_counts_and_keys_match_reference(tokens, dtype):
    """Same counts (7 linears per layer; the tied table and the port's
    ``embed.table_f32`` are skipped) and the same tree paths as bridging
    the reference's AutoQuant'd tree."""
    jcfg, _, np_params, tcfg, _ = _pair(dtype)
    jq, jcounts = JQ.autoquant(jax.tree.map(jnp.asarray, np_params), tokens_per_step=tokens)
    tq, tcounts = Q.autoquant(bridge.params_to_torch(tcfg, np_params, "cpu"),
                              tokens_per_step=tokens)
    assert tcounts == jcounts
    assert sum(tcounts.values()) == tcounts[Q.roofline_mode(tokens)] == 7 * jcfg.n_layers
    bridged = bridge.params_to_torch(tcfg, jax.tree.map(np.asarray, jq), "cpu")
    assert set(_paths(tq)) == set(_paths(bridged))
    assert "table" in tq["embed"] and "scale" in tq["final_norm"]
    assert f"w_q_{Q.roofline_mode(tokens)}" in tq["layers"][0]["ffn"]["w2"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["wo", "dyn"])
def test_port_quantize_params_equals_bridged_reference(mode, dtype):
    _, _, np_params, tcfg, _ = _pair(dtype, seed=3)
    own = _paths(Q.quantize_params(bridge.params_to_torch(tcfg, np_params, "cpu"), mode))
    jq = JQ.quantize_params(jax.tree.map(jnp.asarray, np_params), mode)
    bridged = _paths(bridge.params_to_torch(tcfg, jax.tree.map(np.asarray, jq), "cpu"))
    assert set(own) == set(bridged)
    for name, v in bridged.items():
        assert own[name].dtype == v.dtype and torch.equal(own[name], v), name


def test_qdense_bias_and_quantization_error():
    rng = np.random.default_rng(9)
    w = t(rng.standard_normal((16, 8)).astype(np.float32))
    p = {"w": w, "b": torch.arange(8.0)}
    qp = Q.quantize_linear(p, "wo")
    assert set(qp) == {"w_q_wo", "w_scale", "b"}
    torch.testing.assert_close(Q.qdense(qp, torch.zeros(3, 16)), torch.arange(8.0).expand(3, 8))
    x = t(rng.standard_normal((5, 16)).astype(np.float32))
    for mode in ("wo", "dyn"):
        err = Q.quantization_error({"w": w}, Q.quantize_linear({"w": w}, mode), x)
        jw = {"w": jnp.asarray(w.numpy())}
        jerr = JQ.quantization_error(jw, JQ.quantize_linear(jw, mode), jnp.asarray(x.numpy()))
        assert 0 < err < 0.05
        assert err == pytest.approx(jerr, rel=1e-3, abs=1e-6)


@pytest.mark.parametrize("mode", [None, "wo", "dyn"])
def test_dense_with_bias_matches_jax(mode):
    """``layers.dense``: the bias, and a quantized dict (no ``"w"``) sent
    to ``qdense`` on every ``impl`` that runs on the CPU."""
    rng = np.random.default_rng(10)
    p = {"w": rng.standard_normal((32, 24)).astype(np.float32),
         "b": rng.standard_normal(24).astype(np.float32)}
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    if mode is not None:
        jp = JQ.quantize_linear(jp, mode)
    tp = {k: t(np.asarray(v)) for k, v in jp.items()}
    want = jL.dense(jp, jnp.asarray(x))
    for impl in ("auto", "torch"):
        got = L.dense(tp, t(x), impl)
        assert got.shape == (2, 5, 24) and got.dtype == torch.float32
        close(got, want, F32)


def test_measure_mode_on_cpu_picks_a_mode():
    w = t(np.random.default_rng(4).standard_normal((32, 16)).astype(np.float32))
    assert Q.measure_mode(w, 4, n_iter=2) in ("wo", "dyn")


# ------------------------------------------------------------ whole model
@pytest.mark.parametrize("mode,scan", [("wo", False), ("dyn", False), ("wo", True),
                                       ("dyn", True)])
def test_quantized_forward_matches_jax(mode, scan):
    """The reference's quantized tree (``scan_layers`` stacks included:
    ``w_scale`` [L, N] unstacked per layer by the bridge) through train,
    ragged prefill and three decode steps."""
    jcfg, jmodel, np_params, tcfg, tmodel = _pair(scan=scan)
    jq = JQ.quantize_params(jax.tree.map(jnp.asarray, np_params), mode)
    tq = bridge.params_to_torch(tcfg, jax.tree.map(np.asarray, jq), "cpu")
    lin = tq["layers"][1]["attn"]["wk"]
    assert set(lin) == {f"w_q_{mode}", "w_scale"}
    assert lin[f"w_q_{mode}"].dtype == torch.int8 and lin["w_scale"].dtype == torch.float32
    assert lin["w_scale"].shape == (lin[f"w_q_{mode}"].shape[1],)
    assert len(tq["layers"]) == jcfg.n_layers

    rng = np.random.default_rng(6)
    tokens = rng.integers(0, jcfg.vocab_size, size=(3, 8)).astype(np.int32)
    jlog, _, _ = jmodel.forward(jq, {"tokens": jnp.asarray(tokens)}, mode="train")
    tlog, _, _ = tmodel.forward(tq, {"tokens": t(tokens)}, mode="train")
    close(tlog, jlog, LOGITS)

    plen = np.array([8, 3, 5], np.int32)
    jc, tc = jmodel.init_cache(3, 14), tmodel.init_cache(3, 14, "cpu")
    batch = {"tokens": tokens, "prompt_lengths": plen}
    jlog, jc, _ = jmodel.forward(jq, jax.tree.map(jnp.asarray, batch), cache=jc,
                                 mode="prefill")
    with torch.inference_mode():
        tlog, tc, _ = tmodel.forward(tq, {k: t(v) for k, v in batch.items()}, cache=tc,
                                     mode="prefill")
    close(tlog, jlog, LOGITS)
    for _ in range(3):
        nxt = rng.integers(0, jcfg.vocab_size, size=(3, 1)).astype(np.int32)
        jlog, jc, _ = jmodel.forward(jq, {"tokens": jnp.asarray(nxt)}, cache=jc,
                                     mode="decode")
        with torch.inference_mode():
            tlog, tc, _ = tmodel.forward(tq, {"tokens": t(nxt)}, cache=tc, mode="decode")
        close(tlog, jlog, LOGITS)


def _ref_gap(jmodel, jparams, prompt, prefix) -> float:
    seq = np.concatenate([np.asarray(prompt, np.int32), np.asarray(prefix, np.int32)])
    logits, _ = jengine.prefill(jmodel, jparams, jnp.asarray(seq[None]),
                                jnp.asarray([len(seq)], jnp.int32), len(seq) + 1, None)
    top2 = np.sort(np.asarray(logits[0]))[-2:]
    return float(top2[1] - top2[0])


def assert_tokens_match(got, want, gap_at, what: str) -> None:
    got, want = [int(x) for x in got], [int(x) for x in want]
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            gap = gap_at(i)
            assert gap < NEAR_TIE, f"{what}: token {i} is {g}, the reference's {w} (gap {gap})"
            print(f"{what}: near-tie divergence at token {i} (gap {gap:.2e})")
            return
    assert len(got) == len(want), f"{what}: {len(got)} tokens vs {len(want)}"


@pytest.mark.parametrize("mode", ["wo", "dyn"])
def test_quantized_generate_matches_jax(quantized, mode):
    jmodel, jq, tmodel, tq = quantized[mode]
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, 512, size=int(rng.integers(3, PAD_TO + 1))) for _ in range(3)]
    buf = np.zeros((3, PAD_TO), np.int32)
    for i, p in enumerate(prompts):
        buf[i, : len(p)] = p
    plen = np.array([len(p) for p in prompts], np.int32)
    want = jengine.generate(jmodel, jq, jnp.asarray(buf), prompt_lengths=jnp.asarray(plen),
                            max_new_tokens=10, sampler=jsampling.greedy)
    got = engine.generate(tmodel, tq, t(buf), prompt_lengths=t(plen), max_new_tokens=10)
    wt = np.asarray(want["tokens"])
    for i in range(3):
        assert_tokens_match(got["tokens"][i].numpy(), wt[i],
                            lambda k, i=i: _ref_gap(jmodel, jq, prompts[i], wt[i][:k]),
                            f"{mode} generate row {i}")


@pytest.mark.parametrize("mode", ["wo", "dyn"])
def test_quantized_scheduler_matches_jax(quantized, mode):
    jmodel, jq, tmodel, tq = quantized[mode]
    rng = np.random.default_rng(13)
    traffic = [(i, rng.integers(0, 512, size=int(rng.integers(3, PAD_TO + 1))), m)
               for i, m in enumerate([5, 12, 3, 9, 7, 4])]
    js = JScheduler(jmodel, jq, slots=2, pad_to=PAD_TO, max_new_cap=12)
    ts = Scheduler(tmodel, tq, slots=2, pad_to=PAD_TO, max_new_cap=12, device="cpu")
    jdone = js.run([JRequest(rid=i, prompt=p, max_new=m) for i, p, m in traffic])
    tdone = ts.run([ServeRequest(rid=i, prompt=p, max_new=m) for i, p, m in traffic])
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    jtok = {r.rid: r.tokens for r in jdone}
    for r in tdone:
        assert_tokens_match(
            r.tokens, jtok[r.rid],
            lambda k, p=traffic[r.rid][1], w=jtok[r.rid]: _ref_gap(jmodel, jq, p, w[:k]),
            f"{mode} request {r.rid}")
    assert (ts.n_prefills, ts.n_decode_steps) == (js.n_prefills, js.n_decode_steps)
