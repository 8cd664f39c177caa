"""The fused RMSNorms (``kernels/rmsnorm.py``, ``ops.add_rmsnorm``,
``ops.mul_rmsnorm``, ``ops.mul_silu_rmsnorm``) on the CPU, where they take
their plain versions, and the models' layer loops that use them.

- The plain versions against the JAX package's compositions on the same
  numpy inputs (``ref.rmsnorm_ref`` of ``x + r``, ``a * u`` and
  ``y * silu(z)``): f32 atol 2e-5 / rtol 2e-4, bf16 atol = rtol = 2e-2
  (``tests/test_kernels.py``).
- The plain versions bit for bit against the unfused torch ops, with the
  second operand a slice of a wider tensor as the models pass it.
- Each model's ``forward`` (every residual add fused into the next norm)
  bit for bit against a layer-by-layer loop of the unfused layer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ref as jref
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import _build, ops
from repro_torch.kernels import rmsnorm as rn
from repro_torch.models import get_model
from repro_torch.models import hstu, ssm, transformer
from repro_torch.models import layers as L

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FUSED = ("add", "mul", "mul_silu")
OPS = {"add": ops.add_rmsnorm, "mul": ops.mul_rmsnorm, "mul_silu": ops.mul_silu_rmsnorm}
PLAIN = {"add": rn.add_rmsnorm_plain, "mul": rn.mul_rmsnorm_plain,
         "mul_silu": rn.mul_silu_rmsnorm_plain}


def tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" else dict(atol=2e-5, rtol=2e-4)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _y(out):
    """The normalised output of a fused op (add also returns the sum)."""
    return out[1] if isinstance(out, tuple) else out


@pytest.fixture(autouse=True)
def no_launches():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    yield
    assert rn.LAUNCHES == 0 and set(rn.LAUNCHES_BY_PROLOGUE.values()) == {0}


# --------------------------------------------------------- against the JAX package
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 5, 256), (7, 1000)])
@pytest.mark.parametrize("prologue", FUSED)
def test_fused_plain_matches_jax_composition(prologue, shape, name):
    rng = np.random.default_rng(shape[-1] + len(prologue))
    jd, td = DTYPES[name]
    a, b = (rng.standard_normal(shape, np.float32) * 2 for _ in range(2))
    w = 1 + 0.1 * rng.standard_normal(shape[-1], np.float32)
    aj, bj, wj = (jnp.asarray(v).astype(jd) for v in (a, b, w))
    at, bt, wt = (torch.from_numpy(v).to(td) for v in (a, b, w))
    first = {"add": lambda: aj + bj, "mul": lambda: aj * bj,
             "mul_silu": lambda: aj * jax.nn.silu(bj)}[prologue]()
    want = jref.rmsnorm_ref(first, wj, 1e-5)
    for out in (PLAIN[prologue](at, bt, wt, 1e-5), OPS[prologue](at, bt, wt, 1e-5)):
        got = _y(out)
        assert got.dtype == td and got.shape == at.shape
        np.testing.assert_allclose(f32(got), f32(want), **tol(name))
        if prologue == "add":
            np.testing.assert_allclose(f32(out[0]), f32(first), **tol(name))


# --------------------------------------------------- against the unfused torch ops
def _operands(prologue, dtype, strided):
    """x [2, 9, d] and the second operand, a slice of a wider last axis (as
    HSTU's u and Mamba-2's z are) when ``strided``."""
    g = torch.Generator().manual_seed(7)
    d = 96
    x = (torch.randn(2, 9, d, generator=g) * 3).to(dtype)
    wide = torch.randn(2, 9, 4 * d + 5, generator=g).to(dtype)
    other = wide[..., d + 1:2 * d + 1] if strided else wide[..., :d].contiguous()
    w = (1 + 0.1 * torch.randn(d, generator=g)).to(dtype)
    return x, other, w


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("prologue", FUSED)
def test_fused_plain_equals_unfused_ops_bitwise(prologue, dtype, strided):
    x, other, w = _operands(prologue, dtype, strided)
    assert other.is_contiguous() != strided
    if prologue == "add":
        s = x + other
        want_s, want = s, rn.rmsnorm_plain(s, w)
    elif prologue == "mul":
        want = rn.rmsnorm_plain(x * other, w)
    else:
        want = rn.rmsnorm_plain(x * F.silu(other), w)
    for out in (PLAIN[prologue](x, other, w), OPS[prologue](x, other, w),
                OPS[prologue](x, other, w, impl="torch")):
        assert torch.equal(_y(out), want)
        if prologue == "add":
            assert torch.equal(out[0], want_s)


def test_rows_passes_row_strided_views_and_copies_the_rest():
    """``ops._rows`` hands the kernel HSTU's ``u`` and Mamba-2's ``z`` as
    the views they are, and copies only what has no single row stride."""
    uvqk = torch.zeros(2, 5, 4, 3, 8)  # [b, t, 4, heads, head_dim]
    u = uvqk[:, :, 0].reshape(2, 5, 24)
    zxbcdt = torch.zeros(2, 5, 71)
    z = zxbcdt[..., :24]
    for view in (u, z):
        got = ops._rows(view)
        assert got is view and got.data_ptr() == view.data_ptr()
    transposed = torch.zeros(24, 10).T  # unit stride on the row axis
    padded_rows = torch.zeros(2, 6, 24)[:, :5]  # rows of two strides
    for other in (transposed, padded_rows, padded_rows[..., ::2]):
        got = ops._rows(other)
        assert got.is_contiguous() and torch.equal(got, other)


def test_fused_ops_check_operands_and_refuse_cuda_on_cpu():
    x, other, w = _operands("add", torch.float32, True)
    for prologue in FUSED:
        with pytest.raises(ValueError, match="CUDA"):
            OPS[prologue](x, other, w, impl="cuda")
        with pytest.raises(ValueError, match="differ"):
            OPS[prologue](x, other[:, :4], w)
        with pytest.raises(ValueError, match="differ"):
            OPS[prologue](x, other.to(torch.bfloat16), w)
        with pytest.raises(ValueError, match="impl"):
            OPS[prologue](x, other, w, impl="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        _build.require_rows("rmsnorm", other, x)


BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("n_rows,d,dtype,want", [
    (40240, 512, BF, ("warp", 1, 16)),  # HSTU's forward: one warp a row
    (2048, 768, BF, ("warp", 1, 24)), (2048, 1536, BF, ("warp", 1, 48)),
    (4096, 2048, BF, ("warp", 1, 64)),
    (8, 2048, BF, ("warp", 8, 8)),  # llama's decode step: 8 warps a row
    (256, 2048, BF, ("warp", 4, 16)), (256, 1536, BF, ("warp", 4, 16)),  # prefills
    (8, 768, BF, ("warp", 2, 16)),  # a whole vector a lane stops W at 2
    (4096, 4096, BF, ("warp", 2, 64)),  # past one warp's budget
    (3, 16384, BF, ("warp", 8, 64)), (3, 16385, BF, ("block", None, None)),
    (1, 1, F32, ("warp", 1, 8)), (8, 1536, F32, ("warp", 8, 8)),
    (4096, 1536, F32, ("warp", 2, 32)), (3, 8193, F32, ("block", None, None)),
])
def test_route_by_rows_and_width(n_rows, d, dtype, want):
    """The warp path holds a row in the fewest warps (up to 8) that keep it
    within 128 bytes a lane, and doubles them while the grid has under 1024
    warps and every lane keeps a whole 16-byte vector; longer rows take the
    block path."""
    assert rn.route(n_rows, d, dtype) == want


# ------------------------------------------------------- the models' layer loops
def _dense_by_layer(cfg, params, tokens):
    """The dense forward (train mode) as a loop of ``layer_forward``."""
    b, t = tokens.shape
    positions = torch.arange(t, dtype=torch.int32)[None].expand(b, t)
    x = L.embed(params["embed"], tokens)
    for lp in params["layers"]:
        x, _ = transformer.layer_forward(cfg, lp, x, positions=positions, lengths=None,
                                         cache=None, mode="train")
    x = L.rmsnorm(params["final_norm"], x, cfg.rmsnorm_eps)
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], x)
    return L.dense(params["lm_head"], x).float()


def _hstu_by_layer(cfg, params, tokens, lengths):
    x = L.embed(params["embed"], tokens)
    for i, lp in enumerate(params["layers"]):
        x = hstu.layer_forward(cfg, lp, x, layer=i, lengths=lengths)
    x = L.rmsnorm(params["final_norm"], x, cfg.rmsnorm_eps)
    return L.unembed(params["embed"], x), L.dense(params["ranking_head"], x).float()


def _ssm_by_layer(cfg, params, tokens, cache, mode):
    """Mamba-2's loop as it stood unfused: norm, mixer, residual add."""
    x = L.embed(params["embed"], tokens)
    new_layers = []
    for i, lp in enumerate(params["layers"]):
        h = L.rmsnorm(lp["norm"], x, cfg.rmsnorm_eps)
        out, nlc = ssm.block_forward(cfg, lp["mixer"], h, cache=cache["layers"][i], mode=mode)
        x = x + out
        new_layers.append(nlc)
    x = L.rmsnorm(params["final_norm"], x, cfg.rmsnorm_eps)
    return L.unembed(params["embed"], x), new_layers


def _model(arch, dtype, n_layers=3):
    cfg = get_smoke_config(arch).replace(dtype=dtype, n_layers=n_layers)
    model = get_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(3), "cpu")


def _tokens(cfg, b, t, seed=11):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_forward_equals_layer_by_layer_loop(dtype):
    cfg, model, params = _model("llama3.2-1b", dtype)
    tokens = _tokens(cfg, 2, 12)
    with torch.inference_mode():
        got, _, _ = model.forward(params, {"tokens": tokens}, mode="train")
        want = _dense_by_layer(cfg, params, tokens)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hstu_forward_equals_layer_by_layer_loop(dtype):
    cfg, model, params = _model("hstu", dtype, n_layers=4)  # layer 3 runs the band
    tokens = _tokens(cfg, 2, 80)
    lengths = torch.tensor([50, 80], dtype=torch.int32)
    with torch.inference_mode():
        got, _, aux = model.forward(params, {"tokens": tokens, "lengths": lengths},
                                    mode="prefill")
        want, want_rank = _hstu_by_layer(cfg, params, tokens, lengths)
    assert torch.equal(got, want) and torch.equal(aux["ranking_logits"], want_rank)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_forward_equals_layer_by_layer_loop(dtype):
    """Prefill, then one decode step from the prefilled cache: logits and
    every cache tensor bit for bit (``z`` reaches the gated norm as a slice
    of the input projection in both modes)."""
    cfg, model, params = _model("mamba2-130m", dtype)
    tokens = _tokens(cfg, 2, 10)
    with torch.inference_mode():
        got, gcache, _ = model.forward(params, {"tokens": tokens},
                                       cache=model.init_cache(2, 16, "cpu"), mode="prefill")
        want, wlayers = _ssm_by_layer(cfg, params, tokens, model.init_cache(2, 16, "cpu"),
                                      "prefill")
        assert torch.equal(got, want)
        for g, w in zip(gcache["layers"], wlayers):
            assert torch.equal(g["conv"], w["conv"]) and torch.equal(g["state"], w["state"])
        step = tokens[:, -1:]
        got, _, _ = model.forward(params, {"tokens": step}, cache=gcache, mode="decode")
        want, _ = _ssm_by_layer(cfg, params, step, {"layers": wlayers}, "decode")
    assert torch.equal(got, want)
