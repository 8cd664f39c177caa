"""Port kernels vs the JAX package: the same numpy inputs go through the
JAX oracle (``repro.kernels.ref``) and the Pallas kernel in interpret mode,
and through the port's oracle, its kernels' plain versions and its ``ops``
dispatch on CPU tensors.

Tolerances mirror tests/test_kernels.py: f32 atol 2e-5 / rtol 2e-4, bf16
atol = rtol = 2e-2. On the CPU every wrapper must take the plain version
(no launch counted) and ``impl="cuda"`` must raise, never fall back."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rn

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" else dict(atol=2e-5, rtol=2e-4)


def both(a, name):
    """One numpy array as a JAX array and a torch tensor of the same type."""
    jd, td = DTYPES[name]
    return jnp.asarray(a).astype(jd), torch.from_numpy(np.array(a)).to(td)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_close(got, want, name):
    np.testing.assert_allclose(f32(got), f32(want), **tol(name))


@pytest.fixture(autouse=True)
def no_launches():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    before = (rn.LAUNCHES, fa.LAUNCHES, da.LAUNCHES)
    yield
    assert (rn.LAUNCHES, fa.LAUNCHES, da.LAUNCHES) == before == (0, 0, 0)


# ---------------------------------------------------------------- flash attn
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,t,hq,hkv,d,window",
    [
        (1, 16, 4, 4, 16, None),     # MHA
        (2, 67, 8, 2, 32, None),     # GQA, ragged T
        (2, 67, 8, 2, 32, 16),       # sliding window
        (1, 128, 4, 1, 64, None),    # MQA
        (2, 33, 6, 3, 48, 8),        # odd dims
    ],
)
def test_flash_attention_matches_jax(b, t, hq, hkv, d, window, name):
    rng = np.random.default_rng(b * 1000 + t + hq)
    qj, qt = both(rng.standard_normal((b, t, hq, d), np.float32), name)
    kj, kt = both(rng.standard_normal((b, t, hkv, d), np.float32), name)
    vj, vt = both(rng.standard_normal((b, t, hkv, d), np.float32), name)
    want = jref.attention_ref(qj, kj, vj, causal=True, window=window)
    pallas = jops.flash_attention(qj, kj, vj, causal=True, window=window,
                                  impl="pallas", block_q=32, block_k=32)
    pos = torch.arange(t)[None].expand(b, t).to(torch.int32).contiguous()
    ported = {
        "ref": ref.attention_ref(qt, kt, vt, causal=True, window=window),
        "plain": fa.flash_attention_plain(qt, kt, vt, q_positions=pos, k_positions=pos,
                                          causal=True, window=window),
        "ops-auto": ops.flash_attention(qt, kt, vt, causal=True, window=window),
        "ops-torch": ops.flash_attention(qt, kt, vt, causal=True, window=window,
                                         impl="torch"),
    }
    for label, got in ported.items():
        assert got.dtype == qt.dtype and got.shape == qt.shape, label
        assert_close(got, want, name)
        assert_close(got, pallas, name)


@pytest.mark.parametrize("impl", ["auto", "torch"])
def test_flash_attention_positions_k_valid_and_masked_row(impl):
    """Explicit positions plus k_valid; batch row 1 has no valid key, so
    its output must be exactly zero (the -1e30 sentinel and the 1e-30
    clamp), where the oracles' -inf softmax gives NaN -> 0."""
    rng = np.random.default_rng(7)
    b, t, s, hq, hkv, d = 2, 5, 40, 4, 2, 16
    qj, qt = both(rng.standard_normal((b, t, hq, d), np.float32), "float32")
    kj, kt = both(rng.standard_normal((b, s, hkv, d), np.float32), "float32")
    vj, vt = both(rng.standard_normal((b, s, hkv, d), np.float32), "float32")
    qpos = np.array([[10, 11, 12, 13, 14], [3, 4, 5, 6, 7]], np.int32)
    kpos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    kval = kpos < np.array([[15], [0]])
    kw_j = dict(q_positions=jnp.asarray(qpos), k_positions=jnp.asarray(kpos),
                causal=True, k_valid=jnp.asarray(kval))
    want = jref.attention_ref(qj, kj, vj, **kw_j)
    pallas = jops.flash_attention(qj, kj, vj, impl="pallas", block_k=16, **kw_j)
    got = ops.flash_attention(
        qt, kt, vt, q_positions=torch.from_numpy(qpos),
        k_positions=torch.from_numpy(kpos.copy()), causal=True,
        k_valid=torch.from_numpy(kval), impl=impl,
    )
    assert_close(got, want, "float32")
    assert_close(got, pallas, "float32")
    assert torch.equal(got[1], torch.zeros_like(got[1]))


# ------------------------------------------------------------- decode attn
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,s,hq,hkv,d,lengths",
    [
        (2, 50, 8, 2, 32, [1, 50]),
        (1, 17, 4, 4, 16, [17]),
        (3, 129, 8, 1, 64, [1, 64, 129]),
    ],
)
def test_decode_attention_matches_jax(b, s, hq, hkv, d, lengths, name):
    rng = np.random.default_rng(s + hq)
    qj, qt = both(rng.standard_normal((b, hq, d), np.float32), name)
    kj, kt = both(rng.standard_normal((b, s, hkv, d), np.float32), name)
    vj, vt = both(rng.standard_normal((b, s, hkv, d), np.float32), name)
    ln = np.asarray(lengths, np.int32)
    want = jref.decode_attention_ref(qj, kj, vj, jnp.asarray(ln))
    pallas = jops.decode_attention(qj, kj, vj, jnp.asarray(ln), impl="pallas",
                                   block_k=16)
    lt = torch.from_numpy(ln)
    ported = {
        "ref": ref.decode_attention_ref(qt, kt, vt, lt),
        "plain": da.decode_attention_plain(qt, kt, vt, lt),
        "ops-auto": ops.decode_attention(qt, kt, vt, lt),
        "ops-torch": ops.decode_attention(qt, kt, vt, lt, impl="torch"),
    }
    for label, got in ported.items():
        assert got.dtype == qt.dtype and got.shape == qt.shape, label
        assert_close(got, want, name)
        assert_close(got, pallas, name)


def test_decode_attention_empty_row_is_zero():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 4, 16), np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 9, 2, 16), np.float32))
    out = da.decode_attention_plain(q, k, k, torch.tensor([0, 9], dtype=torch.int32))
    assert torch.equal(out[0], torch.zeros_like(out[0]))


# ------------------------------------------------------------------ rmsnorm
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 5, 256), (7, 2048)])
def test_rmsnorm_matches_jax(shape, name):
    rng = np.random.default_rng(shape[-1])
    xj, xt = both(rng.standard_normal(shape, np.float32) * 3, name)
    wj, wt = both(1 + 0.1 * rng.standard_normal(shape[-1], np.float32), name)
    want = jref.rmsnorm_ref(xj, wj, 1e-5)
    pallas = jops.rmsnorm(xj, wj, eps=1e-5, impl="pallas")
    for got in (ref.rmsnorm_ref(xt, wt, 1e-5), rn.rmsnorm_plain(xt, wt, 1e-5),
                ops.rmsnorm(xt, wt, 1e-5), ops.rmsnorm(xt, wt, 1e-5, impl="torch")):
        assert got.dtype == xt.dtype and got.shape == xt.shape
        assert_close(got, want, name)
        assert_close(got, pallas, name)


# --------------------------------------------------- no fallback on the CPU
@pytest.mark.parametrize("kernel", ["rmsnorm", "flash_attention", "decode_attention"])
def test_cuda_impl_on_cpu_tensor_raises(kernel):
    x = torch.zeros(2, 4, 2, 64)
    calls = {
        "rmsnorm": lambda: ops.rmsnorm(x, torch.ones(64), impl="cuda"),
        "flash_attention": lambda: ops.flash_attention(x, x, x, impl="cuda"),
        "decode_attention": lambda: ops.decode_attention(
            x[:, 0], x, x, torch.ones(2, dtype=torch.int32), impl="cuda"),
    }
    with pytest.raises(ValueError, match="CUDA"):
        calls[kernel]()


def test_unknown_impl_raises():
    with pytest.raises(ValueError, match="impl"):
        ops.rmsnorm(torch.zeros(2, 8), torch.ones(8), impl="pallas")
