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
from repro_torch.kernels import int8_matmul as im
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


def _counts():
    return (rn.LAUNCHES, fa.LAUNCHES, da.LAUNCHES, im.LAUNCHES_WO, im.LAUNCHES_DYN)


@pytest.fixture(autouse=True)
def no_launches():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    before = _counts()
    yield
    assert _counts() == before == (0, 0, 0, 0, 0)


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


def _mma_flash_emulation(q, k, v, q_pos, k_pos, window=None, k_valid=None, tile=64):
    """The bf16 tensor-core flash kernel's rounding in plain torch: S in f32
    from the bf16 q and k, the scale applied to S, an online softmax over
    64-key tiles with f32 running max and sum (a masked score is -inf, the
    max starts at the -1e30 sentinel), P rounded to bf16 before P.V, f32
    accumulators, and the max(l, 1e-30) clamp."""
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.float().reshape(b, tq, hkv, g, d)
    ok = fa._mask(q_pos, k_pos, True, window, k_valid)[:, None, None]  # [B,1,1,Tq,Tk]
    m = torch.full((b, hkv, g, tq), -1e30)
    l = torch.zeros((b, hkv, g, tq))
    acc = torch.zeros((b, hkv, g, tq, d))
    for k0 in range(0, tk, tile):
        s = torch.einsum("bthgd,bshd->bhgts", qf, k[:, k0:k0 + tile].float()) * d ** -0.5
        s = torch.where(ok[..., k0:k0 + tile], s, torch.full_like(s, -torch.inf))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bhgts,bshd->bhgtd", p.to(torch.bfloat16).float(),
                          v[:, k0:k0 + tile].float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, tq, hq, d).to(q.dtype)


@pytest.mark.parametrize(
    "b,t,hq,hkv,window",
    [
        (1, 256, 32, 8, None),   # the served llama3.2-1b prefill
        (2, 67, 8, 2, 16),       # ragged T, sliding window
        (1, 67, 64, 1, None),    # MQA, G = 64
    ],
)
def test_bf16_p_rounding_fits_the_tolerance(b, t, hq, hkv, window):
    """The one rounding the bf16 tensor-core kernel adds (P to bf16 before
    P.V, the scale on the f32 S) stays within the bf16 tolerance of the JAX
    reference (its XLA flash path and its oracle) and of the port's plain
    version, at the served prefill shape and two edge shapes."""
    rng = np.random.default_rng(t + hq)
    d = 64
    qj, qt = both(rng.standard_normal((b, t, hq, d), np.float32), "bfloat16")
    kj, kt = both(rng.standard_normal((b, t, hkv, d), np.float32), "bfloat16")
    vj, vt = both(rng.standard_normal((b, t, hkv, d), np.float32), "bfloat16")
    pos = torch.arange(t)[None].expand(b, t).to(torch.int32).contiguous()
    got = _mma_flash_emulation(qt, kt, vt, pos, pos, window=window)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    for want in (jops.flash_attention(qj, kj, vj, causal=True, window=window, impl="xla"),
                 jref.attention_ref(qj, kj, vj, causal=True, window=window),
                 fa.flash_attention_plain(qt, kt, vt, q_positions=pos, k_positions=pos,
                                          causal=True, window=window)):
        assert_close(got, want, "bfloat16")


def test_bf16_emulation_masked_row_is_zero():
    """Explicit positions with k_valid: the emulated kernel gives exact zeros
    for a row with no valid key and agrees with the plain version
    elsewhere."""
    rng = np.random.default_rng(11)
    b, t, s, hq, hkv, d = 2, 5, 40, 8, 2, 64
    q, k, v = (torch.from_numpy(rng.standard_normal(sh, np.float32)).to(torch.bfloat16)
               for sh in ((b, t, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    qpos = torch.tensor([[10, 11, 12, 13, 14], [3, 4, 5, 6, 7]], dtype=torch.int32)
    kpos = torch.arange(s, dtype=torch.int32).expand(b, s).contiguous()
    kval = (kpos < torch.tensor([[15], [0]])).contiguous()
    got = _mma_flash_emulation(q, k, v, qpos, kpos, k_valid=kval)
    want = fa.flash_attention_plain(q, k, v, q_positions=qpos, k_positions=kpos,
                                    k_valid=kval)
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    assert_close(got, want, "bfloat16")


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


@pytest.mark.parametrize("n_shards", [1, 3])
def test_decode_partial_and_combine_match_jax(n_shards):
    """The port's plain flash-decode partial and LSE combine against the JAX
    package's, shard by shard, on the same numpy inputs (f32); shard 0 of
    row 0 holds no valid key."""
    rng = np.random.default_rng(20 + n_shards)
    b, s, hq, hkv, d = 2, 48, 8, 2, 32
    q = rng.standard_normal((b, hq, d), np.float32)
    k = rng.standard_normal((b, s, hkv, d), np.float32)
    v = rng.standard_normal((b, s, hkv, d), np.float32)
    valid = np.arange(s)[None] < np.array([[30], [48]])
    valid[0, : s // n_shards] &= n_shards == 1
    parts_j, parts_t = [], []
    for z in range(n_shards):
        sl = slice(z * s // n_shards, (z + 1) * s // n_shards)
        parts_j.append(jops.decode_attention_partial(
            jnp.asarray(q), jnp.asarray(k[:, sl]), jnp.asarray(v[:, sl]),
            jnp.asarray(valid[:, sl])))
        parts_t.append(ops.decode_attention_partial(
            torch.from_numpy(q), torch.from_numpy(k[:, sl].copy()),
            torch.from_numpy(v[:, sl].copy()), torch.from_numpy(valid[:, sl].copy())))
        for got, want in zip(parts_t[-1], parts_j[-1]):
            assert got.dtype == torch.float32
            assert_close(got, want, "float32")
    want = jops.combine_partial_attention(*(jnp.stack(t) for t in zip(*parts_j)))
    got = ops.combine_partial_attention(*(torch.stack(t) for t in zip(*parts_t)))
    assert_close(got, want, "float32")


def _split_emulation(q, k, v, lengths, splits, split_len):
    """The split decode kernel in plain torch: row b's sequence in runs of
    ``split_len`` keys, a partial for each of the ceil(len / split_len)
    runs that hold keys (the kernel skips the others), merged in run order
    by the LSE combine; a row of length 0 has no run and stays 0."""
    b, s = k.shape[:2]
    out = torch.zeros(q.shape, dtype=torch.float32)
    for row in range(b):
        ln = min(max(int(lengths[row]), 0), s)
        parts = []
        for z in range(-(-ln // split_len)):
            lo, hi = z * split_len, min(s, (z + 1) * split_len)
            ok = (torch.arange(lo, hi) < ln)[None]
            parts.append(ops.decode_attention_partial(
                q[row:row + 1], k[row:row + 1, lo:hi], v[row:row + 1, lo:hi], ok))
        assert len(parts) <= splits
        if parts:
            out[row] = ops.combine_partial_attention(
                *(torch.stack(t) for t in zip(*parts)))[0]
    return out.to(q.dtype)


@pytest.mark.parametrize(
    "b,s,hq,hkv,n_sms",
    [
        (6, 321, 8, 2, 132),   # the served S: six one-tile runs
        (6, 1000, 8, 8, 40),   # runs of three tiles, a ragged last run
    ],
)
def test_decode_split_plan_emulation_matches_plain_and_pallas(b, s, hq, hkv, n_sms):
    """The split plan, emulated through the ported partial and combine,
    equals the plain version and the JAX package's Pallas kernel
    (interpret mode) at lengths 0, 1, split - 1, split, split + 1 and S."""
    splits, split_len = da.split_plan(b, hkv, s, n_sms)
    assert splits > 1
    lengths = [0, 1, split_len - 1, split_len, split_len + 1, s]
    rng = np.random.default_rng(s)
    d = 32
    qj, qt = both(rng.standard_normal((b, hq, d), np.float32), "float32")
    kj, kt = both(rng.standard_normal((b, s, hkv, d), np.float32), "float32")
    vj, vt = both(rng.standard_normal((b, s, hkv, d), np.float32), "float32")
    ln = np.asarray(lengths, np.int32)
    got = _split_emulation(qt, kt, vt, ln, splits, split_len)
    pallas = jops.decode_attention(qj, kj, vj, jnp.asarray(ln), impl="pallas", block_k=64)
    assert_close(got, da.decode_attention_plain(qt, kt, vt, torch.from_numpy(ln)), "float32")
    assert_close(got, pallas, "float32")
    assert torch.equal(got[0], torch.zeros_like(got[0]))


@pytest.mark.parametrize("b,hkv,s,n_sms", [(8, 8, 321, 132), (8, 8, 4096, 132),
                                           (1, 8, 4096, 132), (8, 8, 67, 132),
                                           (3, 1, 129, 132), (64, 8, 321, 132),
                                           (2, 2, 50, 132), (1, 1, 0, 132), (5, 3, 1, 7)])
def test_decode_split_plan_covers_s(b, hkv, s, n_sms):
    """Runs of whole 64-key tiles cover S, none starts at or past S (so
    only runs past a row's length are empty, and the kernel skips those),
    and the grid reaches two blocks per SM where S has the tiles for it."""
    splits, split_len = da.split_plan(b, hkv, s, n_sms)
    assert splits >= 1 and split_len >= 64 and split_len % 64 == 0
    assert splits * split_len >= s and (splits - 1) * split_len < max(s, 1)
    tiles = -(-s // 64)
    if tiles * b * hkv >= 2 * n_sms:
        assert splits * b * hkv >= 2 * n_sms
    if b * hkv >= 2 * n_sms:
        assert splits == 1
    assert da.split_plan(8, 8, 321, 132) == (6, 64)


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


def test_wrapper_times_needs_a_card(monkeypatch):
    """The wrappers' timing script exits with a message, and times
    nothing, where no CUDA card is present."""
    from repro_torch.launch import wrapper_times

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        wrapper_times.main([])


def test_kernel_times_needs_a_card(monkeypatch):
    """The SSD and HSTU kernels' timing script exits with a message, and
    times nothing, where no CUDA card is present."""
    from repro_torch.launch import kernel_times

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        kernel_times.main([])
