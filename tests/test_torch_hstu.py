"""The port's HSTU slice vs the JAX package: ``ops.hstu_attention`` (the
kernel's plain version on the CPU) against the Pallas kernel in interpret
mode and the reference oracle, the layer and the whole model of the f32
``hstu`` smoke config with 4 layers (so layer 3 runs the ``max_attn_len``
band), params bridged from the reference's ``init(PRNGKey(0))``, and the
user-history generator.

Attention outputs are held at the f32 kernel tolerance (atol 2e-5 / rtol
2e-4). Layer outputs and logits are held at atol 1e-4 / rtol 1e-3: the
matmuls and the 512-way f32 unembed sum in another order in XLA and in
PyTorch, and the N(0, 1) item embeddings make logits of size ~10-50."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_CONFIGS
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import get_model as jget_model
from repro.models import hstu as jhstu
from repro.training import data as jdata
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import hstu_attention as ha
from repro_torch.models import get_model
from repro_torch.models import hstu
from repro_torch.training import data

F32 = dict(atol=2e-5, rtol=2e-4)
LOGITS = dict(atol=1e-4, rtol=1e-3)
N_LAYERS = 4  # > FULL_ATTN_LAYERS: layer 3 is banded


@pytest.fixture(scope="module")
def pair():
    jcfg = SMOKE_CONFIGS["hstu"].replace(dtype="float32", n_layers=N_LAYERS)
    jmodel = jget_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = get_smoke_config("hstu").replace(dtype="float32", n_layers=N_LAYERS)
    tparams = bridge.params_to_torch(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jmodel, jparams, tcfg, get_model(tcfg), tparams


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=F32):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               **tol)


def _qkvb(seed, b, tt, h, d, n_bias):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, tt, h, d)).astype(np.float32) * 0.3 for _ in range(2))
    v = rng.standard_normal((b, tt, h, d)).astype(np.float32)
    rb = rng.standard_normal((n_bias,)).astype(np.float32) * 0.1
    return q, k, v, rb


# ---------------------------------------------------------------- kernel
@pytest.mark.parametrize("mal", [None, 24])
@pytest.mark.parametrize("lens", [[40, 70], None])
def test_hstu_attention_matches_pallas_and_ref(mal, lens):
    """T = 70 against a 2 * 64 - 1 table: the bias clip is live; ragged
    ``lengths`` mask keys only (query rows past the length keep values)."""
    q, k, v, rb = _qkvb(0, 2, 70, 4, 32, 2 * 64 - 1)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    args = [jnp.asarray(a) for a in (q, k, v, rb)]
    want = jops.hstu_attention(*args, max_attn_len=mal, lengths=jl, impl="pallas")
    want_ref = jref.hstu_attention_ref(*args, max_attn_len=mal, lengths=jl)
    got = ops.hstu_attention(t(q), t(k), t(v), t(rb), max_attn_len=mal, lengths=tl)
    close(got, want)
    close(got, want_ref)
    close(ref.hstu_attention_ref(t(q), t(k), t(v), t(rb), max_attn_len=mal, lengths=tl),
          want_ref)
    if lens is not None:  # rows past lengths[0] = 40 are not zero
        assert float(got[0, 40:].abs().max()) > 0


def test_hstu_attention_band_and_empty_rows():
    """A band of 1 keeps only the diagonal; a row of length 0 gives zeros."""
    q, k, v, rb = _qkvb(1, 2, 9, 2, 32, 2 * 4 - 1)
    ln = torch.tensor([0, 9], dtype=torch.int32)
    got = ops.hstu_attention(t(q), t(k), t(v), t(rb), max_attn_len=1, lengths=ln)
    want = jops.hstu_attention(*(jnp.asarray(a) for a in (q, k, v, rb)), max_attn_len=1,
                               lengths=jnp.asarray([0, 9], jnp.int32), impl="pallas")
    close(got, want)
    assert bool((got[0] == 0).all())


def test_hstu_attention_cuda_impl_refuses_cpu_tensors():
    q, k, v, rb = (t(a) for a in _qkvb(2, 1, 8, 2, 32, 7))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.hstu_attention(q, k, v, rb, impl="cuda")


# ------------------------------------------- the bf16 kernel's tile walk


def _tile_mask(q0, t, band, length):
    """[64, T] validity of the query tile at ``q0`` against every key: the
    masks the kernels stand for (query rows are never masked)."""
    i = torch.arange(q0, q0 + ha.TILE)[:, None]
    j = torch.arange(t)[None, :]
    ok = (j <= i) & (j < min(length, t))
    if band is not None:
        ok &= i - j < band
    return ok


@pytest.mark.parametrize("t,band,length", [(5121, 1024, 5121), (5121, 1024, 4507),
                                           (5121, None, 4507), (133, 24, 0), (133, 24, 133),
                                           (300, 100, 211), (70, None, 40), (1100, 1024, 900),
                                           (200, 1, 150)])
def test_key_tiles_match_masks(t, band, length):
    """For every query tile: each valid (query, key) pair lies in a listed
    key tile; a tile is interior exactly when all its 64 x 64 pairs are
    valid (the bf16 kernel evaluates no mask there); the listed tiles are
    consecutive."""
    for q0 in range(0, t, ha.TILE):
        ok = _tile_mask(q0, t, band, length)
        tiles = ha.key_tiles(q0, t, band, length)
        listed = {k0 for k0, _ in tiles}
        assert [k0 for k0, _ in tiles] == list(range(min(listed, default=0),
                                                     max(listed, default=-1) + 1, ha.TILE))
        for k0 in range(0, t, ha.TILE):
            block = ok[:, k0:k0 + ha.TILE]
            if k0 not in listed:
                assert not bool(block.any()), (q0, k0)
        for k0, interior in tiles:
            block = ok[:, k0:k0 + ha.TILE]
            assert interior == (block.shape[1] == ha.TILE and bool(block.all())), (q0, k0)


def test_key_tiles_at_the_served_band():
    """A late query tile of a full-width banded layer walks 17 key tiles,
    15 of them interior: the masks run on 2."""
    tiles = ha.key_tiles(4096, 5121, 1024, 5121)
    assert len(tiles) == 17 and sum(interior for _, interior in tiles) == 15


def _mma_hstu_emulation(q, k, v, rb, band, lengths):
    """The bf16 tensor-core kernel's arithmetic in plain torch: f32 S from
    the bf16 q and k, the scale on S, the f32 bias, SiLU through
    tanh with the relative error of tanh.approx.f32 (about 2^-11, PTX ISA)
    applied in one direction everywhere (the worst case for a sum), P
    rounded to bf16 before P.V, f32 sums, 1 / T once at the end."""
    b, t, h, d = q.shape
    max_rel = (rb.shape[0] + 1) // 2
    pos = torch.arange(t)
    delta = pos[:, None] - pos[None, :]
    bias = rb[torch.clamp(delta, -(max_rel - 1), max_rel - 1) + max_rel - 1]
    ok = delta >= 0
    if band is not None:
        ok &= delta < band
    out = torch.empty_like(q)
    for r in range(b):
        x = torch.einsum("thd,shd->hts", q[r].float(), k[r].float()) * d ** -0.5 + bias
        tanh = torch.tanh(0.5 * x) * (1 + 2.0 ** -11)
        p = torch.where(ok & (pos[None, :] < lengths[r]), x * (0.5 + 0.5 * tanh),
                        torch.zeros(()))
        o = torch.einsum("hts,shd->thd", p.to(torch.bfloat16).float(), v[r].float())
        out[r] = (o * (1.0 / t)).to(q.dtype)
    return out


def test_mma_emulation_holds_the_normwise_criterion():
    """bf16 P and the approximate SiLU against the JAX reference at T =
    1100, band 1024, lengths 900 / 1100: max |err| <= 1e-2 max |want| (the
    card's criterion beside the bf16 tolerance, which the full-width
    outputs, divided by T = 5121, would meet as zeros), and the elementwise
    bf16 tolerance."""
    rng = np.random.default_rng(1100)
    b, tt, h, d = 2, 1100, 8, 64
    q, k, v = (rng.standard_normal((b, tt, h, d)).astype(np.float32) for _ in range(3))
    rb = rng.standard_normal((4095,)).astype(np.float32) * 0.1
    lens = np.asarray([900, 1100], np.int32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = _mma_hstu_emulation(tq, tk, tv, torch.from_numpy(rb), 1024, torch.from_numpy(lens))
    want = jref.hstu_attention_ref(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                   jnp.asarray(rb), max_attn_len=1024,
                                   lengths=jnp.asarray(lens))
    want = np.asarray(jnp.asarray(want, jnp.float32))
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= 1e-2 * float(np.abs(want).max()), err
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=2e-2)


# ------------------------------------------------------------------ model
def _batch(seed, b, tt, vocab, lens):
    toks = np.random.default_rng(seed).integers(0, vocab, size=(b, tt)).astype(np.int32)
    return toks, np.asarray(lens, np.int32)


@pytest.mark.parametrize("layer", [0, 3])
def test_layer_forward_matches_jax(pair, layer):
    jcfg, _, jparams, tcfg, _, tparams = pair
    x = np.random.default_rng(3).standard_normal((2, 80, jcfg.d_model)).astype(np.float32)
    lens = np.array([50, 80], np.int32)
    want = jhstu.layer_forward(jcfg, jparams["layers"][layer], jnp.asarray(x), layer=layer,
                               lengths=jnp.asarray(lens), impl="pallas")
    got = hstu.layer_forward(tcfg, tparams["layers"][layer], t(x), layer=layer,
                             lengths=t(lens))
    close(got, want, LOGITS)


@pytest.mark.parametrize("jimpl,mode", [("pallas", "prefill"), ("auto", "train")])
def test_forward_matches_jax(pair, jimpl, mode):
    """Retrieval and ranking logits of 4 layers at T = 80 (past the smoke
    band of 64), ragged ``lengths``; the reference through its Pallas
    kernel (interpret) and through its XLA default."""
    jcfg, jmodel, jparams, _, tmodel, tparams = pair
    toks, lens = _batch(4, 2, 80, jcfg.vocab_size, [50, 80])
    jr, jc, jaux = jmodel.forward(jparams, {"tokens": jnp.asarray(toks),
                                            "lengths": jnp.asarray(lens)},
                                  mode=mode, impl=jimpl)
    tr, tc, taux = tmodel.forward(tparams, {"tokens": t(toks), "lengths": t(lens)},
                                  mode=mode)
    assert jc is None and tc is None
    assert tr.dtype == torch.float32 and tr.shape == (2, 80, jcfg.vocab_size)
    assert taux["ranking_logits"].shape == (2, 80, hstu.N_ENGAGEMENT_TYPES)
    close(tr, jr, LOGITS)
    close(taux["ranking_logits"], jaux["ranking_logits"], LOGITS)


def test_hstu_is_non_autoregressive(pair):
    _, _, _, tcfg, tmodel, tparams = pair
    with pytest.raises(NotImplementedError, match="non-autoregressive"):
        tmodel.init_cache(2, 16, "cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        tmodel.forward(tparams, {"tokens": toks}, mode="decode")
    assert (hstu.N_ENGAGEMENT_TYPES, hstu.MAX_REL_POS, hstu.FULL_ATTN_LAYERS) == (
        jhstu.N_ENGAGEMENT_TYPES, jhstu.MAX_REL_POS, jhstu.FULL_ATTN_LAYERS)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _paths(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _paths(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_and_init_agree_on_names_shapes_dtypes(dtype):
    """The bridged reference tree, the port's own init and the reference
    tree name the same leaves with the same shapes; ``rel_bias`` stays f32
    in a bf16 model."""
    jcfg = SMOKE_CONFIGS["hstu"].replace(dtype=dtype)
    tcfg = get_smoke_config("hstu").replace(dtype=dtype)
    np_params = jax.tree.map(np.asarray, jget_model(jcfg).init(jax.random.PRNGKey(1)))
    bridged = _paths(bridge.params_to_torch(tcfg, np_params, "cpu"))
    own = _paths(get_model(tcfg).init(torch.Generator().manual_seed(0), "cpu"))
    ref_paths = _paths(np_params)
    assert set(bridged) == set(own) == set(ref_paths)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    for name, a in ref_paths.items():
        want = torch.float32 if name.endswith("/rel_bias") else tdt
        assert bridged[name].dtype == own[name].dtype == want, name
        assert tuple(bridged[name].shape) == a.shape == tuple(own[name].shape), name
        np.testing.assert_array_equal(bridged[name].float().numpy(), a.astype(np.float32))


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("seed", [0, 1])
def test_hstu_user_histories_match_reference(seed):
    mine = list(data.hstu_user_histories(5, seed=seed))
    want = list(jdata.hstu_user_histories(5, seed=seed))
    assert len(mine) == len(want) == 5
    for a, b in zip(mine, want):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
        assert 4507 <= len(a) <= 5121 and a.min() >= 0 and a.max() < 6000
