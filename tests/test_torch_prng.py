"""The port's Threefry-2x32 (``repro_torch.core.prng``) against
``jax.random`` (jax 0.9.0 runs with ``jax_threefry_partitionable``
on, the layout the port copies): ``PRNGKey``, ``fold_in``, ``split`` and
``bits`` bit for bit over a sweep of seeds, data and 1-D / 2-D / 3-D
shapes; ``uniform`` exactly; ``gumbel`` within 2 ulp (two ``log``s that XLA
and torch round apart in the last bit now and then), the ulp taken at a
magnitude of at least 1: near g = 0 the outer log sees -log(u) close to 1,
whose one-ulp rounding moves g by 2**-23 absolutely; ``categorical`` tokens
equal except where the reference's top-two perturbed scores are within
1e-5, each such case reported."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng

SEEDS = [0, 1, 42, 9, 2**31 - 1, -1, -(2**31), 123456789]
DATA = [0, 1, 7, 2**16 + 3, 2**31 - 1, 2**32 - 1]
SHAPES = [(1,), (7,), (64,), (3, 5), (4, 129), (2, 3, 4)]
NEAR_TIE = 1e-5


def _j(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


def ulps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """|got - want| in f32 units in the last place of max(|want|, 1)."""
    unit = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    return np.abs(got.astype(np.float64) - want.astype(np.float64)) / unit


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_bit_exact(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), _j(jk))
    for d in DATA:
        np.testing.assert_array_equal(prng.fold_in(tk, d).numpy(), _j(jax.random.fold_in(jk, d)))
    for num in (1, 2, 3, 8):
        np.testing.assert_array_equal(prng.split(tk, num).numpy(), _j(jax.random.split(jk, num)))
    # the hash in Python integers (split) and in tensor ops (bits, fold_in)
    # agree
    key = prng.fold_in(tk, 5)
    np.testing.assert_array_equal(prng.split(key, 4).numpy(),
                                  torch.stack(prng.threefry2x32(
                                      key[0], key[1], torch.zeros(4, dtype=torch.int64),
                                      torch.arange(4)), dim=-1).numpy())


def test_fold_in_vectorised_matches_vmap():
    """A batch of keys folded with a batch of data (the scheduler's
    per-slot keys) equals ``vmap(fold_in)``; a [B, 1, 2] key against [B, C]
    data broadcasts per lane."""
    rng = np.random.default_rng(0)
    keys = jax.random.split(jax.random.PRNGKey(3), 6)
    data = rng.integers(0, 2**31, size=6)
    want = jax.vmap(jax.random.fold_in)(keys, jnp.asarray(data, jnp.uint32))
    got = prng.fold_in(torch.from_numpy(_j(keys)), torch.from_numpy(data))
    np.testing.assert_array_equal(got.numpy(), _j(want))
    lanes = rng.integers(0, 1000, size=(6, 4))
    want = jax.vmap(jax.vmap(jax.random.fold_in, in_axes=(None, 0)))(
        keys, jnp.asarray(lanes, jnp.uint32))
    got = prng.fold_in(torch.from_numpy(_j(keys))[:, None], torch.from_numpy(lanes))
    np.testing.assert_array_equal(got.numpy(), _j(want))
    # numpy keys hash on the host, to the same words
    host = prng.fold_in(_j(keys)[:, None], lanes)
    assert isinstance(host, np.ndarray)
    np.testing.assert_array_equal(host, _j(want))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_bits_and_uniform_exact(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(prng.bits(tk, shape).numpy(), _j(jax.random.bits(jk, shape)))
    for lo, hi in ((0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0), (-2.0, 3.0),
                   (0.3, 0.7)):
        want = np.asarray(jax.random.uniform(jk, shape, minval=lo, maxval=hi))
        got = prng.uniform(tk, shape, minval=lo, maxval=hi).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"uniform [{lo}, {hi})")


def test_bits_per_key_batch_matches_vmap():
    keys = jax.random.split(jax.random.PRNGKey(11), 5)
    want = jax.vmap(lambda k: jax.random.bits(k, (33,)))(keys)
    got = prng.bits(torch.from_numpy(_j(keys)), (33,))
    np.testing.assert_array_equal(got.numpy(), _j(want))


@pytest.mark.parametrize("shape", SHAPES)
def test_gumbel_within_two_ulp(shape):
    worst = 0
    for seed in SEEDS[:4]:
        want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), shape))
        got = prng.gumbel(prng.PRNGKey(seed), shape).numpy()
        assert np.isfinite(got).all()
        worst = max(worst, float(ulps(got, want).max()))
    assert worst <= 2, f"gumbel differs by {worst} ulp"


@pytest.mark.parametrize("b,v,scale", [(4, 512, 1.0), (16, 97, 3.0), (2, 5000, 0.3)])
def test_categorical_tokens_equal_up_to_near_ties(b, v, scale):
    rng = np.random.default_rng(v)
    n_ties = 0
    for seed in range(10):
        logits = (rng.normal(size=(b, v)) * scale).astype(np.float32)
        jk = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.categorical(jk, jnp.asarray(logits)))
        got = prng.categorical(prng.PRNGKey(seed), torch.from_numpy(logits)).numpy()
        scores = np.asarray(jax.random.gumbel(jk, (b, v))) + logits
        for r in np.nonzero(got != want)[0]:
            top2 = np.sort(scores[r])[-2:]
            gap = float(top2[1] - top2[0])
            assert gap < NEAR_TIE, f"seed {seed} row {r}: {got[r]} vs {want[r]}, gap {gap}"
            print(f"categorical near tie: seed {seed} row {r} (gap {gap:.2e})")
            n_ties += 1
    assert n_ties <= 1
