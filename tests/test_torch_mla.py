"""The port's Multi-head Latent Attention (DeepSeek-V2) against the JAX
package, on the f32 ``deepseek-v2-smoke`` config (q_lora 128, kv_lora 64,
nope 64, rope 32, v_head 64; layer 0 dense, layer 1 MoE with a shared
expert): params come from the reference's ``init(PRNGKey(0))`` through
``repro_torch.bridge``, inputs are made with numpy and handed to both
sides.

- ``mla_attention`` in every mode it serves: train and prefill (flash at
  D = nope + rope, Dv = v_head over the expanded latent), contiguous decode
  and verify, and paged decode, mixed and verify (absorbed against the
  latent), output and the latent written, at atol 2e-5 / rtol 2e-4;
- ``ops.paged_decode_attention``'s plain version in the latent form
  (``vbuf=None, v_dim``, a 3-D pool) against the reference's
  ``paged_decode_attention``;
- the block ops on the 3-D latent leaves (``append_block``, ``copy_block``);
- the whole model's logits in every mode (atol 1e-4 / rtol 1e-3);
- the served tokens through the port's and the reference's ``Scheduler``
  (the arms and the near-tie rule of ``tests/test_torch_moe.py``), plus 2-beam
  groups on the chunked pool (table permutations and copy-on-write copies
  of latent blocks), with exact host counts;
- the pools' tokens agree under dropless capacity."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import profiles as jprofiles
from repro.core.scheduler import Scheduler as JScheduler
from repro.core.scheduler import ServeRequest as JRequest
from repro.models import attention as JA
from repro_torch.core import kv_cache, profiles
from repro_torch.core.scheduler import Scheduler, ServeRequest
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from tests.test_torch_moe import (ARMS, F32, MODES, check_cross_pool, check_model_modes,
                                  pair_of, serve_both)

ARCH = "deepseek-v2-236b"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while the module runs: its serving loops are
    many tiny eager ops, which a thread pool only slows beside other test
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return pair_of(ARCH)


def t(a):
    return torch.from_numpy(np.array(a))


def _tables(rng, b, mb, nb):
    """Disjoint random tables; the last row freed (all sink block 0)."""
    bt = rng.permutation(np.arange(1, nb))[: b * mb].reshape(b, mb).astype(np.int32)
    bt[-1] = 0
    return bt


# ------------------------------------------------------------ the layer
@pytest.mark.parametrize("mode", ["prefill", "decode", "verify", "paged decode", "paged mixed",
                                  "paged verify"])
def test_mla_attention_matches_jax(pair, mode):
    """Layer 0's MLA on one input: the output of every live lane and the
    latent it wrote (the sink block, which padding lanes write in any
    order, excluded). Prefill also runs cache-less (train)."""
    jmodel, jparams, model, params = pair
    cfg, jcfg = model.config, jmodel.config
    jp, tp = jparams["layers"][0]["attn"], params["layers"][0]["attn"]
    rng = np.random.default_rng(5)
    b, width = 4, {"prefill": 9, "decode": 1, "mixed": 4, "verify": 4}[mode.split()[-1]]
    x = rng.standard_normal((b, width, cfg.d_model)).astype(np.float32)
    lat_w = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim
    if mode == "prefill":
        pos = np.broadcast_to(np.arange(width, dtype=np.int32), (b, width))
        jout, _ = JA.mla_attention(jcfg, jp, jnp.asarray(x), positions=jnp.asarray(pos),
                                   lengths=None, cache=None, mode="train")
        tout, _ = A.mla_attention(cfg, tp, t(x), positions=t(pos), lengths=None, cache=None,
                                  mode="train")
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **F32)
        lengths = np.zeros(b, np.int32)
        jc = JA.init_mla_cache(jcfg, b, 12)
        tc = A.init_mla_cache(cfg, b, 12, "cpu")
        t_new, live = None, np.full(b, width)
    else:
        lengths = np.array([3, 0, 7, 5], np.int32)
        pos = lengths[:, None] + np.arange(width, dtype=np.int32)[None]
        t_new = np.array([4, 1, 2, 0], np.int32) if width > 1 else None
        live = t_new if t_new is not None else np.ones(b, np.int32)
        if mode.startswith("paged"):
            nb, bs, mb = 16, 4, 3
            lat = rng.standard_normal((nb, bs, lat_w)).astype(np.float32)
            bt = _tables(rng, b, mb, nb)
            jc = {"latent": jnp.asarray(lat), "bt": jnp.asarray(bt)}
            tc = {"latent": t(lat), "bt": t(bt)}
            if t_new is None:
                live = np.array([1, 1, 1, 0])  # the freed row reads the sink block
        else:
            lat = rng.standard_normal((b, 12, lat_w)).astype(np.float32)
            jc, tc = {"latent": jnp.asarray(lat)}, {"latent": t(lat)}
    step = mode.split()[-1]
    jout, jnew = JA.mla_attention(
        jcfg, jp, jnp.asarray(x), positions=jnp.asarray(pos), lengths=jnp.asarray(lengths),
        cache=jc, mode=step, t_new=None if t_new is None else jnp.asarray(t_new))
    with torch.inference_mode():
        tout, tnew = A.mla_attention(cfg, tp, t(x), positions=t(pos), lengths=t(lengths),
                                     cache=tc, mode=step,
                                     t_new=None if t_new is None else t(t_new))
    for r in range(b):
        np.testing.assert_allclose(tout.numpy()[r, :live[r]], np.asarray(jout)[r, :live[r]],
                                   **F32)
    assert tnew["latent"] is tc["latent"]  # written in place
    lo = 1 if mode.startswith("paged") else 0
    np.testing.assert_allclose(tnew["latent"].numpy()[lo:], np.asarray(jnew["latent"])[lo:],
                               **F32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,r,rope,bs", [(4, 64, 32, 4), (16, 32, 16, 8)])
def test_paged_decode_latent_plain_matches_jax(g, r, rope, bs, dtype):
    """The latent form of the paged decode: a [NB, bs, r + rope] pool, V its
    leading r columns, Hkv = 1, the last row's table freed."""
    rng = np.random.default_rng(8)
    b, mb, nb = 3, 4, 14
    q = rng.standard_normal((b, g, r + rope)).astype(np.float32)
    pool = rng.standard_normal((nb, bs, r + rope)).astype(np.float32)
    bt = _tables(rng, b, mb, nb)
    n_valid = np.array([1, mb * bs, 5], np.int32)
    scale = 0.3
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = JA.paged_decode_attention(jnp.asarray(q, jdt), jnp.asarray(pool, jdt), None,
                                     jnp.asarray(bt), jnp.asarray(n_valid), scale=scale,
                                     v_dim=r)
    got = ops.paged_decode_attention(t(q).to(dtype), t(pool).to(dtype), None, t(bt),
                                     t(n_valid), scale=scale, v_dim=r)
    assert got.shape == (b, g, r) and got.dtype == dtype
    tol = F32 if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def test_block_ops_on_latent_leaves(pair):
    """append_block and copy_block on the 3-D latent pool of a BlockPool."""
    _, _, model, _ = pair
    rng = np.random.default_rng(3)
    pool = model.init_cache(6, 4, "cpu")
    row = model.init_cache(1, 10, "cpu")
    for leaf in kv_cache.leaves(row["layers"]):
        leaf.copy_(torch.from_numpy(rng.standard_normal(leaf.shape).astype(np.float32)))
    kv_cache.append_block(pool["layers"], row["layers"], 2, 8)  # a block past the row's end
    kv_cache.copy_block(pool["layers"], 2, 5)
    for p, r in zip(kv_cache.leaves(pool["layers"]), kv_cache.leaves(row["layers"])):
        assert p.dim() == 3
        np.testing.assert_array_equal(p[2, :2].numpy(), r[0, 8:10].numpy())
        assert not p[2, 2:].any()
        np.testing.assert_array_equal(p[5].numpy(), p[2].numpy())


# ------------------------------------------------------------ the model
@pytest.mark.parametrize("mode", MODES)
def test_model_logits_match_jax(pair, mode):
    check_model_modes(pair, mode)


@pytest.mark.parametrize("arm", list(ARMS))
def test_served_tokens_match_jax_scheduler(pair, arm):
    serve_both(pair, arm)


def test_beam_groups_on_latent_blocks_match_jax(pair):
    """2-beam groups beside plain requests on the chunked pool: the group's
    KV reorder is a table permutation plus copy-on-write copies of latent
    blocks. Tokens, scores and every group counter equal the reference's."""
    jmodel, jparams, model, params = pair
    rng = np.random.default_rng(6)
    geometry = dict(slots=4, pad_to=8, max_new_cap=6, paged=True, chunked=True, block_size=4,
                    num_blocks=12, prefill_budget=4)
    traffic = [(i, rng.integers(3, model.config.vocab_size, size=int(rng.integers(3, 9))),
                int(rng.integers(3, 7)), i % 2 == 0) for i in range(5)]
    mine = Scheduler(model, params, device="cpu", **geometry)
    ref = JScheduler(jmodel, jparams, **geometry)
    got = mine.run([ServeRequest(rid=i, prompt=p, max_new=m,
                                 profile=profiles.BeamProfile(n_beams=2, eos_id=2) if beam
                                 else None) for i, p, m, beam in traffic])
    want = ref.run([JRequest(rid=i, prompt=p, max_new=m,
                             profile=jprofiles.BeamProfile(n_beams=2, eos_id=2) if beam
                             else None) for i, p, m, beam in traffic])
    want = {r.rid: r for r in want}
    for r in got:
        assert r.tokens == [int(x) for x in want[r.rid].tokens], f"request {r.rid}"
        if want[r.rid].score is not None:
            assert abs(r.score - want[r.rid].score) <= 1e-4

    def counters(s):
        return (s.n_preemptions, s.n_decode_steps, s.n_mixed_steps, s.n_chunks,
                s.n_group_admissions, s.n_block_permutes, s.pool.n_cow_copies)

    assert counters(mine) == counters(ref)
    assert mine.n_block_permutes >= 1 and mine.pool.n_cow_copies >= 1
    assert mine.pool.n_used_blocks == 0


def test_pools_agree_under_dropless_capacity(pair):
    check_cross_pool(pair)
