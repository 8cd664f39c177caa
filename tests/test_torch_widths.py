"""The attention kernels' widths: the plain versions at the smoke configs'
head widths against the JAX package, and the CUDA wrappers' coverage of
every registered config.

1. The port's plain versions (the kernels' oracles on the card) at D = Dv =
   16 and 32, MLA's prefill at (96, 64) and its absorbed latent at (96, 64)
   (one KV head, V the view ``k[..., :64]``), in f32 and bf16, against the
   JAX functions: flash and decode through ``pl.pallas_call`` in interpret
   mode (``impl="pallas"``, the reference's own shapes from
   ``tests/test_kernels.py``), the paged decode against the XLA
   ``paged_decode_attention``. Tolerances as ``tests/test_kernels.py``: f32
   atol 2e-5 / rtol 2e-4, bf16 2e-2.
2. Coverage: every (D, Dv, Hq, Hkv) that a registered config's flash,
   decode and paged calls reach (``CONFIGS``, ``CONFIG_SWA`` and
   ``SMOKE_CONFIGS``, bf16 and f32) is accepted by the wrappers' pure
   ``supports`` predicates, but for the paged-pool refusals both packages
   share (the hybrid's rings and the encoder-decoders); the enumeration is
   held against the calls a served smoke config really makes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import attention as jattention
from repro_torch.configs import CONFIGS, SMOKE_CONFIGS, llama3_2_1b
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

TOL = {"float32": dict(atol=2e-5, rtol=2e-4), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(rng, shape, dtype):
    """The same values for both packages: f32 from numpy, rounded to the type
    once (a bf16 array crosses as its f32 widening, exactly)."""
    x = rng.standard_normal(shape).astype(np.float32)
    j = jnp.asarray(x).astype(JDT[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dtype])


def close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **TOL[dtype])


# ------------------------------------------------------------ plain vs JAX
#: (B, T, Hq, Hkv, D, Dv, window): tests/test_kernels.py's D = 16 and 32
#: cases, and MLA's smoke prefill at (96, 64)
FLASH = {"mha 16": (1, 16, 4, 4, 16, 16, None), "gqa 32": (2, 67, 8, 2, 32, 32, None),
         "window 32": (2, 67, 8, 2, 32, 32, 16), "mla prefill 96/64": (1, 40, 4, 4, 96, 64, None)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(FLASH))
def test_flash_plain_matches_jax_pallas(case, dtype):
    b, t, hq, hkv, d, dv, window = FLASH[case]
    rng = np.random.default_rng(0)
    jq, q = both(rng, (b, t, hq, d), dtype)
    jk, k = both(rng, (b, t, hkv, d), dtype)
    jv, v = both(rng, (b, t, hkv, dv), dtype)
    want = jops.flash_attention(jq, jk, jv, causal=True, window=window, impl="pallas",
                                block_q=16, block_k=16)
    got = ops.flash_attention(q, k, v, causal=True, window=window, impl="torch")
    assert got.dtype == TDT[dtype] and got.shape == (b, t, hq, dv)
    close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tq", [5, 16])
def test_flash_latent_plain_matches_jax_pallas(tq, dtype):
    """MLA's smoke latent (D = 96, V the leading 64 columns of the one KV
    head) at a verify window (5) and a chunk (16) over 40 keys, per-row
    positions and k_valid as the paged layer builds them."""
    b, s, hq, d, dv = 2, 40, 4, 96, 64
    rng = np.random.default_rng(1)
    jq, q = both(rng, (b, tq, hq, d), dtype)
    jk, k = both(rng, (b, s, 1, d), dtype)
    start = np.array([3, s - tq], np.int32)
    qpos = (start[:, None] + np.arange(tq, dtype=np.int32)[None]).astype(np.int32)
    kpos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    kval = kpos < (start + tq)[:, None]
    want = jops.flash_attention(jq, jk, jk[..., :dv], q_positions=jnp.asarray(qpos),
                                k_positions=jnp.asarray(kpos), causal=True,
                                k_valid=jnp.asarray(kval), scale=32 ** -0.5, impl="pallas",
                                block_q=16, block_k=16)
    got = ops.flash_attention(q, k, k[..., :dv], q_positions=torch.from_numpy(qpos),
                              k_positions=torch.from_numpy(kpos.copy()),
                              k_valid=torch.from_numpy(kval), causal=True, scale=32 ** -0.5,
                              impl="torch")
    assert fa.is_latent(k, k[..., :dv]) and got.shape == (b, tq, hq, dv)
    close(got, want, dtype)


#: (B, S, Hq, Hkv, D, Dv): tests/test_kernels.py's decode cases at D = 32 and
#: 16, and MLA's smoke latent (one KV head, V = K[..., :64])
DECODE = {"gqa 32": (2, 50, 8, 2, 32, 32), "mha 16": (1, 17, 4, 4, 16, 16),
          "latent 96/64": (3, 50, 4, 1, 96, 64)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(DECODE))
def test_decode_plain_matches_jax_pallas(case, dtype):
    b, s, hq, hkv, d, dv = DECODE[case]
    rng = np.random.default_rng(2)
    jq, q = both(rng, (b, hq, d), dtype)
    jk, k = both(rng, (b, s, hkv, d), dtype)
    if dv < d:
        jv, v = jk[..., :dv], k[..., :dv]
    else:
        jv, v = both(rng, (b, s, hkv, dv), dtype)
    lengths = rng.integers(1, s + 1, (b,)).astype(np.int32)
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(lengths), impl="pallas", block_k=16)
    got = ops.decode_attention(q, k, v, torch.from_numpy(lengths), impl="torch")
    assert got.shape == (b, hq, dv)
    close(got, want, dtype)


#: (B, Hq, Hkv, D, bs, MB); Hkv None: MLA's smoke latent pool [NB, bs, 96]
PAGED = {"gqa 32": (3, 8, 2, 32, 8, 6), "mha 16": (2, 4, 4, 16, 4, 9),
         "latent 96/64": (3, 4, None, 96, 8, 6)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(PAGED))
def test_paged_decode_plain_matches_jax(case, dtype):
    """The paged plain version against the reference's XLA
    ``paged_decode_attention`` over one pool and permuted tables (a freed
    row's all-zero table among them)."""
    b, hq, hkv, d, bs, mb = PAGED[case]
    nb = b * mb + 1
    rng = np.random.default_rng(3)
    jq, q = both(rng, (b, hq, d), dtype)
    shape = (nb, bs, d) if hkv is None else (nb, bs, hkv, d)
    jkb, kb = both(rng, shape, dtype)
    if hkv is None:
        (jvb, vb), kw = (None, None), dict(v_dim=64)
    else:
        (jvb, vb), kw = both(rng, shape, dtype), {}
    bt = (rng.permutation(nb - 1)[: b * mb] + 1).reshape(b, mb).astype(np.int32)
    bt[0] = 0
    n_valid = np.array([3, mb * bs, bs + 1][:b], np.int32)
    want = jattention.paged_decode_attention(jq, jkb, jvb, jnp.asarray(bt),
                                             jnp.asarray(n_valid), **kw)
    got = ops.paged_decode_attention(q, kb, vb, torch.from_numpy(bt),
                                     torch.from_numpy(n_valid), impl="torch", **kw)
    close(got, want, dtype)


# ------------------------------------------------------------ coverage
def attention_calls(cfg):
    """The (kind, D, Dv, Hq, Hkv, latent) every flash ("flash"), decode
    ("decode") and paged-decode ("paged") call of ``cfg``'s model reaches,
    its pool's paged calls None where the paged pool refuses the family."""
    fam = cfg.family
    if fam in ("ssm", "hstu"):  # no flash or decode attention (HSTU has its own kernel)
        return set()
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if fam == "mla_moe":
        m = cfg.mla
        lat = m.kv_lora_rank + m.qk_rope_dim
        return {("flash", m.qk_nope_dim + m.qk_rope_dim, m.v_head_dim, h, h, False),
                ("flash", lat, m.kv_lora_rank, h, 1, True),
                ("decode", lat, m.kv_lora_rank, h, 1, True),
                ("paged", lat, m.kv_lora_rank, h, 1, True)}
    calls = {("flash", dh, dh, h, hkv, False), ("decode", dh, dh, h, hkv, False)}
    if fam in ("dense", "vlm", "moe"):
        calls.add(("paged", dh, dh, h, hkv, False))
    return calls


def accepted(call, dtype) -> bool:
    kind, d, dv, hq, hkv, latent = call
    if kind == "flash":
        return fa.supports(d, dv, hq, hkv, dtype, latent)
    return da.supports(d, dv, hq, hkv, dtype, latent, paged=kind == "paged")


REGISTERED = {**{k: c for k, c in CONFIGS.items()},
              **{f"{k} smoke": c for k, c in SMOKE_CONFIGS.items()},
              "llama3.2-1b swa": llama3_2_1b.CONFIG_SWA}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", list(REGISTERED))
def test_every_registered_config_runs_on_the_kernels(name, dtype):
    cfg = REGISTERED[name]
    calls = attention_calls(cfg)
    refused = [c for c in calls if not accepted(c, dtype)]
    assert not refused, f"{name}: the CUDA wrappers refuse {refused} in {dtype}"
    if cfg.family in ("hybrid", "encdec", "seamless"):  # the shared paged refusal
        assert not any(c[0] == "paged" for c in calls)


def test_supports_refuses_what_no_kernel_takes():
    f32, bf = torch.float32, torch.bfloat16
    assert not fa.supports(48, 48, 8, 2, bf)  # a width no kernel is instantiated at
    assert not fa.supports(576, 512, 128, 1, f32)  # the latent's widths, but no latent form
    assert fa.supports(576, 512, 128, 1, f32, latent=True)
    assert not fa.supports(96, 64, 4, 2, bf, latent=True)  # a latent has one KV head
    assert not fa.supports(32, 32, 65 * 2, 2, bf)  # G = 65 > MAX_GROUP
    assert not fa.supports(32, 32, 8, 2, torch.float16)
    assert da.supports(256, 256, 10, 1, bf) and not da.supports(256, 256, 10, 1, bf,
                                                                 paged=True)
    assert not da.supports(32, 32, 65, 1, f32)  # G * D = 2080 > 2048
    assert da.supports(16, 16, 128, 1, f32) and not da.supports(16, 16, 129, 1, f32)
    assert not da.supports(192, 128, 128, 128, bf)  # the MLA prefill width: flash only


@pytest.mark.parametrize("arch", ["llama3.2-1b", "chameleon-34b", "deepseek-v2-236b",
                                  "recurrentgemma-2b", "whisper-base"])
def test_the_enumeration_holds_what_a_served_smoke_config_calls(arch, monkeypatch):
    """The calls a smoke config makes through ``ops`` when served (contiguous,
    and paged + chunked where the pool takes the family; beam groups for the
    encoder-decoder) are all in ``attention_calls``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import profiles
    from repro_torch.core.scheduler import Scheduler, ServeRequest
    from repro_torch.models import get_model

    seen = set()

    def spy(kind, real):
        def fn(q, k, v, *a, **kw):
            if kind == "paged":
                latent = v is None
                hkv = 1 if k.dim() == 3 else k.shape[2]
                dv = kw.get("v_dim") if latent else v.shape[-1]
            else:
                latent = k.shape[2] == 1 and v.shape[-1] < k.shape[-1]
                hkv, dv = k.shape[2], v.shape[-1]
            hq = q.shape[-2]
            seen.add((kind, q.shape[-1], dv, hq, hkv, latent))
            return real(q, k, v, *a, **kw)
        return fn

    monkeypatch.setattr(ops, "flash_attention", spy("flash", ops.flash_attention))
    monkeypatch.setattr(ops, "decode_attention", spy("decode", ops.decode_attention))
    monkeypatch.setattr(ops, "paged_decode_attention",
                        spy("paged", ops.paged_decode_attention))
    cfg = get_smoke_config(arch).replace(dtype="float32")
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    geometries = [{}]
    if cfg.family in ("dense", "vlm", "moe", "mla_moe"):
        geometries.append(dict(paged=True, chunked=True, block_size=8, prefill_budget=8))
    pad = 40 if cfg.family == "hybrid" else 12
    with torch.inference_mode():
        for geo in geometries:
            if cfg.encdec is not None:
                frames = torch.from_numpy(rng.standard_normal(
                    (1, cfg.encdec.n_frames, cfg.d_model)).astype(np.float32))
                reqs = [ServeRequest(rid=0, prompt=np.asarray([1]), max_new=4,
                                     profile=profiles.BeamProfile(n_beams=2, eos_id=2),
                                     extra_inputs={"frames": frames})]
                pad = 1
            else:
                reqs = [ServeRequest(rid=i, prompt=rng.integers(0, cfg.vocab_size, pad),
                                     max_new=4) for i in range(3)]
            Scheduler(model, params, slots=4, pad_to=pad, max_new_cap=4, device="cpu",
                      **geo).run(reqs)
    want = attention_calls(cfg)
    assert seen and seen <= want, f"{arch}: calls {seen - want} are not enumerated"
