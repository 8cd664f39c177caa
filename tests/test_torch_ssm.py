"""The port's Mamba-2 slice vs the JAX package: ``ops.ssd_scan`` (the
kernel's plain version on the CPU) against the Pallas kernel in interpret
mode and the sequential oracle, the decode recurrence, the f32
``mamba2-130m`` smoke model in train / prefill / decode modes (params
bridged from the reference's ``init(PRNGKey(0))``), greedy generation, the
continuous and fixed schedulers on right-padded prompts (the reference
scans the padding into the state, and so does the port), and the launcher.

Scans are held at the reference's own SSD tolerance (atol 2e-4 / rtol
2e-3, ``tests/test_kernels.py``): chunked and sequential sums differ in
order. Logits at atol 1e-4 / rtol 1e-3 (matmuls and the f32 unembed sum in
another order in XLA and PyTorch). Greedy tokens must match exactly; a
divergence passes only where the reference's top-1/top-2 gap is below 1e-4,
and is reported."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_CONFIGS
from repro.core import engine as jengine
from repro.core import sampling as jsampling
from repro.core.scheduler import Scheduler as JScheduler
from repro.core.scheduler import ServeRequest as JRequest
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import get_model as jget_model
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core import engine
from repro_torch.core.scheduler import Scheduler, ServeRequest
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ss
from repro_torch.launch import serve
from repro_torch.models import get_model

SSD = dict(atol=2e-4, rtol=2e-3)
LOGITS = dict(atol=1e-4, rtol=1e-3)
ARCH = "mamba2-130m"
PAD_TO = 8
NEAR_TIE = 1e-4


@pytest.fixture(scope="module")
def pair():
    jcfg = SMOKE_CONFIGS[ARCH].replace(dtype="float32")
    jmodel = jget_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = get_smoke_config(ARCH).replace(dtype="float32")
    tparams = bridge.params_to_torch(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jmodel, jparams, tcfg, get_model(tcfg), tparams


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               **tol)


def _ssd_inputs(seed, b, tt, h, p, g, n):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    x, dt_raw, a_raw = r(b, tt, h, p), r(b, tt, h), r(h)
    dt = np.log1p(np.exp(dt_raw)).astype(np.float32)  # softplus
    return (x, dt, (-np.exp(a_raw)).astype(np.float32), r(b, tt, g, n), r(b, tt, g, n),
            r(h), r(b, h, p, n))


# ---------------------------------------------------------------- kernel
@pytest.mark.parametrize(
    "b,tt,h,p,g,n,chunk",
    [(1, 16, 2, 8, 1, 4, 8), (2, 37, 4, 16, 2, 8, 16), (1, 64, 8, 32, 1, 16, 32),
     (1, 5, 2, 16, 1, 8, 256)],
)
def test_ssd_scan_matches_pallas_and_ref(b, tt, h, p, g, n, chunk):
    """The sweep shapes of the reference's SSD test with ``initial_state``
    (G = 2 and a T that is no chunk multiple included), and a T below the
    chunk."""
    x, dt, A, B_, C, D, init = _ssd_inputs(b * 100 + tt, b, tt, h, p, g, n)
    jargs = [jnp.asarray(a) for a in (x, dt, A, B_, C, D)]
    jy, js = jops.ssd_scan(*jargs, chunk=chunk, initial_state=jnp.asarray(init),
                           impl="pallas")
    ry, rs = jref.ssd_ref(*jargs, initial_state=jnp.asarray(init))
    ty, ts = ops.ssd_scan(*(t(a) for a in (x, dt, A, B_, C, D)), chunk=chunk,
                          initial_state=t(init))
    assert ty.dtype == torch.float32 and ts.shape == (b, h, p, n)
    for got, want in ((ty, jy), (ts, js), (ty, ry), (ts, rs)):
        close(got, want, SSD)
    oy, os_ = ref.ssd_ref(*(t(a) for a in (x, dt, A, B_, C, D)), initial_state=t(init))
    close(oy, ry, SSD)
    close(os_, rs, SSD)


def test_ssd_scan_without_initial_state_and_cuda_refusal():
    x, dt, A, B_, C, D, _ = _ssd_inputs(7, 1, 20, 2, 8, 1, 4)
    jy, js = jops.ssd_scan(*(jnp.asarray(a) for a in (x, dt, A, B_, C, D)), chunk=8,
                           impl="pallas")
    args = [t(a) for a in (x, dt, A, B_, C, D)]
    ty, ts = ops.ssd_scan(*args, chunk=8)
    close(ty, jy, SSD)
    close(ts, js, SSD)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.ssd_scan(*args, chunk=8, impl="cuda")


def test_ssd_decode_step_chain_equals_scan():
    """Sequential decode steps equal the oracle over the same tokens, on
    both sides."""
    x, dt, A, B_, C, D, _ = _ssd_inputs(9, 2, 6, 4, 8, 2, 4)
    ry, rs = jref.ssd_ref(*(jnp.asarray(a) for a in (x, dt, A, B_, C, D)))
    state = torch.zeros((2, 4, 8, 4))
    ys = []
    for i in range(6):
        y, state = ops.ssd_decode_step(t(x[:, i]), t(dt[:, i]), t(A), t(B_[:, i]),
                                       t(C[:, i]), t(D), state)
        ys.append(y)
    close(torch.stack(ys, 1), ry, dict(atol=1e-4, rtol=0))
    close(state, rs, dict(atol=1e-4, rtol=0))
    jy, jstate = jops.ssd_decode_step(*(jnp.asarray(a[:, 0]) if a.ndim > 1 else
                                        jnp.asarray(a) for a in (x, dt, A, B_, C, D)),
                                      jnp.zeros((2, 4, 8, 4)))
    close(ys[0], jy, dict(atol=1e-5, rtol=1e-5))


# ------------------------------------------------- the bf16 kernel's stages


def _card_inputs(seed, b, tt, h, p, g, n, init):
    """The card tests' input law: x, B, C ~ N(0, 1) rounded to bf16,
    dt = 0.1 softplus(N(0, 1)), A = -(1..16), D = 1, an N(0, 1) state."""
    rng = np.random.default_rng(seed)

    def bf(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)

    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((b, tt, h)).astype(np.float32))) * 0.1
    init = (torch.from_numpy(rng.standard_normal((b, h, p, n)).astype(np.float32))
            if init else None)
    return bf(b, tt, h, p), dt, -torch.linspace(1.0, 16.0, h), bf(b, tt, g, n), \
        bf(b, tt, g, n), torch.ones(h), init


def _stages(x, dt, A, B_, C, D, chunk, init, operand=None):
    """y and the final state through the three plain stages, as the bf16
    kernels compose them; ``operand`` emulates the tensor cores' view of
    the f32 operands."""
    cum = ss.chunk_cumsum_plain(dt, A, chunk)
    states = ss.chunk_state_plain(x, dt, B_, cum, chunk, operand=operand)
    h_prev, h_t = ss.state_passing_plain(states, cum, init)
    return ss.chunk_scan_plain(x, dt, B_, C, D, cum, h_prev, chunk, operand=operand), h_t


def _hi_lo(v):
    return sum(half.float() for half in ss.split_bf16(v))


def _bf16_once(v):
    return v.to(torch.bfloat16).float()


STAGE_CASES = {  # (B, T, H, P, G, N, chunk, initial state)
    "4 ragged chunks G=2 init": (2, 461, 8, 64, 2, 128, 128, True),
    "served width": (1, 256, 24, 64, 1, 128, 256, False),
    "T < chunk": (1, 5, 2, 16, 1, 8, 256, True),
}


@pytest.mark.parametrize("case", list(STAGE_CASES))
def test_ssd_stages_compose_to_plain_and_jax(case):
    """Chunk state, state passing and chunk scan compose to the one-piece
    plain version (f32, the same sums) and to the JAX package's Pallas
    kernel (interpret mode) at the SSD tolerance, on the card tests' input
    law in f32."""
    b, tt, h, p, g, n, chunk, init = STAGE_CASES[case]
    args = [a.float() for a in _card_inputs(b * 1000 + tt, b, tt, h, p, g, n, init)[:6]]
    h0 = _card_inputs(7, b, 1, h, p, g, n, init)[-1]
    y, h_t = _stages(*args, chunk, h0)
    wy, ws = ss.ssd_scan_plain(*args, chunk=chunk, initial_state=h0)
    close(y, wy, dict(atol=1e-5, rtol=1e-5))
    close(h_t, ws, dict(atol=1e-5, rtol=1e-5))
    jy, js = jops.ssd_scan(*(jnp.asarray(a.numpy()) for a in args), chunk=chunk,
                           initial_state=None if h0 is None else jnp.asarray(h0.numpy()),
                           impl="pallas")
    close(y, jy, SSD)
    close(h_t, js, SSD)


@pytest.mark.parametrize("case", ["4 ragged chunks G=2 init", "served width",
                                  "one 128-chunk, 8 heads"])
def test_ssd_hi_lo_split_holds_the_state(case):
    """Every f32 operand of the bf16 kernels' products (x sw, W and h_prev)
    split in two bf16 halves: the final state stays within the SSD
    tolerance of the plain version on the same bf16 inputs, and y within
    the bf16 tolerance."""
    b, tt, h, p, g, n, chunk, init = STAGE_CASES.get(case, (1, 128, 8, 64, 1, 128, 128, False))
    x, dt, A, B_, C, D, h0 = _card_inputs(tt, b, tt, h, p, g, n, init)
    y, h_t = _stages(x, dt, A, B_, C, D, chunk, h0, operand=_hi_lo)
    wy, ws = ss.ssd_scan_plain(x, dt, A, B_, C, D, chunk=chunk, initial_state=h0)
    close(h_t, ws, SSD)
    close(y, wy.float(), dict(atol=2e-2, rtol=2e-2))


def test_ssd_single_bf16_rounding_misses_the_state():
    """Why the operands are split: rounded once to bf16, the f32 factor
    x sw of the state update puts thousands of state elements outside the
    SSD tolerance (one 128-chunk, P 64, N 128, 8 heads)."""
    x, dt, A, B_, C, D, _ = _card_inputs(128, 1, 128, 8, 64, 1, 128, False)
    _, h_t = _stages(x, dt, A, B_, C, D, 128, None, operand=_bf16_once)
    _, ws = ss.ssd_scan_plain(x, dt, A, B_, C, D, chunk=128)
    bad = int(((h_t - ws).abs() > SSD["atol"] + SSD["rtol"] * ws.abs()).sum())
    assert bad > 1000, bad


@pytest.mark.parametrize("b,tt,h,chunk,dtype,want", [
    (1, 256, 24, 256, torch.bfloat16, ("ssd_chunk_state_kernel", "ssd_chunk_scan_kernel")),
    (2, 461, 8, 128, torch.bfloat16, ("ssd_chunk_state_kernel", "ssd_state_passing_kernel",
                                      "ssd_chunk_scan_kernel")),
    (1, 5, 2, 256, torch.bfloat16, ("ssd_chunk_state_kernel", "ssd_chunk_scan_kernel")),
    (1, 0, 2, 256, torch.bfloat16, ("ssd_state_passing_kernel",)),
    (0, 256, 24, 256, torch.bfloat16, ()),
    (1, 256, 24, 256, torch.float32, ("ssd_scan_kernel",)),
    (2, 461, 8, 128, torch.float32, ("ssd_scan_kernel",)),
])
def test_ssd_launch_plan(b, tt, h, chunk, dtype, want):
    """The kernels one call launches: the walk for f32; for bf16 the chunk
    state and the chunk scan around the state passing, which one chunk
    folds into the chunk state and no chunk reduces to (the final state is
    the initial one)."""
    assert ss.launch_plan(b, tt, h, 64, 1, 128, chunk, dtype) == want


def test_ssd_state_passing_without_chunks_returns_the_initial_state():
    h0 = torch.randn((1, 2, 4, 8))
    before, h_t = ss.state_passing_plain(torch.zeros((1, 2, 0, 4, 8)),
                                         torch.zeros((1, 2, 0, 16)), h0)
    assert torch.equal(h_t, h0) and before.shape == (1, 2, 0, 4, 8)


# ------------------------------------------------------------------ model
def test_forward_train_prefill_decode_match_jax(pair):
    """Train logits; prefill (cache) logits, conv tails, states and
    lengths; then three decode steps and one 5-token extend (the scan from
    an initial state) — all against the reference."""
    jcfg, jmodel, jparams, _, tmodel, tparams = pair
    rng = np.random.default_rng(3)
    b, tp = 2, 40  # 40 > chunk 32: two chunks, the second ragged
    toks = rng.integers(0, jcfg.vocab_size, size=(b, tp)).astype(np.int32)
    jlog, _, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)}, mode="train")
    tlog, _, _ = tmodel.forward(tparams, {"tokens": t(toks)}, mode="train")
    close(tlog, jlog, LOGITS)

    plen = np.array([40, 23], np.int32)
    jc = jmodel.init_cache(b, 64)
    tc = tmodel.init_cache(b, 64, "cpu")
    jlog, jc, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks),
                                           "prompt_lengths": jnp.asarray(plen)},
                                 cache=jc, mode="prefill")
    with torch.inference_mode():
        tlog, tc, _ = tmodel.forward(tparams, {"tokens": t(toks), "prompt_lengths": t(plen)},
                                     cache=tc, mode="prefill")
    close(tlog, jlog, LOGITS)

    def same_cache():
        np.testing.assert_array_equal(tc["lengths"].numpy(), np.asarray(jc["lengths"]))
        for tl, jl in zip(tc["layers"], jc["layers"]):
            close(tl["conv"], jl["conv"], LOGITS)
            close(tl["state"], jl["state"], SSD)

    same_cache()
    for _ in range(3):
        nxt = rng.integers(0, jcfg.vocab_size, size=(b, 1)).astype(np.int32)
        jlog, jc, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(nxt)}, cache=jc,
                                     mode="decode")
        with torch.inference_mode():
            tlog, tc, _ = tmodel.forward(tparams, {"tokens": t(nxt)}, cache=tc,
                                         mode="decode")
        close(tlog, jlog, LOGITS)
        same_cache()
    # extend: a 5-token chunk scanned from the cached state and conv tail
    nxt = rng.integers(0, jcfg.vocab_size, size=(b, 5)).astype(np.int32)
    jlog, jc, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(nxt)}, cache=jc,
                                 mode="extend")
    with torch.inference_mode():
        tlog, tc, _ = tmodel.forward(tparams, {"tokens": t(nxt)}, cache=tc, mode="extend")
    close(tlog, jlog, LOGITS)
    same_cache()


def test_prefill_then_decode_equals_full_forward(pair):
    """The port alone: prefill of 12 tokens and 4 decode steps give the
    full forward's logits at those positions (the reference's own cache
    test, ``tests/test_cache.py``)."""
    _, _, _, tcfg, tmodel, tparams = pair
    toks = t(np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, 16)).astype(np.int32))
    with torch.inference_mode():
        full, _, _ = tmodel.forward(tparams, {"tokens": toks}, mode="train")
        cache = tmodel.init_cache(2, 20, "cpu")
        pf, cache, _ = tmodel.forward(tparams, {"tokens": toks[:, :12]}, cache=cache,
                                      mode="prefill")
        atol = 2e-4 * max(float(full.abs().max()), 1.0)
        close(pf, full[:, :12].numpy(), dict(atol=atol, rtol=0))
        for i in range(4):
            dl, cache, _ = tmodel.forward(tparams, {"tokens": toks[:, 12 + i:13 + i]},
                                          cache=cache, mode="decode")
            close(dl[:, 0], full[:, 12 + i].numpy(), dict(atol=atol, rtol=0))
            assert int(cache["lengths"][0]) == 13 + i


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _paths(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _paths(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_and_init_agree_on_names_shapes_dtypes(dtype):
    """Bridged reference params, the port's own init and the reference
    tree name the same leaves with the same shapes; ``A_log``, ``D`` and
    ``dt_bias`` stay f32 in a bf16 model; caches agree too."""
    jcfg = SMOKE_CONFIGS[ARCH].replace(dtype=dtype)
    tcfg = get_smoke_config(ARCH).replace(dtype=dtype)
    jmodel = jget_model(jcfg)
    np_params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(1)))
    bridged = _paths(bridge.params_to_torch(tcfg, np_params, "cpu"))
    own = _paths(get_model(tcfg).init(torch.Generator().manual_seed(0), "cpu"))
    ref_paths = _paths(np_params)
    extra = {"/embed/table_f32"} if dtype == "bfloat16" else set()
    assert set(bridged) == set(own) == set(ref_paths) | extra
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    for name, a in ref_paths.items():
        f32 = name.rsplit("/", 1)[-1] in ("A_log", "D", "dt_bias")
        want = torch.float32 if f32 else tdt
        assert bridged[name].dtype == own[name].dtype == want, name
        assert tuple(bridged[name].shape) == a.shape == tuple(own[name].shape), name
    jcache = _paths(bridge.cache_to_torch(jax.tree.map(np.asarray, jmodel.init_cache(2, 5)),
                                          "cpu"))
    own_cache = _paths(get_model(tcfg).init_cache(2, 5, "cpu"))
    assert set(jcache) == set(own_cache)
    for name, a in jcache.items():
        assert a.shape == own_cache[name].shape and a.dtype == own_cache[name].dtype, name


# ------------------------------------------------------------- serving
def _ref_gap(jmodel, jparams, prompt, prefix) -> float:
    """The reference's top-1/top-2 gap for the token after prompt + prefix,
    with the prompt right-padded to PAD_TO as the scheduler pads it."""
    buf = np.zeros((1, PAD_TO), np.int32)
    buf[0, : len(prompt)] = prompt
    logits, cache = jengine.prefill(jmodel, jparams, jnp.asarray(buf),
                                    jnp.asarray([len(prompt)], jnp.int32),
                                    PAD_TO + len(prefix) + 2, None)
    for tok in prefix:
        logits, cache = jengine.decode_step(jmodel, jparams, cache,
                                            jnp.asarray([int(tok)], jnp.int32))
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


def _prompts(n, seed, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(3, PAD_TO + 1))) for _ in range(n)]


def test_generate_greedy_matches_jax(pair):
    _, jmodel, jparams, _, model, params = pair
    prompts = _prompts(3, 5, 512)
    buf = np.zeros((3, PAD_TO), np.int32)
    for i, p in enumerate(prompts):
        buf[i, : len(p)] = p
    plen = np.array([len(p) for p in prompts], np.int32)
    want = jengine.generate(jmodel, jparams, jnp.asarray(buf),
                            prompt_lengths=jnp.asarray(plen), max_new_tokens=10,
                            sampler=jsampling.greedy)
    got = engine.generate(model, params, torch.from_numpy(buf),
                          prompt_lengths=torch.from_numpy(plen), max_new_tokens=10)
    assert got["tokens"].shape == (3, 10) and got["n_steps"] == want["n_steps"]
    wt = np.asarray(want["tokens"])
    for i in range(3):
        assert_tokens_match(got["tokens"][i].numpy(), wt[i],
                            lambda k, i=i: _ref_gap(jmodel, jparams, prompts[i], wt[i][:k]),
                            f"generate row {i}")


@pytest.mark.parametrize("policy", ["continuous", "fixed"])
def test_scheduler_matches_jax_scheduler(pair, policy):
    """Six right-padded prompts (3..8 tokens, pad 8) through both schedulers
    with 2 slots: tokens, finish order, prefills, decode steps and
    occupancy agree. Both scan the padding into the state, so a token after
    the first depends on it: identity pins that reference behaviour."""
    _, jmodel, jparams, _, model, params = pair
    prompts = _prompts(6, 11, 512)
    max_news = [5, 12, 3, 9]
    traffic = [(i, p, max_news[i % 4]) for i, p in enumerate(prompts)]
    js = JScheduler(jmodel, jparams, slots=2, pad_to=PAD_TO, max_new_cap=12, policy=policy)
    ts = Scheduler(model, params, slots=2, pad_to=PAD_TO, max_new_cap=12, policy=policy,
                   device="cpu")
    jdone = js.run([JRequest(rid=i, prompt=p, max_new=m) for i, p, m in traffic])
    tdone = ts.run([ServeRequest(rid=i, prompt=p, max_new=m) for i, p, m in traffic])
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    jtok = {r.rid: r.tokens for r in jdone}
    for r in tdone:
        prompt = traffic[r.rid][1]
        assert_tokens_match(
            r.tokens, jtok[r.rid],
            lambda k, p=prompt, w=jtok[r.rid]: _ref_gap(jmodel, jparams, p, w[:k]),
            f"{policy} request {r.rid}")
    assert (ts.n_prefills, ts.n_decode_steps) == (js.n_prefills, js.n_decode_steps)
    assert ts.occupancy_trace == js.occupancy_trace


def test_padding_enters_the_state(pair):
    """The same prompt padded to 8 and to 12 gives the same first token
    (logits at prompt_length - 1) but a different state: the reference
    behaviour the port keeps."""
    _, _, _, _, model, params = pair
    prompt = np.array([5, 9, 13], np.int32)
    rows = {}
    for pad in (8, 12):
        buf = np.zeros((1, pad), np.int32)
        buf[0, :3] = prompt
        rows[pad] = engine.prefill(model, params, torch.from_numpy(buf),
                                   torch.tensor([3], dtype=torch.int32), pad + 4)
    torch.testing.assert_close(rows[8][0], rows[12][0])
    assert not torch.allclose(rows[8][1]["layers"][0]["state"],
                              rows[12][1]["layers"][0]["state"])


def test_serve_main_mamba2_on_cpu_prints_summary(capsys):
    m = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--n-requests", "4",
                    "--batch-slots", "2", "--max-new", "4"])
    out = capsys.readouterr().out
    assert re.search(r"\[serve/continuous\] 4 requests in .* tok/s \| occupancy=", out)
    assert m["n_requests"] == 4 and m["total_tokens"] == 16 and m["device"] == "cpu"
