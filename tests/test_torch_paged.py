"""Port's paged KV pool against the JAX package: ``BlockPool`` and the block
ops, the paged attention helpers, the paged decode kernel's plain version
and the paged scheduler.

- ``BlockPool`` runs fixed and random assign / decode / evict / chunk
  write sequences beside a dense mirror of what it must
  hold, and beside the reference's ``BlockPool`` given the same op
  sequence: block tables, free-lists and refcounts must be identical after
  every op, no block is double-owned or leaked, the sink block 0 is never
  handed out, every read through the table equals the dense mirror, and a
  freed slot's garbage writes land in block 0 and nowhere else;
- ``paged_write_token`` / ``paged_write_chunk`` / ``paged_gather`` and
  ``ops.paged_decode_attention``'s plain version against the reference's
  functions (f32 at atol 2e-5 / rtol 2e-4, bf16 at 2e-2), freed slots
  included; one paged decode layer and one mixed layer against the
  reference's ``attention``;
- ``Scheduler(paged=True)`` against the JAX scheduler on traces that
  preempt: tokens under the near-tie rule, and preemptions, decode steps,
  prefills and peak used blocks exactly.

Params are bridged from the reference's f32 llama3.2-1b smoke init."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_CONFIGS
from repro.core.scheduler import Scheduler as JScheduler
from repro.core.scheduler import ServeRequest as JRequest
from repro.core.slot_pool import BlockPool as JBlockPool
from repro.models import attention as JA
from repro.models import get_model as jget_model
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core.scheduler import Scheduler, ServeRequest
from repro_torch.core.slot_pool import BlockPool, SlotPool
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import get_model
from tests._hyp import given, hst, settings
from tests.test_torch_serve import _ref_gap, assert_tokens_match

SLOTS, MAX_LEN, BS, NB = 3, 12, 4, 8  # max_blocks 3, usable blocks 7
TOL = {torch.float32: dict(atol=2e-5, rtol=2e-4), torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while the module runs: its serving loops are
    thousands of tiny eager ops, which a thread pool only slows, by orders
    of magnitude beside other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@dataclasses.dataclass(frozen=True)
class _FakeConfig:
    family: str = "dense"
    sliding_window: int = None
    scan_layers: bool = False
    encdec: object = None


class _FakeModel:
    """One GQA-shaped cache layer of tiny leaves, for the port's pool."""

    config = _FakeConfig()

    def init_cache(self, batch, max_len, device):
        shape = (batch, max_len, 1, 2)
        return {"lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
                "layers": [{"k": torch.zeros(shape, device=device),
                            "v": torch.zeros(shape, device=device)}]}


class _JFakeModel:
    """The same cache for the reference's pool."""

    config = _FakeConfig()

    def init_cache(self, batch, max_len):
        shape = (batch, max_len, 1, 2)
        return {"lengths": jnp.zeros((batch,), jnp.int32),
                "layers": [{"k": jnp.zeros(shape, jnp.float32),
                            "v": jnp.zeros(shape, jnp.float32)}]}


def _rows(k: np.ndarray, length: int):
    """A prefilled dense row [1, MAX_LEN, 1, 2] for both pools."""
    trow = {"lengths": torch.tensor([length], dtype=torch.int32),
            "layers": [{"k": torch.from_numpy(k), "v": torch.from_numpy(k)}]}
    jrow = {"lengths": jnp.asarray([length], jnp.int32),
            "layers": [{"k": jnp.asarray(k), "v": jnp.asarray(k)}]}
    return trow, jrow


class _Mirror:
    """The port's and the reference's pools driven by one op sequence, plus
    a dense per-slot model of what the pools must hold."""

    def __init__(self, num_blocks=NB, max_len=MAX_LEN):
        self.pool = BlockPool(_FakeModel(), SLOTS, max_len, "cpu", block_size=BS,
                              num_blocks=num_blocks)
        self.ref = JBlockPool(_JFakeModel(), SLOTS, max_len, block_size=BS,
                              num_blocks=num_blocks)
        self.max_len = max_len
        self.dense = np.zeros((SLOTS, self.pool.max_blocks * BS, 1, 2), np.float32)
        self.kv_len = {}  # active slot -> tokens written
        self.dev_lengths = np.zeros((SLOTS,), np.int32)

    def _both(self, name, *args):
        got, want = getattr(self.pool, name)(*args), getattr(self.ref, name)(*args)
        assert got == want, f"{name}{args}: {got} vs the reference's {want}"
        return got

    def _write(self, new: np.ndarray, lengths: np.ndarray, t_new=None) -> None:
        """One pool-wide write through the table; every changed position
        must be a live target or lie in the sink block 0."""
        for pool in (self.pool, self.ref):
            pool.sync()
        k = self.pool.cache["layers"][0]["k"]
        before = k.clone()
        bt = self.pool.cache["block_tables"]
        if t_new is None:
            A.paged_write_token(k, torch.from_numpy(new), bt, torch.from_numpy(lengths))
        else:
            A.paged_write_chunk(k, torch.from_numpy(new), bt, torch.from_numpy(lengths),
                                torch.from_numpy(t_new))
        layer = self.ref.cache["layers"][0]
        jargs = (jnp.asarray(new), self.ref.cache["block_tables"], jnp.asarray(lengths))
        layer["k"] = (JA.paged_write_token(layer["k"], *jargs) if t_new is None else
                      JA.paged_write_chunk(layer["k"], *jargs, jnp.asarray(t_new)))
        changed = (k != before).any(-1).any(-1).nonzero().tolist()
        widths = np.ones(SLOTS, np.int32) if t_new is None else t_new
        allowed = {(int(self.pool.block_tables[s, p // BS]), p % BS)
                   for s in self.kv_len for p in range(lengths[s], lengths[s] + widths[s])}
        stray = [tuple(c) for c in changed if c[0] != 0 and tuple(c) not in allowed]
        assert not stray, f"writes outside live targets and the sink block: {stray}"

    # ---- ops -------------------------------------------------------------
    def admit(self, rng) -> bool:
        length = int(rng.integers(1, self.max_len - 2))
        if self.pool.n_free == 0 or self.pool.n_free_blocks < self.pool.blocks_for(length):
            return False
        slot = self._both("acquire")
        k = rng.normal(size=(1, self.max_len, 1, 2)).astype(np.float32)
        trow, jrow = _rows(k, length)
        self.pool.assign(slot, trow, length)
        self.ref.assign(slot, jrow, length)
        self.dense[slot] = 0.0
        self.dense[slot, :length] = k[0, :length]
        self.kv_len[slot] = length
        self.dev_lengths[slot] = length
        return True

    def decode_step(self, rng) -> None:
        """Pool-wide token write at every row's device length, as the decode
        step does: freed slots' garbage must land in the sink block."""
        for slot, n in self.kv_len.items():
            assert self._both("ensure", slot, n)
        new = rng.normal(size=(SLOTS, 1, 2)).astype(np.float32)
        self._write(new, self.dev_lengths.copy())
        for slot, n in list(self.kv_len.items()):
            self.dense[slot, n] = new[slot]
            self.kv_len[slot] = n + 1
        self.dev_lengths += 1  # the decode step increments every row

    def evict(self, rng) -> bool:
        if not self.kv_len:
            return False
        slot = int(rng.choice(sorted(self.kv_len)))
        self._both("evict", slot)
        del self.kv_len[slot]
        self.dev_lengths[slot] = 0
        return True

    def chunk(self, rng) -> bool:
        """A mixed step's chunk: w lanes of one slot written through the
        table at its length, every other row idle (t_new 0, its lanes sent
        to the sink block)."""
        w_max = 5
        live = [s for s, n in self.kv_len.items() if n + w_max <= self.max_len]
        if not live:
            return False
        slot = int(rng.choice(live))
        n = self.kv_len[slot]
        w = int(rng.integers(1, w_max + 1))
        if not self._both("ensure", slot, n + w - 1):
            return False
        new = rng.normal(size=(SLOTS, w, 1, 2)).astype(np.float32)
        t_new = np.zeros((SLOTS,), np.int32)
        t_new[slot] = w
        lengths = self.dev_lengths.copy()
        lengths[slot] = n
        self._write(new, lengths, t_new)
        self.dense[slot, n:n + w] = new[slot]
        self.kv_len[slot] = n + w
        self.dev_lengths[slot] = n + w
        return True

    # ---- invariants ------------------------------------------------------
    def check(self) -> None:
        pool, ref = self.pool, self.ref
        np.testing.assert_array_equal(pool.block_tables, ref.block_tables)
        assert pool._free_blocks == ref._free_blocks and pool._free == ref._free
        np.testing.assert_array_equal(pool._ref, ref._ref)
        assert [pool.owned_blocks(s) for s in range(SLOTS)] == [
            ref.owned_blocks(s) for s in range(SLOTS)]
        owned = [b for s in range(SLOTS) for b in pool.owned_blocks(s)]
        assert 0 not in owned, "sink block 0 handed out"
        assert len(owned) == len(set(owned)), "a block owned twice"
        assert sorted(owned + pool._free_blocks) == list(range(1, pool.num_blocks)), \
            "block leaked or duplicated"
        for s in range(SLOTS):
            if s not in self.kv_len:
                assert not pool.owned_blocks(s) and (pool.block_tables[s] == 0).all()
        pool.sync()
        gathered = A.paged_gather(pool.cache["layers"][0]["k"],
                                  pool.cache["block_tables"]).numpy()
        for s, n in self.kv_len.items():
            np.testing.assert_array_equal(gathered[s, :n], self.dense[s, :n])


def _run_ops(ops_, seed: int) -> None:
    rng = np.random.default_rng(seed)
    mirror = _Mirror()
    for op in ops_:
        if op == 0:
            mirror.admit(rng)
        elif op == 1 and mirror.kv_len:
            pool = mirror.pool
            need = sum(max(0, n // BS + 1 - len(pool.owned_blocks(s)))
                       for s, n in mirror.kv_len.items())
            if need <= pool.n_free_blocks and all(n < MAX_LEN for n in mirror.kv_len.values()):
                mirror.decode_step(rng)
            else:
                mirror.evict(rng)
        elif op == 2:
            mirror.evict(rng)
        elif op == 3:
            mirror.chunk(rng)
        mirror.check()
    for slot in list(mirror.kv_len):
        mirror._both("evict", slot)
        del mirror.kv_len[slot]
    mirror.check()
    assert sorted(mirror.pool._free_blocks) == list(range(1, NB))
    assert sorted(mirror.pool._free) == list(range(SLOTS)) and not mirror.pool._ref.any()


@pytest.mark.parametrize("ops_,seed", [
    ([0, 0, 1, 1, 2, 0, 1, 2, 2, 0, 0, 0, 1, 1, 1, 2, 1, 2], 0),
    ([0, 1, 1, 1, 1, 1, 1, 1, 1, 0, 2, 0, 1, 2], 1),
    ([0, 0, 3, 1, 3, 3, 2, 0, 3, 1, 3, 2, 3, 3], 2),  # chunk writes
])
def test_block_pool_fixed_sequences_match_reference(ops_, seed):
    _run_ops(ops_, seed)


@settings(max_examples=15, deadline=None)
@given(hst.lists(hst.integers(min_value=0, max_value=3), max_size=30),
       hst.integers(min_value=0, max_value=2**31 - 1))
def test_block_pool_property_matches_reference(ops_, seed):
    """Random assign / step / evict / chunk interleavings keep every
    invariant and the reference pool's exact host state."""
    _run_ops(ops_, seed)


@settings(max_examples=15, deadline=None)
@given(hst.permutations(list(range(6))))
def test_pools_acquire_lowest_first_under_any_eviction_order(order):
    """Both pools' slot heaps, and the block heap, recycle lowest first."""
    for pool in (SlotPool(_FakeModel(), 6, 4, "cpu"),
                 BlockPool(_FakeModel(), 6, 4, "cpu", block_size=2, num_blocks=13)):
        assert [pool.acquire() for _ in range(6)] == list(range(6))
        for slot in order:
            if isinstance(pool, BlockPool):
                assert pool.ensure(slot, 3)  # two blocks a slot
            pool.evict(slot)
        assert [pool.acquire() for _ in range(6)] == list(range(6))
    assert sorted(pool._free_blocks) == list(range(1, 13))
    got = []
    for slot in range(6):
        assert pool.ensure(slot, 1)
        got += pool.owned_blocks(slot)
    assert got == list(range(1, 7))


def test_block_pool_rejects_bad_shapes():
    with pytest.raises(ValueError):
        BlockPool(_FakeModel(), SLOTS, MAX_LEN, "cpu", block_size=BS, num_blocks=3)
    with pytest.raises(ValueError):
        BlockPool(_FakeModel(), SLOTS, MAX_LEN, "cpu", block_size=MAX_LEN + 1)

    class _Ring(_FakeModel):
        config = _FakeConfig(sliding_window=8)

    class _Ssm(_FakeModel):
        config = _FakeConfig(family="ssm")

    class _Vlm(_FakeModel):
        config = _FakeConfig(family="vlm")

    for bad in (_Ring(), _Ssm()):
        with pytest.raises(NotImplementedError):
            BlockPool(bad, SLOTS, MAX_LEN, "cpu", block_size=BS)
    # a VLM holds attention K/V like a dense model: the pool takes it
    assert BlockPool(_Vlm(), SLOTS, MAX_LEN, "cpu", block_size=BS).max_blocks == 3


def test_append_block_tail_not_clamped_when_max_len_unaligned():
    """With max_len not a block multiple the last block gets the row's tail
    and zeros, never a clamped slice that shifts its tokens."""
    max_len, bs = 10, 4  # the last block covers positions 8..11 > max_len
    pool = BlockPool(_FakeModel(), 2, max_len, "cpu", block_size=bs, num_blocks=7)
    k = np.random.default_rng(3).normal(size=(1, max_len, 1, 2)).astype(np.float32)
    trow, _ = _rows(k, max_len)
    pool.cache["layers"][0]["k"].fill_(7.0)  # stale contents must not survive
    slot = pool.acquire()
    pool.assign(slot, trow, max_len)
    pool.sync()
    gathered = A.paged_gather(pool.cache["layers"][0]["k"], pool.cache["block_tables"])
    np.testing.assert_array_equal(gathered[slot, :max_len].numpy(), k[0])
    assert (gathered[slot, max_len:] == 0).all()


def test_block_pool_parity_default_fits_worst_case():
    mirror = _Mirror(num_blocks=None)
    assert mirror.pool.num_blocks == SLOTS * mirror.pool.max_blocks + 1
    rng = np.random.default_rng(0)
    assert mirror.admit(rng) and mirror.admit(rng) and mirror.admit(rng)
    for _ in range(4):
        mirror.decode_step(rng)
        mirror.check()


def test_paged_reserved_bytes_below_contiguous():
    """The capacity lever: at equal slots and max_len the block pool of the
    served benchmark geometry reserves a fraction of the contiguous pool."""
    model = get_model(get_smoke_config("llama3.2-1b").replace(dtype="float32"))
    contiguous = SlotPool(model, 4, 81, "cpu")
    paged = BlockPool(model, 4, 81, "cpu", block_size=16, num_blocks=14)
    assert paged.reserved_bytes / contiguous.reserved_bytes <= 0.70


# ------------------------------------------------------ paged helpers
def _tables(rng, b, mb, nb, freed=()):
    bt = np.stack([rng.permutation(np.arange(1, nb))[:mb] for _ in range(b)]).astype(np.int32)
    for s in freed:
        bt[s] = 0  # a freed slot's table
    return bt


@pytest.mark.parametrize("which", ["token", "chunk", "gather"])
def test_paged_helpers_match_jax(which):
    rng = np.random.default_rng(11)
    b, mb, bs, nb, c = 4, 3, 4, 16, 5
    buf = rng.normal(size=(nb, bs, 2, 8)).astype(np.float32)
    bt = _tables(rng, b, mb, nb, freed=(2,))
    lengths = np.array([0, 5, 9, 11], np.int32)
    tbuf, jbuf = torch.from_numpy(buf.copy()), jnp.asarray(buf)
    targs, jargs = (torch.from_numpy(bt), torch.from_numpy(lengths)), (jnp.asarray(bt),
                                                                       jnp.asarray(lengths))
    if which == "token":
        new = rng.normal(size=(b, 2, 8)).astype(np.float32)
        got = A.paged_write_token(tbuf, torch.from_numpy(new), *targs)
        want = JA.paged_write_token(jbuf, jnp.asarray(new), *jargs)
    elif which == "chunk":
        new = rng.normal(size=(b, c, 2, 8)).astype(np.float32)
        t_new = np.array([5, 1, 0, 1], np.int32)
        got = A.paged_write_chunk(tbuf, torch.from_numpy(new), *targs, torch.from_numpy(t_new))
        want = JA.paged_write_chunk(jbuf, jnp.asarray(new), *jargs, jnp.asarray(t_new))
    else:
        got = A.paged_gather(tbuf, targs[0])
        want = JA.paged_gather(jbuf, jargs[0])
        assert tuple(got.shape) == (b, mb * bs, 2, 8)
    got, want = got.numpy(), np.asarray(want)
    # the sink block takes duplicate garbage writes in any order: compare
    # it only where no freed row writes
    if which != "gather":
        got, want = got[1:], want[1:]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["decode", "mixed"])
def test_paged_addresses_match_the_layer_rules(mode):
    """What ``transformer.forward`` computes once for every layer: each
    valid lane's flat pool row is its table entry's block and offset, every
    other lane's lies in the sink block 0; decode's n_valid is min(lengths
    + 1, MB * bs); mixed's key positions are contiguous and k_valid is kpos
    < lengths + t_new."""
    rng = np.random.default_rng(5)
    b, mb, bs, nb, c = 4, 3, 4, 16, 5
    bt = _tables(rng, b, mb, nb, freed=(2,))
    lengths = np.array([0, 7, 3, 11], np.int32)  # slot 3 at the table's last position
    t_new = np.array([5, 1, 0, 1], np.int32) if mode == "mixed" else np.ones(b, np.int32)
    addr = A.paged_addresses(torch.from_numpy(bt), torch.from_numpy(lengths), bs, mode,
                             torch.from_numpy(t_new) if mode == "mixed" else None, c)
    rows = addr["rows"].numpy().reshape(b, -1)
    for s in range(b):
        for j in range(rows.shape[1]):
            pos = lengths[s] + j
            if j < t_new[s]:
                assert rows[s, j] == bt[s, min(pos // bs, mb - 1)] * bs + pos % bs
            else:
                assert rows[s, j] < bs, "a padding lane outside the sink block"
    if mode == "decode":
        np.testing.assert_array_equal(addr["n_valid"].numpy(),
                                      np.minimum(lengths + 1, mb * bs))
    else:
        kpos = addr["kpos"]
        assert kpos.is_contiguous() and kpos.dtype == torch.int32
        np.testing.assert_array_equal(kpos.numpy(), np.tile(np.arange(mb * bs), (b, 1)))
        np.testing.assert_array_equal(addr["k_valid"].numpy(),
                                      kpos.numpy() < (lengths + t_new)[:, None])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,d,bs", [(8, 2, 16, 4), (32, 8, 64, 16), (4, 4, 32, 8)])
def test_paged_decode_attention_plain_matches_jax(hq, hkv, d, bs, dtype):
    """The plain version against the reference's XLA paged decode, with a
    freed slot (all-zero table, drifted count), n_valid 0, 1, a block edge
    and the whole table, and a permuted table."""
    rng = np.random.default_rng(hq + d)
    b, mb, nb = 6, 5, 24
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    kbuf, vbuf = (rng.normal(size=(nb, bs, hkv, d)).astype(np.float32) for _ in range(2))
    bt = _tables(rng, b, mb, nb, freed=(1,))
    n_valid = np.array([mb * bs, 3 * bs + 2, 0, 1, bs, 2 * bs + 1], np.int32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = JA.paged_decode_attention(*(jnp.asarray(a, jdt) for a in (q, kbuf, vbuf)),
                                     jnp.asarray(bt), jnp.asarray(n_valid))
    got = ops.paged_decode_attention(*(torch.from_numpy(a).to(dtype) for a in (q, kbuf, vbuf)),
                                     torch.from_numpy(bt), torch.from_numpy(n_valid))
    assert got.dtype == dtype and tuple(got.shape) == (b, hq, d)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype])
    assert (got[2] == 0).all()  # no valid key: exact zeros
    # the plain version equals the contiguous decode on the gathered rows
    gk, gv = (A.paged_gather(torch.from_numpy(x), torch.from_numpy(bt)) for x in (kbuf, vbuf))
    contiguous = ops.decode_attention(torch.from_numpy(q), gk, gv, torch.from_numpy(n_valid))
    np.testing.assert_allclose(
        ops.paged_decode_attention(torch.from_numpy(q), torch.from_numpy(kbuf),
                                   torch.from_numpy(vbuf), torch.from_numpy(bt),
                                   torch.from_numpy(n_valid)).numpy(),
        contiguous.numpy(), **TOL[torch.float32])


# ------------------------------------------------------------- layers
@pytest.fixture(scope="module")
def pair():
    jcfg = SMOKE_CONFIGS["llama3.2-1b"].replace(dtype="float32")
    jmodel = jget_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = get_smoke_config("llama3.2-1b").replace(dtype="float32")
    tparams = bridge.params_to_torch(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, get_model(tcfg), tparams


@pytest.mark.parametrize("mode", ["decode", "mixed"])
def test_paged_attention_layer_matches_jax(pair, mode):
    """One attention layer over a paged cache: the output and the pool the
    layer wrote, against the reference's ``attention`` on the same inputs
    (the sink block excluded: freed rows' garbage lands there)."""
    jmodel, jparams, model, params = pair
    cfg, jcfg = model.config, jmodel.config
    rng = np.random.default_rng(4)
    b, mb, bs, nb = 4, 3, 4, 14
    t = 1 if mode == "decode" else 5
    x = rng.normal(size=(b, t, cfg.d_model)).astype(np.float32)
    kv = [rng.normal(size=(nb, bs, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
          for _ in range(2)]
    bt = _tables(rng, b, mb, nb, freed=(3,))
    lengths = np.array([0, 4, 7, 9], np.int32)
    t_new = np.array([5, 1, 3, 0], np.int32)
    pos = lengths[:, None] + np.arange(t, dtype=np.int32)[None]
    jout, jcache = JA.attention(
        jcfg, jparams["layers"][0]["attn"], jnp.asarray(x), positions=jnp.asarray(pos),
        lengths=jnp.asarray(lengths),
        cache={"k": jnp.asarray(kv[0]), "v": jnp.asarray(kv[1]), "bt": jnp.asarray(bt)},
        mode=mode, t_new=jnp.asarray(t_new) if mode == "mixed" else None)
    tcache = {"k": torch.from_numpy(kv[0].copy()), "v": torch.from_numpy(kv[1].copy()),
              "bt": torch.from_numpy(bt)}
    with torch.inference_mode():
        out, new = A.attention(
            cfg, params["layers"][0]["attn"], torch.from_numpy(x),
            positions=torch.from_numpy(pos), lengths=torch.from_numpy(lengths), cache=tcache,
            mode=mode, t_new=torch.from_numpy(t_new) if mode == "mixed" else None)
    # row 3's table is freed: in decode it reads the sink block, which only
    # it writes; in mixed it is idle and reads the sink block that every
    # padding lane writes, in any order
    live = [0, 1, 2, 3] if mode == "decode" else [0, 1, 2]
    np.testing.assert_allclose(out.numpy()[live], np.asarray(jout)[live], **TOL[torch.float32])
    assert new["k"] is tcache["k"]  # written in place
    for key in ("k", "v"):
        np.testing.assert_allclose(new[key].numpy()[1:], np.asarray(jcache[key])[1:],
                                   **TOL[torch.float32])


# ---------------------------------------------------------- scheduler
def _traffic(seed, n, max_news, size=None):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 512, size=size or int(rng.integers(3, 9))),
             max_news[i % len(max_news)]) for i in range(n)]


COUNTERS = ("n_preemptions", "n_decode_steps", "n_prefills", "n_mixed_steps", "n_chunks",
            "n_chunk_tokens", "peak_used_blocks")


def run_both(pair, traffic, **kw):
    """One trace (every arrival at t = 0) through the JAX scheduler and the
    port's; tokens under the near-tie rule, the counters and finish order
    exactly. Returns the port's scheduler."""
    jmodel, jparams, model, params = pair
    js = JScheduler(jmodel, jparams, **kw)
    ts = Scheduler(model, params, device="cpu", **kw)
    jdone = js.run([JRequest(rid=i, prompt=p, max_new=m) for i, p, m in traffic])
    tdone = ts.run([ServeRequest(rid=i, prompt=p, max_new=m) for i, p, m in traffic])
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    jtok = {r.rid: r.tokens for r in jdone}
    for r in tdone:
        assert 1 <= len(r.tokens) <= r.max_new
        if kw.get("eos_id") is None:
            assert len(r.tokens) == r.max_new
        assert_tokens_match(
            r.tokens, jtok[r.rid],
            lambda k, p=traffic[r.rid][1], w=jtok[r.rid]: _ref_gap(jmodel, jparams, p, w[:k]),
            f"request {r.rid}")
    for name in COUNTERS:
        assert getattr(ts, name) == getattr(js, name), name
    assert ts.occupancy_trace == js.occupancy_trace
    assert ts.block_occupancy_trace == js.block_occupancy_trace
    assert ts.pool.n_used_blocks == 0 and sorted(ts.pool._free_blocks) == list(
        range(1, ts.pool.num_blocks))
    return ts


@pytest.mark.parametrize("bs,nb,eos", [(4, 8, False), (4, 8, True), (8, 5, False)])
def test_paged_scheduler_matches_jax_scheduler(pair, bs, nb, eos):
    """6 requests, 2 slots, a pool too small for two full requests: the
    paged scheduler preempts exactly where the reference does."""
    traffic = _traffic(2, 6, [16, 5, 12, 9])
    eos_id = None
    if eos:  # an EOS id the model emits: request 0's third token
        _, _, model, params = pair
        probe = Scheduler(model, params, slots=1, pad_to=8, max_new_cap=4, device="cpu")
        eos_id = probe.run([ServeRequest(rid=0, prompt=traffic[0][1], max_new=4)])[0].tokens[2]
    ts = run_both(pair, traffic, slots=2, pad_to=8, max_new_cap=16, paged=True, block_size=bs,
                  num_blocks=nb, eos_id=eos_id)
    if not eos:
        assert ts.n_preemptions >= 1


def test_paged_block_exhaustion_queues_and_recovers(pair):
    """Four full-length requests over 7 usable blocks (7 a request at worst):
    the pool preempts and recovers, every request gets its exact tokens
    and its timestamps."""
    ts = run_both(pair, _traffic(2, 4, [16], size=8), slots=2, pad_to=8, max_new_cap=16,
                  paged=True, block_size=4, num_blocks=8)
    assert ts.n_preemptions >= 1
    for r in ts.finished:
        assert r.t_first is not None and r.ttft >= 0 and r.e2e >= r.ttft


def test_paged_unaligned_max_len_matches_contiguous(pair):
    """block_size 8 over max_len 14: the last prompt block runs past max_len,
    and the paged run still gives the contiguous run's tokens."""
    _, _, model, params = pair
    traffic = _traffic(5, 3, [4], size=9)
    out = {}
    for paged in (False, True):
        sched = Scheduler(model, params, slots=2, pad_to=9, max_new_cap=4, device="cpu",
                          paged=paged, block_size=8, num_blocks=9)
        done = sched.run([ServeRequest(rid=i, prompt=p, max_new=m) for i, p, m in traffic])
        out[paged] = {r.rid: r.tokens for r in done}
    assert out[True] == out[False]
