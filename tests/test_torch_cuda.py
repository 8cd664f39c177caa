"""The port's CUDA kernels against their plain versions on the card.

This file imports no JAX (the card's machine has none); it runs there with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py`` and
skips itself on a host without CUDA. Tolerances as in test_torch_kernels.py:
f32 (TF32 off) atol 2e-5 / rtol 2e-4, bf16 atol = rtol = 2e-2."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import int8_matmul as im
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode_attention as pda
from repro_torch.kernels import rmsnorm as rn

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-4), torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


def close(got, want, dtype):
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    before = (rn.LAUNCHES, fa.LAUNCHES, da.LAUNCHES)
    x, w = r(5, 2048), r(2048)
    close(ops.rmsnorm(x, w), rn.rmsnorm_plain(x, w), dtype)
    q, k, v = r(2, 67, 8, 64), r(2, 67, 2, 64), r(2, 67, 2, 64)
    close(ops.flash_attention(q, k, v, window=16),
          ops.flash_attention(q, k, v, window=16, impl="torch"), dtype)
    ln = torch.tensor([1, 67], dtype=torch.int32, device=dev)
    close(ops.decode_attention(q[:, 0], k, v, ln),
          ops.decode_attention(q[:, 0], k, v, ln, impl="torch"), dtype)
    torch.cuda.synchronize()
    # "auto" on CUDA tensors launched each kernel exactly once
    assert (rn.LAUNCHES, fa.LAUNCHES, da.LAUNCHES) == tuple(n + 1 for n in before)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 2048, 512), (37, 100, 53), (128, 256, 64),
                                   (8, 300, 100)])
def test_int8_kernels_match_plain_on_card(m, k, n):
    """Weight-only (f32 and bf16 x) and dynamic int8 GEMMs through
    ``ops`` with ``impl="auto"`` against ``impl="torch"``; the dynamic
    kernel's f32 output equals its plain version bit for bit (exact int32
    accumulator, the same epilogue order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((m, k), generator=g, device=dev)
    w = torch.randn((k, n), generator=g, device=dev) * k ** -0.5
    w_q, w_scale = ops.quantize_int8(w, axis=0)
    before = (im.LAUNCHES_WO, im.LAUNCHES_DYN)
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        got = ops.int8_matmul_weight_only(xd, w_q, w_scale)
        assert got.dtype == dtype and got.shape == (m, n)
        close(got, ops.int8_matmul_weight_only(xd, w_q, w_scale, impl="torch"), dtype)
    got = ops.int8_matmul_dynamic(x, w_q, w_scale)
    want = ops.int8_matmul_dynamic(x, w_q, w_scale, impl="torch")
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert (im.LAUNCHES_WO, im.LAUNCHES_DYN) == (before[0] + 2, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hstu_kernel_matches_plain_on_card(dtype):
    """HSTU attention through ``ops`` (``impl="auto"``) against the plain
    version: ragged T (not a multiple of the 64-row tile), ragged and zero
    ``lengths`` (cutting inside a key tile, with and without a band), no
    band and a band, D = 64 and D = 32 with a clipped bias table. bf16 (the
    tensor-core kernel) is also held normwise, max |err| <= 1e-2 max |want|
    per call: its outputs are small enough (they are divided by T) that the
    elementwise atol alone would pass zeros. A repeat call is bit-identical
    and a row of length 0 is exactly zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import hstu_attention as ha

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    before = ha.LAUNCHES
    cases = [(2, 133, 4, 64, 4095, None, [70, 133]), (2, 133, 4, 64, 4095, 24, [0, 133]),
             (2, 70, 4, 32, 127, None, [40, 70]), (1, 200, 2, 32, 127, 100, [150]),
             (2, 300, 2, 64, 4095, 100, [211, 300])]
    for b, t, h, d, n_bias, band, lens in cases:
        q, k, v = (torch.randn((b, t, h, d), generator=g, device=dev).to(dtype)
                   for _ in range(3))
        rb = torch.randn((n_bias,), generator=g, device=dev) * 0.1
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = ops.hstu_attention(q, k, v, rb, max_attn_len=band, lengths=ln)
        again = ops.hstu_attention(q, k, v, rb, max_attn_len=band, lengths=ln)
        want = ops.hstu_attention(q, k, v, rb, max_attn_len=band, lengths=ln, impl="torch")
        close(got, want, dtype)
        if dtype == torch.bfloat16:
            err = float((got.float() - want.float()).abs().max())
            assert err <= 1e-2 * float(want.float().abs().max()), err
        assert torch.equal(got, again), "repeat call differs"
        if lens[0] == 0:
            assert torch.equal(got[0], torch.zeros_like(got[0]))
    torch.cuda.synchronize()
    assert ha.LAUNCHES == before + 2 * len(cases)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain_on_card(dtype):
    """The SSD scan through ``ops`` (``impl="auto"``) against its plain
    version: four chunks with a ragged last one, G = 2 and an initial
    state; one full 256-chunk at the served width; a T below the chunk;
    five chunks with no initial state. f32 at the reference's SSD tolerance
    (atol 2e-4 / rtol 2e-3: the kernel sums the cumulative decay in another
    order); the state at that tolerance in both types. A repeat call is
    bit-identical; one launch per call, whatever ``launch_plan`` runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import ssd_scan as ss

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    tol = dict(atol=2e-4, rtol=2e-3) if dtype == torch.float32 else TOL[dtype]
    before = ss.LAUNCHES
    cases = [(2, 461, 8, 64, 2, 128, 128, True), (1, 256, 24, 64, 1, 128, 256, False),
             (1, 5, 2, 16, 1, 8, 256, True), (1, 300, 4, 64, 1, 128, 64, False)]
    for b, t, h, p, gr, n, chunk, init in cases:
        x = torch.randn((b, t, h, p), generator=g, device=dev).to(dtype)
        dt = torch.nn.functional.softplus(torch.randn((b, t, h), generator=g, device=dev)) * 0.1
        A = -torch.linspace(1.0, 16.0, h, device=dev)
        B_, C = (torch.randn((b, t, gr, n), generator=g, device=dev).to(dtype)
                 for _ in range(2))
        D = torch.ones((h,), device=dev)
        h0 = torch.randn((b, h, p, n), generator=g, device=dev) if init else None
        y, s = ops.ssd_scan(x, dt, A, B_, C, D, chunk=chunk, initial_state=h0)
        y2, s2 = ops.ssd_scan(x, dt, A, B_, C, D, chunk=chunk, initial_state=h0)
        wy, ws = ops.ssd_scan(x, dt, A, B_, C, D, chunk=chunk, initial_state=h0,
                              impl="torch")
        np.testing.assert_allclose(y.float().cpu().numpy(), wy.float().cpu().numpy(), **tol)
        np.testing.assert_allclose(s.cpu().numpy(), ws.cpu().numpy(),
                                   **dict(atol=2e-4, rtol=2e-3))
        assert torch.equal(y, y2) and torch.equal(s, s2), "repeat call differs"
    torch.cuda.synchronize()
    assert ss.LAUNCHES == before + 2 * len(cases)


# label -> (B, Tq, Tk, Hq, Hkv, D, window)
FLASH_CASES = {
    "served T=256 32/8": (1, 256, 256, 32, 8, 64, None),
    "ragged T=67": (2, 67, 67, 8, 2, 64, None),
    "T=1": (1, 1, 1, 32, 8, 64, None),
    "D=128": (1, 80, 80, 4, 4, 128, None),
    "MQA G=64": (1, 67, 67, 64, 1, 64, None),
    "window 16": (2, 67, 67, 8, 2, 64, 16),
    "positions+k_valid": (2, 5, 40, 8, 2, 64, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_paths_on_card(case, dtype):
    """The flash kernel's type dispatch against its plain version: bf16 on
    the tensor-core kernel, f32 on the CUDA-core kernel, at the served
    prefill shape and the edge cases; a row with no valid key is exactly
    zero; one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    b, t, s, hq, hkv, d, window = FLASH_CASES[case]
    q = torch.randn((b, t, hq, d), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((b, s, hkv, d), generator=g, device=dev).to(dtype) for _ in range(2))
    qp = (torch.arange(t, device=dev) + (s - t)).expand(b, t)
    kp = torch.arange(s, device=dev).expand(b, s)
    kval = None
    if case == "positions+k_valid":
        qp = torch.tensor([[10, 11, 12, 13, 14], [3, 4, 5, 6, 7]], device=dev)
        kval = (kp < torch.tensor([[15], [0]], device=dev)).contiguous()
    kw = dict(q_positions=qp.to(torch.int32).contiguous(),
              k_positions=kp.to(torch.int32).contiguous(), causal=True, window=window,
              k_valid=kval)
    before = fa.LAUNCHES
    got = fa.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    close(got, fa.flash_attention_plain(q, k, v, **kw), dtype)
    if kval is not None:
        assert torch.equal(got[1], torch.zeros_like(got[1]))


LLAMA_LINEARS = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)]  # (K, N)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(m, k, n) for m in (8, 256) for k, n in LLAMA_LINEARS]
                         + [(1, 2048, 2048), (37, 100, 53), (8, 300, 100), (128, 256, 64),
                            (48, 200, 96)])
def test_int8_dynamic_bit_identical_on_card(m, k, n):
    """The dynamic int8 tensor-core GEMM equals its plain version bit for
    bit (exact int32 sums, the same epilogue order) at every served
    llama3.2-1b linear (decode M = 8, prefill M = 256), whether or not K is
    split, and at the edge shapes (M = 1, ragged M/N/K, a K that is not a
    multiple of 16: the byte-by-byte staging); one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((m, k), generator=g, device=dev)
    w = torch.randn((k, n), generator=g, device=dev) * k ** -0.5
    w_q, w_scale = ops.quantize_int8(w, axis=0)
    x_q, x_scale = ops.quantize_rows(x)
    before = im.LAUNCHES_DYN
    got = im.int8_matmul_dynamic_cuda(x_q, w_q, w_scale, x_scale)
    torch.cuda.synchronize()
    assert im.LAUNCHES_DYN == before + 1
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert torch.equal(got, im.int8_matmul_dynamic_plain(x_q, w_q, w_scale, x_scale))


WO_SHAPES = ([(256, k, n) for k, n in LLAMA_LINEARS]
             + [(1, 2048, 2048), (8, 2048, 8192), (37, 2048, 512), (256, 2048, 520),
                (37, 100, 53), (8, 300, 100), (48, 200, 96)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", WO_SHAPES)
def test_int8_weight_only_routes_on_card(m, k, n, dtype):
    """The weight-only kernel against its plain version at the served
    prefill linears (M = 256), at M = 1, 8 and 37, and where K or N is not
    a multiple of 16 (element-by-element staging): bf16 x on the tensor
    cores (16-row tiles up to 16 rows, 64-row tiles above), f32 x on the
    CUDA-core template; a repeat call is bit-identical; one launch per
    call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((m, k), generator=g, device=dev).to(dtype)
    w = torch.randn((k, n), generator=g, device=dev) * k ** -0.5
    w_q, w_scale = ops.quantize_int8(w, axis=0)
    want = im.int8_matmul_weight_only_plain(x, w_q, w_scale)
    before = im.LAUNCHES_WO
    got = im.int8_matmul_weight_only_cuda(x, w_q, w_scale)
    again = im.int8_matmul_weight_only_cuda(x, w_q, w_scale)
    torch.cuda.synchronize()
    assert im.LAUNCHES_WO == before + 2
    assert got.dtype == dtype and got.shape == (m, n)
    close(got, want, dtype)
    assert torch.equal(got, again), "repeat call differs"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,hq,d", [(67, 32, 64), (321, 32, 64), (4096, 32, 64),
                                    (321, 16, 128)])
def test_decode_attention_split_on_card(s, hq, d, dtype):
    """The split decode kernel and its combine against the plain version
    at 8 rows x 8 KV heads, S = 67, 321 (served) and 4096, with lengths at
    the split edges (0, 1, split - 1, split, split + 1, 2 splits, S - 1,
    S); a row of length 0 is exactly 0; a repeat call is bit-identical;
    one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    b, hkv = 8, 8
    splits, split_len = da.split_plan(b, hkv, s, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    assert splits > 1
    lengths = [min(s, n) for n in (0, 1, split_len - 1, split_len, split_len + 1,
                                   2 * split_len, s - 1, s)]
    q = torch.randn((b, hq, d), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((b, s, hkv, d), generator=g, device=dev).to(dtype) for _ in range(2))
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    before = da.LAUNCHES
    got = da.decode_attention_cuda(q, k, v, ln)
    again = da.decode_attention_cuda(q, k, v, ln)
    torch.cuda.synchronize()
    assert da.LAUNCHES == before + 2
    assert got.dtype == dtype and got.shape == q.shape
    close(got, da.decode_attention_plain(q, k, v, ln), dtype)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert torch.equal(got, again)


# widths: the served ones (HSTU 512, Mamba-2 768 / 1536, llama 2048), a
# ragged one (1000: 125 bf16 vectors over 32 lanes), one whose rows are not
# 16-byte aligned (1001), one past one warp's register budget (4096: two
# warps a row at least), and one past eight warps' (20000: the block path)
RMS_WIDTHS = [512, 768, 1536, 2048, 1000, 1001, 4096, 20000]
RMS_FUSED = {"add": (rn.add_rmsnorm_cuda, rn.add_rmsnorm_plain),
             "mul": (rn.mul_rmsnorm_cuda, rn.mul_rmsnorm_plain),
             "mul_silu": (rn.mul_silu_rmsnorm_cuda, rn.mul_silu_rmsnorm_plain)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", RMS_WIDTHS)
@pytest.mark.parametrize("prologue", ["none", *RMS_FUSED])
def test_rmsnorm_prologues_match_plain_on_card(prologue, d, dtype):
    """Each prologue against its plain version at N = 0, 1, 37 and 1100 rows
    (few rows take more warps a row, ``rmsnorm.route``), with the second
    operand contiguous, a slice of a wider row (strided, as
    HSTU's u and Mamba-2's z) and a slice one element in (no 16-byte
    alignment): add's sum equals x + r bit for bit; every fused output
    equals the none kernel on the unfused ops' result bit for bit;
    a repeat call is bit-identical; one launch per call with rows, none
    without."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(d)
    w = (1 + 0.1 * torch.randn((d,), generator=g, device=dev)).to(dtype)
    for n in (0, 1, 37, 1100):
        x = (torch.randn((n, d), generator=g, device=dev) * 3).to(dtype)
        wide = torch.randn((n, d + 24), generator=g, device=dev).to(dtype)
        layouts = {"contiguous": wide[:, :d].contiguous(), "strided": wide[:, 8:8 + d],
                   "misaligned": wide[:, 1:1 + d]}
        for layout, other in layouts.items():
            if prologue == "none" and layout != "contiguous":
                continue
            before = (rn.LAUNCHES, rn.LAUNCHES_BY_PROLOGUE[prologue])
            if prologue == "none":
                s, got = None, rn.rmsnorm_cuda(x, w)
                again = rn.rmsnorm_cuda(x, w)
                want = rn.rmsnorm_plain(x, w)
            else:
                kernel, plain = RMS_FUSED[prologue]
                out, again = kernel(x, other, w), kernel(x, other, w)
                s, got = out if prologue == "add" else (None, out)
                again = again[1] if prologue == "add" else again
                want = plain(x, other, w)
                want = want[1] if prologue == "add" else want
            torch.cuda.synchronize()
            assert rn.LAUNCHES - before[0] == (2 if n else 0)
            assert rn.LAUNCHES_BY_PROLOGUE[prologue] - before[1] == (2 if n else 0)
            assert got.dtype == dtype and got.shape == x.shape
            close(got, want, dtype)
            assert torch.equal(got, again), (layout, n)
            if prologue == "add":
                assert torch.equal(s, x + other), (layout, n)
            if prologue != "none" and n:
                mid = {"add": lambda: x + other, "mul": lambda: x * other,
                       "mul_silu": lambda: x * torch.nn.functional.silu(other)}[prologue]()
                assert torch.equal(got, rn.rmsnorm_cuda(mid, w)), (layout, n)


@pytest.mark.cuda
def test_rmsnorm_fused_ops_dispatch_and_refuse_on_card():
    """``ops``' fused RMSNorms launch the kernel on CUDA tensors (the
    strided second operand read in place), and raise for a CPU tensor
    with ``impl="cuda"`` and for a second operand on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((2, 7, 512), generator=g, device=dev).to(torch.bfloat16)
    wide = torch.randn((2, 7, 2048), generator=g, device=dev).to(torch.bfloat16)
    w = torch.ones((512,), device=dev, dtype=torch.bfloat16)
    before = dict(rn.LAUNCHES_BY_PROLOGUE)
    s, y = ops.add_rmsnorm(x, wide[..., :512], w)
    assert torch.equal(s, x + wide[..., :512])
    close(ops.mul_rmsnorm(x, wide[..., 512:1024], w),
          ops.mul_rmsnorm(x, wide[..., 512:1024], w, impl="torch"), torch.bfloat16)
    close(ops.mul_silu_rmsnorm(x, wide[..., 3:515], w),
          ops.mul_silu_rmsnorm(x, wide[..., 3:515], w, impl="torch"), torch.bfloat16)
    torch.cuda.synchronize()
    for p in ("add", "mul", "mul_silu"):
        assert rn.LAUNCHES_BY_PROLOGUE[p] == before[p] + 1
    cpu = x.cpu()
    for fn in (ops.add_rmsnorm, ops.mul_rmsnorm, ops.mul_silu_rmsnorm):
        with pytest.raises(ValueError, match="CUDA"):
            fn(cpu, cpu, w.cpu(), impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        rn.add_rmsnorm_cuda(x, cpu, w)


def _paged_inputs(g, dev, dtype, b, hq, hkv, d, bs, mb, nb):
    """q, a block pool and its table: row 0 a freed slot (all-zero table),
    row 1 a permuted, non-monotone table, the rest distinct blocks."""
    q = torch.randn((b, hq, d), generator=g, device=dev).to(dtype)
    kbuf, vbuf = (torch.randn((nb, bs, hkv, d), generator=g, device=dev).to(dtype)
                  for _ in range(2))
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(b + mb)) + 1
    bt = torch.stack([perm[(i * mb) % (nb - mb):][:mb] for i in range(b)]).to(torch.int32)
    bt[0] = 0
    bt[1] = bt[1].flip(0)
    return q, kbuf, vbuf, bt.to(dev).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,hq,hkv,d,bs,mb", [(8, 32, 8, 64, 16, 21), (3, 8, 2, 64, 4, 9),
                                              (4, 16, 8, 128, 16, 5), (2, 8, 1, 64, 32, 3),
                                              (8, 8, 2, 32, 16, 21), (3, 4, 4, 16, 4, 9),
                                              (2, 4, 1, 32, 16, 5)])
def test_paged_decode_attention_on_card(b, hq, hkv, d, bs, mb, dtype):
    """The paged kernel (it reads the block table itself) against its plain
    version: the served shape (8 slots, block 16, 21 blocks a slot) and
    others, n_valid of 1, a block edge, a split edge and MB * bs, a freed
    slot with a drifted count, a permuted table; one launch per call, a
    repeat call bit-identical, and the contiguous kernel on the gathered
    rows within the type's tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    nb = 48 if b * mb < 48 else b * mb + 1
    q, kbuf, vbuf, bt = _paged_inputs(g, dev, dtype, b, hq, hkv, d, bs, mb, nb)
    s_log = mb * bs
    n_valid = [s_log - 3, s_log, 1, bs, bs + 1, 64, 65, s_log - 1][:b]
    nv = torch.tensor(n_valid, dtype=torch.int32, device=dev)
    before = pda.LAUNCHES
    got = ops.paged_decode_attention(q, kbuf, vbuf, bt, nv)
    again = pda.paged_decode_attention_cuda(q, kbuf, vbuf, bt, nv)
    torch.cuda.synchronize()
    assert pda.LAUNCHES == before + 2
    assert got.dtype == dtype and got.shape == q.shape
    close(got, pda.paged_decode_attention_plain(q, kbuf, vbuf, bt, nv), dtype)
    assert torch.equal(got, again)
    gk = kbuf[bt.long()].reshape(b, s_log, hkv, d)
    gv = vbuf[bt.long()].reshape(b, s_log, hkv, d)
    close(got, da.decode_attention_cuda(q, gk.contiguous(), gv.contiguous(), nv), dtype)


@pytest.mark.cuda
def test_paged_decode_attention_refuses_on_card():
    """CPU tensors with impl="cuda", a head width the kernel lacks and a
    table of another type raise; nothing falls back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    q, kbuf, vbuf, bt = _paged_inputs(g, dev, torch.bfloat16, 2, 8, 2, 64, 16, 3, 8)
    nv = torch.tensor([5, 40], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_decode_attention(q.cpu(), kbuf.cpu(), vbuf.cpu(), bt.cpu(), nv.cpu(),
                                   impl="cuda")
    with pytest.raises(ValueError):
        pda.paged_decode_attention_cuda(q[..., :48].contiguous(), kbuf[..., :48].contiguous(),
                                        vbuf[..., :48].contiguous(), bt, nv)
    with pytest.raises(ValueError):
        pda.paged_decode_attention_cuda(q, kbuf, vbuf, bt.long(), nv)


def _served(model, params, device, traffic, **kw):
    from repro_torch.core.scheduler import Scheduler, ServeRequest

    sched = Scheduler(model, params, slots=3, pad_to=24, max_new_cap=12, device=device, **kw)
    done = sched.run([ServeRequest(rid=i, prompt=p, max_new=m) for i, p, m in traffic])
    return sched, {r.rid: r.tokens for r in done}


@pytest.mark.cuda
def test_paged_and_chunked_serving_on_card():
    """A small f32 llama (head 64, so the attention kernels take it) served
    on the card by the paged and the chunked scheduler over a pool that
    preempts: exact launch counts (paged decode per plain step, flash per
    prefill and per mixed step, the contiguous decode never), no leaked
    block, and the CPU plain path's tokens and counters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("llama3.2-1b").replace(d_model=512, n_heads=8, n_kv_heads=2,
                                                  dtype="float32")
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    dev = torch.device("cuda")
    params_dev = _to(params, dev)
    rng = np.random.default_rng(1)
    traffic = [(i, rng.integers(0, cfg.vocab_size, size=int(rng.integers(5, 25))), 12)
               for i in range(7)]
    for kw in (dict(paged=True, block_size=8, num_blocks=10),
               dict(paged=True, block_size=8, num_blocks=10, chunked=True, prefill_budget=8)):
        cpu, want = _served(model, params, "cpu", traffic, **kw)
        counts = (pda.LAUNCHES, da.LAUNCHES, fa.LAUNCHES)
        card, got = _served(model, params_dev, dev, traffic, **kw)
        torch.cuda.synchronize()
        assert card.n_preemptions >= 1
        for name in ("n_preemptions", "n_decode_steps", "n_prefills", "n_mixed_steps",
                     "n_chunks", "peak_used_blocks"):
            assert getattr(card, name) == getattr(cpu, name), name
        plain = card.n_decode_steps - card.n_mixed_steps
        assert (pda.LAUNCHES - counts[0], da.LAUNCHES - counts[1], fa.LAUNCHES - counts[2]) == (
            cfg.n_layers * plain, 0, cfg.n_layers * (card.n_prefills + card.n_mixed_steps))
        assert card.pool.n_used_blocks == 0
        for i, prompt, _ in traffic:
            _match_near_tie(model, params, prompt, got[i], want[i])


def _small_llama_on_card():
    """An f32 llama of the smoke depth at head 64 (the attention kernels'
    width), its params on the CPU and on the card."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("llama3.2-1b").replace(d_model=512, n_heads=8, n_kv_heads=2,
                                                  dtype="float32")
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    return cfg, model, _to(params, torch.device("cuda"))


#: the two-phase tests' pools: contiguous (plain decode steps) and paged +
#: chunked (mixed steps, then paged decode steps)
STAGED_POOLS = {"contiguous": {},
                "chunked": dict(paged=True, chunked=True, block_size=8, num_blocks=16,
                                prefill_budget=8)}


@pytest.mark.cuda
@pytest.mark.parametrize("pool", list(STAGED_POOLS))
def test_step_begin_makes_no_sync_on_card(pool):
    """Every ``step_begin`` of a served trace (greedy and t = 0.8 requests
    in one pool) runs under ``set_sync_debug_mode("error")`` without a
    synchronizing call: its host inputs go through pinned buffers, copied
    without blocking, and the sampled tokens come back the same way. The
    admissions between rounds run outside the mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core.scheduler import Scheduler, ServeRequest

    cfg, model, params = _small_llama_on_card()
    rng = np.random.default_rng(3)
    sched = Scheduler(model, params, slots=3, pad_to=24, max_new_cap=10,
                      device=torch.device("cuda"), **STAGED_POOLS[pool])
    sched.submit([ServeRequest(rid=i, prompt=rng.integers(0, cfg.vocab_size, 20), max_new=10,
                               temperature=0.8 * (i % 2), top_p=0.9) for i in range(4)])
    kinds = set()
    with torch.inference_mode():
        while sched.waiting or sched.has_work:
            sched._admit(sched._now())
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                pending = sched.step_begin()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            kinds.add(pending[0])
            sched.step_finish(pending)
    assert kinds == ({"decode", "mixed"} if pool == "chunked" else {"decode"})
    assert len(sched.finished) == 4
    bufs = sched._staging._bufs
    assert {"token", "tokens", "keys", "knobs"} <= set(bufs)
    assert all(b.is_pinned() for b in bufs.values())


@pytest.mark.cuda
@pytest.mark.parametrize("pool", list(STAGED_POOLS))
def test_interleaved_replicas_give_each_pools_tokens_on_card(pool):
    """Two schedulers on the one card, stepped begin, begin, finish,
    finish (their staged copies and kernels queued on one stream), give the
    tokens and counters each gives alone through ``step()``, bit for bit;
    a two-replica router gives the single pool's tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core.router import ReplicaRouter
    from repro_torch.core.scheduler import Scheduler, ServeRequest

    cfg, model, params = _small_llama_on_card()
    dev = torch.device("cuda")
    geo = dict(slots=3, pad_to=24, max_new_cap=10, **STAGED_POOLS[pool])

    def trace(seed):
        rng = np.random.default_rng(seed)
        return [ServeRequest(rid=i, prompt=rng.integers(0, cfg.vocab_size, int(rng.integers(5, 24))),
                             max_new=int(rng.integers(2, 11)), temperature=0.8 * (i % 2),
                             top_p=0.9) for i in range(5)]

    alone = []
    for seed in (0, 1):
        s = Scheduler(model, params, device=dev, **geo)
        alone.append((s, {r.rid: r.tokens for r in s.run(trace(seed))}))
    both = [Scheduler(model, params, device=dev, **geo) for _ in range(2)]
    for s, seed in zip(both, (0, 1)):
        s.submit(trace(seed))
    with torch.inference_mode():
        while any(s.waiting or s.has_work for s in both):
            for s in both:
                s._admit(s._now())
            pend = [(s, s.step_begin()) for s in both if s.has_work]
            for s, p in pend:
                s.step_finish(p)
    for (s1, want), s2 in zip(alone, both):
        assert {r.rid: r.tokens for r in s2.finished} == want
        for name in ("n_decode_steps", "n_prefills", "n_mixed_steps", "n_preemptions"):
            assert getattr(s2, name) == getattr(s1, name), name
    fleet = ReplicaRouter(model, params, replicas=2, **geo)
    assert all(r.device.type == "cuda" for r in fleet.replicas)
    assert fleet.replicas[0].params is fleet.replicas[1].params  # one card: shared weights
    got = {r.rid: r.tokens for r in fleet.run(trace(0))}
    assert got == alone[0][1]


def _match_near_tie(model, params, prompt, got, want, tie=1e-3):
    """Tokens equal up to the first divergence, which passes only where the
    CPU plain path's top-1/top-2 logit gap is below ``tie`` (f32)."""
    from repro_torch.core import engine

    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            seq = list(prompt) + list(want[:i])
            logits, _ = engine.prefill(model, params, torch.tensor([seq], dtype=torch.int32),
                                       torch.tensor([len(seq)], dtype=torch.int32),
                                       len(seq) + 1)
            top2 = torch.topk(logits[0], 2).values
            assert float(top2[0] - top2[1]) < tie, f"token {i}: {a} vs {b}"
            return
    assert len(got) == len(want)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


# label -> (q shape, k/v shape, causal, k_valid lengths or None)
MULTIMODAL_FLASH = {
    "bidirectional over 1500 frames": ((2, 1500, 8, 64), (2, 1500, 8, 64), False, None),
    "cross Tq=1 k_valid": ((6, 1, 8, 64), (6, 1500, 8, 64), False, [552, 360, 1, 1500, 179,
                                                                     1499]),
    "cross prefill Tq=Tk=1": ((2, 1, 8, 64), (2, 1, 8, 64), True, None),
    "G=8 D=128 prefill": ((1, 203, 64, 128), (1, 203, 8, 128), True, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(MULTIMODAL_FLASH))
def test_flash_attention_multimodal_shapes_on_card(case, dtype):
    """The flash kernel at the encoder-decoder's and Chameleon's shapes
    against its plain version: non-causal over a key count that is no
    multiple of the key tile, Tq = 1 against 1500 keys with ``k_valid``,
    Tq = Tk = 1, and a q-head group of 8 at D = 128; a repeat call is
    bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    qs, ks, causal, lens = MULTIMODAL_FLASH[case]
    q = torch.randn(qs, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(ks, generator=g, device=dev).to(dtype) for _ in range(2))
    b, t, s = qs[0], qs[1], ks[1]
    kw = dict(q_positions=(torch.arange(t, device=dev) + s - t).expand(b, t)
              .to(torch.int32).contiguous(),
              k_positions=torch.arange(s, device=dev).expand(b, s).to(torch.int32)
              .contiguous(), causal=causal, k_valid=None)
    if lens is not None:
        kw["k_valid"] = (torch.arange(s, device=dev)[None]
                         < torch.tensor(lens, device=dev)[:, None]).contiguous()
    got = fa.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    close(got, fa.flash_attention_plain(q, k, v, **kw), dtype)
    assert torch.equal(got, fa.flash_attention_cuda(q, k, v, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_and_qk_norm_at_chameleon_shapes_on_card(dtype):
    """Flash-decode at Chameleon's group (G * D = 64 / 8 x 128 = 1024) over
    a T-I cache, and RMSNorm over qk-norm rows of 128."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    q = torch.randn((2, 64, 128), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((2, 1039, 8, 128), generator=g, device=dev).to(dtype)
            for _ in range(2))
    ln = torch.tensor([15, 1038], dtype=torch.int32, device=dev)
    close(da.decode_attention_cuda(q, k, v, ln), da.decode_attention_plain(q, k, v, ln), dtype)
    x = torch.randn((203 * 64, 128), generator=g, device=dev).to(dtype)
    w = (1 + 0.1 * torch.randn((128,), generator=g, device=dev)).to(dtype)
    close(rn.rmsnorm_cuda(x, w), rn.rmsnorm_plain(x, w), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [16, 8])
def test_decode_attention_at_encdec_self_cache_on_card(b, dtype):
    """Flash-decode at the encoder-decoder's self-attention (G = 1 at D =
    64: 8 heads over 8 KV heads) over a 50-row cache (BOS + 48 tokens + 1),
    at every length a 48-token beam search reads (2..48), for the S-T (16
    streams) and S-S (8) batches; a repeat call is bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    q = torch.randn((b, 8, 64), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((b, 50, 8, 64), generator=g, device=dev).to(dtype) for _ in range(2))
    for n in range(2, 49):
        ln = torch.full((b,), n, dtype=torch.int32, device=dev)
        got = da.decode_attention_cuda(q, k, v, ln)
        close(got, da.decode_attention_plain(q, k, v, ln), dtype)
        assert torch.equal(got, da.decode_attention_cuda(q, k, v, ln)), f"length {n}"


def _beam_trace(model, params, n_groups, extra, max_new, keep_at=None):
    """Each step's fed tokens and permutation of a beam search (4 beams,
    BOS 1, EOS 2), and the candidate scores at step ``keep_at``."""
    from repro_torch.core import engine, profiles, sampling

    class Rec(profiles.BeamProfile):
        def step(self, state, logits, key=None):
            if len(trace) == keep_at:
                kept.append(sampling.beam_candidates(state, logits, 4, 2).cpu())
            out = super().step(state, logits, key)
            trace.append((out.feed.tolist(), out.perm.tolist()))
            return out

    trace, kept = [], []
    dev = next(iter(extra.values())).device
    out = engine.run_profile(model, params, Rec(n_beams=4, eos_id=2),
                             torch.ones((n_groups, 1), dtype=torch.int32, device=dev),
                             max_new_tokens=max_new, extra_inputs=extra)
    return trace, kept, out


@pytest.mark.cuda
def test_encdec_beam_search_on_card():
    """A small f32 whisper (head 64, 100 frames: no multiple of the key
    tile) beam-searched on the card in both reorder arms: equal tokens,
    exact launches (flash: encoder layers + the decoder's self-attention at
    the prefill + its cross-attention every step; decode: self-attention
    every decode step), and the CPU plain path's steps up to a near tie
    (f32: the deciding gap below 1e-3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import EncDecConfig
    from repro_torch.core import engine
    from repro_torch.models import get_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("whisper-base").replace(
        d_model=256, n_heads=4, n_kv_heads=4, dtype="float32",
        encdec=EncDecConfig(n_encoder_layers=2, n_frames=100, max_target_len=64))
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    dev = torch.device("cuda")
    params_dev = _to(params, dev)
    frames = torch.randn((3, 100, 256), generator=torch.Generator().manual_seed(1))
    fl = torch.tensor([100, 37, 64], dtype=torch.int32)
    extra = {"frames": frames, "frame_lengths": fl}
    extra_dev = {k: v.to(dev) for k, v in extra.items()}
    kw = dict(batch=3, n_beams=4, bos_id=1, eos_id=2, max_new_tokens=12)
    before = (fa.LAUNCHES, da.LAUNCHES, rn.LAUNCHES)
    donated = engine.generate_beam(model, params_dev, extra_inputs=extra_dev, **kw)
    torch.cuda.synchronize()
    n = donated["n_steps"]
    assert (fa.LAUNCHES - before[0], da.LAUNCHES - before[1], rn.LAUNCHES - before[2]) == (
        2 + 2 + 2 * n, 2 * (n - 1), (1 + 2 * 2) + n * (1 + 3 * 2))
    realloc = engine.generate_beam(model, params_dev, extra_inputs=extra_dev,
                                   donate_reorder=False, **kw)
    assert torch.equal(donated["tokens"], realloc["tokens"])
    card, _, _ = _beam_trace(model, params_dev, 3, extra_dev, 12)
    cpu, _, want = _beam_trace(model, params, 3, extra, 12)
    for i, (a, b) in enumerate(zip(card, cpu)):
        if a != b:
            ck = _beam_trace(model, params_dev, 3, extra_dev, 12, keep_at=i)[1][0]
            top = torch.sort(ck, dim=1, descending=True).values[:, :5]
            assert float((top[:, :-1] - top[:, 1:]).min()) < 1e-3, f"step {i}"
            return
    assert donated["tokens"].cpu().tolist() == want["tokens"].tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("n_beams", [4, 1])
def test_encdec_beam_search_finishes_on_card(n_beams):
    """The small f32 whisper of the test above on the card with EOS set to
    the first step's best token: finished beams extend only by EOS (4
    beams), and a search whose every beam has ended stops (1 beam: after
    its first step). Tokens and steps equal the CPU plain path's, scores
    within 1e-4; launches exact for the steps run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import EncDecConfig
    from repro_torch.core import engine
    from repro_torch.models import get_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("whisper-base").replace(
        d_model=256, n_heads=4, n_kv_heads=4, dtype="float32",
        encdec=EncDecConfig(n_encoder_layers=2, n_frames=100, max_target_len=64))
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    dev = torch.device("cuda")
    params_dev = _to(params, dev)
    frames = torch.randn((3, 100, 256), generator=torch.Generator().manual_seed(1))
    extra = {"frames": frames, "frame_lengths": torch.tensor([100, 37, 64], dtype=torch.int32)}
    extra_dev = {k: v.to(dev) for k, v in extra.items()}
    kw = dict(batch=3, n_beams=n_beams, bos_id=1, max_new_tokens=12)
    first = engine.generate_beam(model, params_dev, extra_inputs=extra_dev, eos_id=2,
                                 **dict(kw, max_new_tokens=1))["tokens"]
    eos = int(first[0, 0])
    before = (fa.LAUNCHES, da.LAUNCHES)
    got = engine.generate_beam(model, params_dev, extra_inputs=extra_dev, eos_id=eos, **kw)
    torch.cuda.synchronize()
    n = got["n_steps"]
    assert (fa.LAUNCHES - before[0], da.LAUNCHES - before[1]) == (2 + 2 + 2 * n, 2 * (n - 1))
    want = engine.generate_beam(model, params, extra_inputs=extra, eos_id=eos, **kw)
    assert n == want["n_steps"] and (n == 1 or n_beams > 1)
    assert got["tokens"].cpu().tolist() == want["tokens"].tolist()
    assert int(got["tokens"][0, 0]) == eos
    np.testing.assert_allclose(got["scores"].cpu().numpy(), want["scores"].numpy(), atol=1e-4)


@pytest.mark.cuda
def test_vlm_it_and_contrastive_on_card():
    """A small f32 Chameleon (qk-norm, 8 q heads of 128 over one KV head:
    G = 8 at D = 128) on the card: I-T greedy and T-I contrastive tokens
    equal the CPU plain path's up to a near tie, T-I tokens in the image
    range, exact launches (qk-norm's two RMSNorms a layer too)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import engine
    from repro_torch.models import get_model, vlm

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("chameleon-34b").replace(d_model=1024, n_heads=8, n_kv_heads=1,
                                                    dtype="float32")
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    dev = torch.device("cuda")
    params_dev = _to(params, dev)
    gen = torch.Generator().manual_seed(2)
    prompt = vlm.build_it_input(cfg, vlm.encode_image_stub(cfg, gen, 1),
                                torch.randint(0, 448, (1, 5), generator=gen))
    before = (fa.LAUNCHES, da.LAUNCHES, rn.LAUNCHES)
    got = engine.generate(model, params_dev, prompt.to(dev), max_new_tokens=8)
    torch.cuda.synchronize()
    L = cfg.n_layers
    assert (fa.LAUNCHES - before[0], da.LAUNCHES - before[1], rn.LAUNCHES - before[2]) == (
        L, L * 7, 8 * (1 + 2 * L + 2 * L))
    want = engine.generate(model, params, prompt, max_new_tokens=8)
    _match_near_tie(model, params, prompt[0].tolist(), got["tokens"][0].tolist(),
                    want["tokens"][0].tolist())
    ti = prompt[:, -5:]
    got = engine.generate_contrastive(model, params_dev, ti.to(dev), uncond_token=0,
                                      n_image_tokens=16)
    want = engine.generate_contrastive(model, params, ti, uncond_token=0, n_image_tokens=16)
    assert bool((got["tokens"] >= vlm.image_token_offset(cfg)).all())
    g, w = got["tokens"][0].tolist(), want["tokens"][0].tolist()
    first = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
    if first is not None:  # a near tie of the mixed, masked logits
        def mixed(p, device):
            def last(seq):
                return engine.prefill(model, p, torch.tensor([seq], dtype=torch.int32,
                                                             device=device),
                                      torch.tensor([len(seq)], dtype=torch.int32,
                                                   device=device), len(seq) + 1)[0].cpu()
            cond = last(ti[0].tolist() + w[:first])
            uncond = last([0] * 5 + w[:first])
            return vlm.image_token_mask(448, vlm.contrastive_logits(cond, uncond, 3.0))
        top2 = torch.topk(mixed(params, "cpu")[0], 2).values
        assert float(top2[0] - top2[1]) < 1e-3, f"T-I token {first}"


@pytest.mark.cuda
def test_prng_and_sampler_on_card_match_cpu():
    """The port's Threefry on the card: keys, fold-ins, splits, bits and
    uniforms bit for bit as on the CPU; Gumbel noise within 2 ulp (at a
    magnitude of at least 1: CUDA's and the CPU's ``log`` round apart);
    the per-slot and per-window samplers' tokens equal the CPU's except at
    a perturbed near tie (1e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core import prng, sampling

    dev = torch.device("cuda")
    for seed in (0, 9, 2**31 - 1):
        ck, gk = prng.PRNGKey(seed), prng.PRNGKey(seed, device=dev)
        assert torch.equal(gk.cpu(), ck)
        for d in (0, 7, 2**32 - 1):
            assert torch.equal(prng.fold_in(gk, d).cpu(), prng.fold_in(ck, d))
        assert torch.equal(prng.split(gk, 5).cpu(), prng.split(ck, 5))
        for shape in ((7,), (8, 128256), (3, 5, 33)):
            assert torch.equal(prng.bits(gk, shape).cpu(), prng.bits(ck, shape))
            assert torch.equal(prng.uniform(gk, shape).cpu(), prng.uniform(ck, shape))
            got, want = prng.gumbel(gk, shape).cpu().double(), prng.gumbel(ck, shape).double()
            unit = torch.from_numpy(np.spacing(np.maximum(want.abs().numpy(), 1.0)
                                               .astype(np.float32))).double()
            assert float(((got - want).abs() / unit).max()) <= 2
    rids, steps = np.array([0, 3, 7, 11]), np.array([0, 1, 9, 2])
    temp = torch.tensor([0.0, 0.8, 1.0, 0.8])
    top_p = torch.tensor([1.0, 0.9, 0.5, 0.95])
    g = torch.Generator().manual_seed(3)
    logits = torch.randn((4, 5, 128256), generator=g) * 3
    lanes = steps[:, None] + np.arange(5)[None]
    keys = sampling.window_step_keys(prng.PRNGKey(4), rids, lanes)
    dkeys = sampling.window_step_keys(prng.PRNGKey(4, device=dev), rids, lanes)
    assert torch.equal(dkeys.cpu(), keys)
    want = sampling.sample_window(logits, keys, temp, top_p)
    got = sampling.sample_window(logits.to(dev), dkeys, temp.to(dev), top_p.to(dev)).cpu()
    assert torch.equal(got[:, 0], sampling.sample_slots(
        logits[:, 0].to(dev), dkeys[:, 0], temp.to(dev), top_p.to(dev)).cpu())
    for b, j in zip(*torch.nonzero(got != want, as_tuple=True)):
        scaled = logits[b, j] / max(float(temp[b]), 1e-6)
        scores = sampling.nucleus(scaled, float(top_p[b])) + prng.gumbel(keys[b, j], (128256,))
        top2 = torch.topk(scores, 2).values
        assert float(top2[0] - top2[1]) < 1e-5, f"lane ({b}, {j})"


def _spec_model():
    """A small f32 llama on both sides: head 64 (the attention kernels take
    it), 4 layers (exit layer 2), embeddings scaled by 0.1 so drafts are
    sometimes rejected."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model

    cfg = get_smoke_config("llama3.2-1b").replace(d_model=512, n_heads=8, n_kv_heads=2,
                                                  n_layers=4, dtype="float32")
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    for k in params["embed"]:
        params["embed"][k] = params["embed"][k] * 0.1
    return cfg, model, params


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_draft_window_and_verify_step_on_card(paged):
    """One draft window (widths 4, 2, 0) and its verify step over a
    prefilled pool, on the kernels against the CPU plain path: equal drafts
    (up to a greedy near tie of the early-exit logits), verify logits
    within 1e-3, and exact launches: (paged) decode exit x drafts, flash
    n_layers, RMSNorm none drafts + 1 and add 2 x exit x drafts +
    2 x n_layers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core import engine, layerskip
    from repro_torch.core.slot_pool import BlockPool, SlotPool

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, model, params = _spec_model()
    dev = torch.device("cuda")
    exit_layer, k, max_len = 2, 4, 24
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (7, 3, 11)]
    lengths = np.array([len(p) for p in prompts], np.int32)
    out = {}
    for where, p in (("cpu", params), ("cuda", _to(params, dev))):
        device = torch.device(where)
        pool = (BlockPool(model, 3, max_len, device, block_size=8) if paged
                else SlotPool(model, 3, max_len, device))
        first = []
        for slot, prompt in enumerate(prompts):
            toks = torch.tensor([list(prompt)], dtype=torch.int32, device=device)
            logits, row = engine.prefill(model, p, toks,
                                         torch.tensor([len(prompt)], dtype=torch.int32,
                                                      device=device), max_len)
            pool.acquire()
            pool.assign(slot, row, len(prompt))
            if paged:
                pool.ensure(slot, len(prompt) + k)
            first.append(int(logits.argmax()))
        pool.sync()
        counts = (da.LAUNCHES, pda.LAUNCHES, fa.LAUNCHES, rn.LAUNCHES_BY_PROLOGUE["none"],
                  rn.LAUNCHES_BY_PROLOGUE["add"])
        ln = torch.from_numpy(lengths).to(device)
        window, cache = layerskip.draft_window(
            model, exit_layer, k, p, pool.cache, torch.tensor(first, dtype=torch.int32,
                                                              device=device),
            torch.tensor([4, 2, 0], dtype=torch.int32, device=device), ln)
        w = torch.tensor([5, 3, 1], dtype=torch.int32, device=device)
        logits, cache = engine.verify_step(model, p, cache, window, w, ln)
        torch.cuda.synchronize()
        launched = (da.LAUNCHES - counts[0], pda.LAUNCHES - counts[1], fa.LAUNCHES - counts[2],
                    rn.LAUNCHES_BY_PROLOGUE["none"] - counts[3],
                    rn.LAUNCHES_BY_PROLOGUE["add"] - counts[4])
        out[where] = (window.cpu(), logits.cpu(), cache["lengths"].cpu(), launched)
    n = cfg.n_layers
    assert out["cpu"][3] == (0, 0, 0, 0, 0)
    decode = (0, exit_layer * k) if paged else (exit_layer * k, 0)
    assert out["cuda"][3] == (*decode, n, k + 1, 2 * exit_layer * k + 2 * n)
    assert torch.equal(out["cuda"][2], out["cpu"][2])
    assert torch.equal(out["cuda"][0], out["cpu"][0]), "drafts differ"
    for b, width in enumerate([5, 3, 1]):
        np.testing.assert_allclose(out["cuda"][1][b, :width].numpy(),
                                   out["cpu"][1][b, :width].numpy(), atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
def test_speculative_serving_on_card():
    """Sampled (t = 0.8, top-p 0.9) speculative serving of the small llama
    on the card, contiguous and paged + chunked over a pool that preempts:
    the CPU plain path's tokens and counters, exact flash launches (n_layers
    per prefill, mixed and verify step), no leaked block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core import profiles
    from repro_torch.core.scheduler import Scheduler, ServeRequest

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, model, params = _spec_model()
    dev = torch.device("cuda")
    params_dev = _to(params, dev)
    rng = np.random.default_rng(1)
    traffic = [(i, rng.integers(0, cfg.vocab_size, size=int(rng.integers(5, 25))), 12)
               for i in range(7)]

    def run(p, device, **kw):
        sched = Scheduler(model, p, slots=3, pad_to=24, max_new_cap=12, device=device, **kw)
        done = sched.run([ServeRequest(rid=i, prompt=pr, max_new=m, profile=(
            profiles.SpeculativeProfile(temperature=0.8, top_p=0.9, exit_layer=2, n_draft=4)))
            for i, pr, m in traffic])
        return sched, {r.rid: r.tokens for r in done}

    for kw in ({}, dict(paged=True, block_size=8, num_blocks=10, chunked=True,
                        prefill_budget=8)):
        cpu, want = run(params, "cpu", **kw)
        before = fa.LAUNCHES
        card, got = run(params_dev, dev, **kw)
        torch.cuda.synchronize()
        assert card.n_spec_steps >= 1 and card.n_spec_accepted >= 1
        if kw:
            assert card.n_preemptions >= 1 and card.pool.n_used_blocks == 0
        for name in ("n_preemptions", "n_decode_steps", "n_prefills", "n_mixed_steps",
                     "n_spec_steps", "n_spec_accepted", "n_spec_committed", "spec_commit_hist"):
            assert getattr(card, name) == getattr(cpu, name), name
        assert fa.LAUNCHES - before == cfg.n_layers * (
            card.n_prefills + card.n_mixed_steps + card.n_spec_steps)
        assert got == want


def _paged_tables(g, b, mb, nb, dev):
    """Disjoint random block tables (block 0, the sink, never handed out)."""
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(b * mb)) + 1
    return perm[: b * mb].reshape(b, mb).to(torch.int32).to(dev)


#: MLA's flash shapes: the prefill at D = 192 / Dv = 128 over 128 heads, and
#: the absorbed latent (D = 576, V = K[..., :512], one KV head, 128 q heads)
#: at a mixed step (8 slots x 64 lanes over 336 gathered keys) and a verify
#: step (8 slots x 5 lanes over the contiguous 321)
MLA_FLASH = {"prefill 192/128": (1, 256, 256, 128, 128, 192, 128),
             "latent mixed": (8, 64, 336, 128, 1, 576, 512),
             "latent verify": (8, 5, 321, 128, 1, 576, 512),
             "prefill 96/64": (2, 40, 40, 4, 4, 96, 64),
             "latent mixed 96/64": (8, 16, 48, 4, 1, 96, 64),
             "latent verify 96/64": (8, 5, 40, 4, 1, 96, 64)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(MLA_FLASH))
def test_flash_attention_mla_widths_on_card(case):
    """The MLA instantiations (deepseek-v2-236b's and its smoke config's)
    against the plain version in bf16 and in f32, the latent's V a strided
    view of K (never copied), per-slot k_valid and query positions as the
    paged layer builds them, a repeat call bit-identical; a V copied out of
    K is no latent: at (576, 512) it raises, at (96, 64) the prefill's GQA
    kernel takes it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    b, tq, tk, hq, hkv, d, dv = MLA_FLASH[case]
    q = torch.randn((b, tq, hq, d), generator=g, device=dev).to(torch.bfloat16)
    if hkv == 1:
        k = torch.randn((b, tk, hkv, d), generator=g, device=dev).to(torch.bfloat16)
        v = k[..., :dv]
        lengths = torch.tensor([0, 40, 100, 200, 250, 270, 7, tk - tq][:b], dtype=torch.int32,
                               device=dev).clamp(max=tk - tq)
        t_new = torch.tensor([tq, 1, tq, 3, 0, 1, tq, tq][:b], dtype=torch.int32, device=dev)
        qpos = (lengths[:, None] + torch.arange(tq, device=dev, dtype=torch.int32)).contiguous()
        kpos = torch.arange(tk, device=dev, dtype=torch.int32)[None].expand(b, tk).contiguous()
        kw = dict(q_positions=qpos, k_positions=kpos, causal=True,
                  k_valid=kpos < (lengths + t_new)[:, None], scale=(d // 3) ** -0.5)
    else:
        k = torch.randn((b, tk, hkv, d), generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn((b, tk, hkv, dv), generator=g, device=dev).to(torch.bfloat16)
        kw = dict(causal=True, scale=(d // 3 if d == 576 else d) ** -0.5)
    before = fa.LAUNCHES
    got = ops.flash_attention(q, k, v, **kw)
    again = ops.flash_attention(q, k, v, **kw)
    want = ops.flash_attention(q, k, v, impl="torch", **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 2 and got.shape == (b, tq, hq, dv)
    close(got, want, torch.bfloat16)
    assert torch.equal(got, again)
    # f32 at the MLA widths: the CUDA-core kernel (the latent's V read at K's
    # row stride) against the plain version, a repeat call bit-identical
    qf, kf = q.float(), k.float()
    vf = kf[..., :dv] if hkv == 1 else v.float()
    got = ops.flash_attention(qf, kf, vf, **kw)
    again = ops.flash_attention(qf, kf, vf, **kw)
    want = ops.flash_attention(qf, kf, vf, impl="torch", **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 4 and got.dtype == torch.float32
    close(got, want, torch.float32)
    assert torch.equal(got, again)
    if hkv == 1:
        kw32 = {n: (t.to(torch.int32) if n.endswith("positions") else t)
                for n, t in kw.items()}
        if d == 576:  # a V copied out of K is no latent, and (576, 512) has no GQA kernel
            with pytest.raises(ValueError):
                fa.flash_attention_cuda(q, k, v.contiguous(), **kw32)
        else:  # (96, 64) is also MLA's prefill width: the GQA kernel takes the copy
            close(fa.flash_attention_cuda(q, k, v.contiguous(), **kw32),
                  fa.flash_attention_plain(q, k, v.contiguous(), **kw32), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hq,d,r", [(128, 576, 512), (4, 96, 64)])
@pytest.mark.parametrize("paged", [False, True])
def test_latent_decode_on_card(paged, hq, d, r, dtype):
    """The absorbed latent decode (q [8, 128, 576] over a 576-wide latent, V
    its leading 512 columns; and the smoke config's 4 heads over a 96-wide
    latent, V its leading 64) against the plain version in bf16 and f32:
    contiguous over S = 321 and paged over a 48-block pool of 16 through
    21-block tables, lengths 0, 1, a tile edge, mid and full, the sequence
    split (two blocks an SM) and unsplit (one batch row at S = 64); a
    repeat call bit-identical; each wrapper counts its launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    b = 8
    q = torch.randn((b, hq, d), generator=g, device=dev).to(dtype)
    scale = (d // 3) ** -0.5
    if paged:
        nb, bs, mb = 48, 16, 21
        pool = torch.randn((nb, bs, d), generator=g, device=dev).to(dtype)
        bt = _paged_tables(g, 2, mb, nb, dev)
        bt = torch.cat([bt, bt.flip(0), bt, bt, bt.flip(1), bt.flip(1), bt, bt])[:b]
        n_valid = torch.tensor([0, 1, 64, 65, 200, mb * bs, 17, 300], dtype=torch.int32,
                               device=dev)
        before = pda.LAUNCHES
        got = ops.paged_decode_attention(q, pool, None, bt, n_valid, scale=scale, v_dim=r)
        again = ops.paged_decode_attention(q, pool, None, bt, n_valid, scale=scale, v_dim=r)
        want = ops.paged_decode_attention(q, pool, None, bt, n_valid, scale=scale, v_dim=r,
                                          impl="torch")
        torch.cuda.synchronize()
        assert pda.LAUNCHES == before + 2
        # a row past its length never reads: the contiguous kernel on the gathered rows agrees
        lat = pool[bt.long()].reshape(b, mb * bs, 1, d)
        contig = ops.decode_attention(q, lat, lat[..., :r], n_valid, scale=scale)
        torch.cuda.synchronize()
        assert torch.equal(contig, got) and got.shape == (b, hq, r)
        close(got, want, dtype)
        assert torch.equal(got, again)
    else:
        for s, rows in ((321, b), (64, 1)):
            lat = torch.randn((rows, s, 1, d), generator=g, device=dev).to(dtype)
            n_valid = torch.tensor([0, 1, 64, 65, 200, s, 17, 300][:rows], dtype=torch.int32,
                                   device=dev).clamp(max=s)
            before = da.LAUNCHES
            got = ops.decode_attention(q[:rows], lat, lat[..., :r], n_valid, scale=scale)
            again = ops.decode_attention(q[:rows], lat, lat[..., :r], n_valid, scale=scale)
            want = ops.decode_attention(q[:rows], lat, lat[..., :r], n_valid, scale=scale,
                                        impl="torch")
            torch.cuda.synchronize()
            assert da.LAUNCHES == before + 2
            close(got, want, dtype)
            assert torch.equal(got, again)
        with pytest.raises(ValueError):  # the latent V must be K's slice, not a copy
            ops.decode_attention(q[:1], lat, lat[..., :r].contiguous(), n_valid, scale=scale,
                                 impl="cuda")


#: flash at the smoke configs' head widths: (B, Tq, Tk, Hq, Hkv, D, causal,
#: window, k_valid): the dense smoke configs' G = 4 at D = 32, the
#: encoder-decoders' G = 1 (cross attention: bidirectional, k_valid), the
#: hybrid's 4 heads over one KV head under its 32-row window, and D = 16
SMOKE_FLASH = {"dense 32": (2, 67, 67, 8, 2, 32, True, None, False),
               "cross 32": (3, 5, 64, 4, 4, 32, False, None, True),
               "ring 32": (2, 70, 70, 4, 1, 32, True, 32, False),
               "decode step 32": (8, 1, 40, 8, 2, 32, True, None, True),
               "gqa 16": (2, 67, 67, 8, 2, 16, True, 16, False),
               "mqa 16": (1, 130, 130, 64, 1, 16, True, None, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(SMOKE_FLASH))
def test_flash_attention_smoke_widths_on_card(case, dtype):
    """Flash at D = Dv = 16 and 32 against the plain version (causal, a
    window, bidirectional with k_valid, MQA up to G = 64, a query past every
    valid key), one launch a call, a repeat call bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(31)
    b, tq, tk, hq, hkv, d, causal, window, valid = SMOKE_FLASH[case]
    q = torch.randn((b, tq, hq, d), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((b, tk, hkv, d), generator=g, device=dev).to(dtype) for _ in range(2))
    qpos = (torch.arange(tq, device=dev, dtype=torch.int32)[None] + (tk - tq)).expand(b, tq)
    kpos = torch.arange(tk, device=dev, dtype=torch.int32)[None].expand(b, tk)
    kw = dict(q_positions=qpos.contiguous(), k_positions=kpos.contiguous(), causal=causal,
              window=window)
    if valid:
        n = torch.randint(0, tk + 1, (b,), generator=g, device=dev)
        n[0] = 0
        kw["k_valid"] = (kpos < n[:, None]).contiguous()
    before = fa.LAUNCHES
    got = ops.flash_attention(q, k, v, **kw)
    again = fa.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 2 and got.shape == q.shape
    close(got, fa.flash_attention_plain(q, k, v, **kw), dtype)
    assert torch.equal(got, again)
    if valid:
        assert bool((got[0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d,hq,hkv", [(32, 8, 2), (32, 4, 4), (32, 4, 1), (16, 8, 2),
                                      (16, 128, 1), (32, 64, 1)])
@pytest.mark.parametrize("s", [40, 321])
def test_decode_attention_smoke_widths_on_card(s, d, hq, hkv, dtype):
    """Flash-decode at D = 16 and 32 against the plain version, over a cache
    of 40 rows (one split shorter than a tile) and of 321 (split edges),
    lengths 0, 1, a tile edge and full; G up to the widest group
    (G * D = 2048); a repeat call bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(32)
    lengths = [ln for ln in (0, 1, 17, 63, 64, 65, 200, s) if ln <= s]
    b = len(lengths)
    q = torch.randn((b, hq, d), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((b, s, hkv, d), generator=g, device=dev).to(dtype) for _ in range(2))
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    before = da.LAUNCHES
    got = ops.decode_attention(q, k, v, ln)
    again = da.decode_attention_cuda(q, k, v, ln)
    torch.cuda.synchronize()
    assert da.LAUNCHES == before + 2
    close(got, da.decode_attention_plain(q, k, v, ln), dtype)
    assert torch.equal(got, again) and bool((got[0] == 0).all())


def _small_moe_on_card(arch):
    """A bf16 model of ``arch``'s family at small width but the kernels'
    head widths (qwen3-moe: heads of 64; deepseek-v2: MLA's published
    kv_lora 512, rope 64, nope 128 and v_head 128, so the latent kernels
    run), 2 layers, 8 experts, on the card."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    cfg = get_config(arch)
    cfg = cfg.replace(n_layers=2, d_model=256, n_heads=4, d_ff=512, vocab_size=1024,
                      n_kv_heads=2 if cfg.mla is None else 4,
                      d_head=64 if cfg.mla is None else cfg.d_head,
                      moe=dataclasses.replace(cfg.moe, n_experts=8, d_ff_expert=128,
                                              d_ff_dense=512 if cfg.moe.d_ff_dense else 0),
                      mla=None if cfg.mla is None else dataclasses.replace(cfg.mla,
                                                                           q_lora_rank=128))
    model = get_model(cfg)
    dev = torch.device("cuda")
    return cfg, model, model.init(torch.Generator(device=dev).manual_seed(0), dev)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", list(STAGED_POOLS))
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "deepseek-v2-236b"])
def test_moe_step_begin_makes_no_sync_on_card(arch, pool):
    """The MoE families keep the two-phase step sync-free: every
    ``step_begin`` of a served trace (routing over every lane, static
    capacity, the scatter-add; MLA's latent writes and absorbed attention)
    runs under ``set_sync_debug_mode("error")``; each request gets its
    tokens and each step kind launched its kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core.scheduler import Scheduler, ServeRequest

    cfg, model, params = _small_moe_on_card(arch)
    rng = np.random.default_rng(5)
    sched = Scheduler(model, params, slots=3, pad_to=24, max_new_cap=10,
                      device=torch.device("cuda"), **STAGED_POOLS[pool])
    sched.submit([ServeRequest(rid=i, prompt=rng.integers(0, cfg.vocab_size, 20), max_new=10,
                               temperature=0.8 * (i % 2), top_p=0.9) for i in range(4)])
    before = (fa.LAUNCHES, da.LAUNCHES, pda.LAUNCHES)
    kinds = set()
    with torch.inference_mode():
        while sched.waiting or sched.has_work:
            sched._admit(sched._now())
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                pending = sched.step_begin()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            kinds.add(pending[0])
            sched.step_finish(pending)
    assert kinds == ({"decode", "mixed"} if pool == "chunked" else {"decode"})
    assert len(sched.finished) == 4 and all(len(r.tokens) == 10 for r in sched.finished)
    launched = (fa.LAUNCHES - before[0], da.LAUNCHES - before[1], pda.LAUNCHES - before[2])
    assert launched[0] > 0 and (launched[2] if pool == "chunked" else launched[1]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,t,window", [
    (dt, b, t, w) for dt in (torch.bfloat16, torch.float32)
    for b, t, w in ((1, 256, 2048), (1, 67, None), (2, 300, 64))] + [
    (torch.bfloat16, 1, 2200, 2048)])
def test_flash_attention_d256_window_on_card(dtype, b, t, window):
    """Flash at D = Dv = 256, 10 q heads over one KV head (recurrentgemma's
    local attention), causal under a window, against the plain version (f32
    at the small shapes); a repeat call bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(25)
    q = torch.randn((b, t, 10, 256), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((b, t, 1, 256), generator=g, device=dev).to(dtype) for _ in range(2))
    pos = torch.arange(t, device=dev, dtype=torch.int32)[None].expand(b, t).contiguous()
    kw = dict(q_positions=pos, k_positions=pos, causal=True, window=window)
    before = fa.LAUNCHES
    got = ops.flash_attention(q, k, v, window=window)
    close(got, fa.flash_attention_plain(q, k, v, **kw), dtype)
    assert torch.equal(got, fa.flash_attention_cuda(q, k, v, **kw))
    assert fa.LAUNCHES == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,lengths", [(321, [0, 1, 63, 64, 65, 200, 320, 321]),
                                       (2048, [2048, 1500])])
def test_decode_attention_group_width_2560_on_card(s, lengths, dtype):
    """Flash-decode at G * D = 10 x 256 = 2560 over a ring of ``s`` rows,
    lengths at the split edges, against the plain version (a row of length
    0 exact zeros, a repeat call bit-identical); the paged kernel refuses
    D = 256."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(26)
    b = len(lengths)
    q = torch.randn((b, 10, 256), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((b, s, 1, 256), generator=g, device=dev).to(dtype) for _ in range(2))
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    got = ops.decode_attention(q, k, v, ln)
    close(got, da.decode_attention_plain(q, k, v, ln), dtype)
    assert torch.equal(got, da.decode_attention_cuda(q, k, v, ln))
    if lengths[0] == 0:
        assert bool((got[0] == 0).all())
    bt = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="D == Dv"):
        pda.paged_decode_attention_cuda(q, k[:1, :16].contiguous(), v[:1, :16].contiguous(),
                                        bt, ln.clamp(max=16))
    with pytest.raises(ValueError, match="q heads"):
        da.decode_attention_cuda(torch.cat([q, q[:, :1]], dim=1), k, v, ln)


@pytest.mark.cuda
def test_hybrid_served_on_card_matches_the_cpu():
    """A small f32 recurrentgemma (the published pattern, heads and window
    at d 128) served on the card through the scheduler at pad 48 over a
    window of 32: the CPU run's tokens, flash and decode launched in its
    attention layers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.scheduler import Scheduler, ServeRequest
    from repro_torch.models import get_model

    torch.backends.cuda.matmul.allow_tf32 = False
    smoke = get_smoke_config("recurrentgemma-2b")
    cfg = smoke.replace(dtype="float32", n_heads=10, d_head=256,
                        hybrid=dataclasses.replace(smoke.hybrid, window=32))
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(7)
    traffic = [(i, rng.integers(0, cfg.vocab_size, int(rng.integers(3, 49))), 20)
               for i in range(4)]
    tokens = {}
    before = (fa.LAUNCHES, da.LAUNCHES)
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else _to(params, torch.device("cuda"))
        sched = Scheduler(model, p, slots=2, pad_to=48, max_new_cap=20, device=dev)
        done = sched.run([ServeRequest(rid=i, prompt=pr, max_new=m) for i, pr, m in traffic])
        tokens[dev] = {r.rid: r.tokens for r in done}
    assert tokens["cuda"] == tokens["cpu"]
    assert fa.LAUNCHES > before[0] and da.LAUNCHES > before[1]


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.cuda
def test_training_under_auto_raises_on_card():
    """A forward under ``impl="auto"`` with params that require a gradient:
    the first kernel dispatch (RMSNorm) refuses, since the kernels have no
    backward; under ``impl="torch"`` the same step runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.models import layers as L
    from repro_torch.training import train_loop as tl

    dev = torch.device("cuda")
    model = get_model(get_smoke_config("llama3.2-1b").replace(d_head=64, n_heads=4,
                                                              n_kv_heads=2))
    params = L.drop_f32_table(model.init(torch.Generator(device=dev).manual_seed(0), dev))
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32, device=dev),
             "labels": torch.ones((2, 8), dtype=torch.int32, device=dev)}
    before = rn.LAUNCHES
    with pytest.raises(RuntimeError, match="no backward"):
        tl.value_and_grad(model, params, batch, impl="auto")
    assert rn.LAUNCHES == before
    loss, _, grads = tl.value_and_grad(model, params, batch, impl="torch")
    assert bool(torch.isfinite(loss)) and rn.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-130m", "recurrentgemma-2b"])
def test_f32_train_step_on_card_matches_the_cpu(arch):
    """One f32 ``make_train_step`` step of the smoke config on the card
    (TF32 off, ``impl="torch"``) against the same step on the CPU: loss,
    gradient norm and every new param at atol 2e-5 / rtol 2e-4, but where
    the CPU's gradient is rounding noise (there within 2 lr)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.models import layers as L
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_loop as tl

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch).replace(dtype="float32")
    model = get_model(cfg)
    params = L.drop_f32_table(model.init(torch.Generator().manual_seed(0), "cpu"))
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32))
             for k in ("tokens", "labels")}
    ocfg = opt.OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    out = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, torch.device(dev))
        b = {k: v.to(dev) for k, v in batch.items()}
        _, _, grads = tl.value_and_grad(model, p, b, impl="torch")
        new, _, metrics = tl.make_train_step(model, ocfg, impl="torch")(
            p, opt.init_state(p, ocfg), b)
        out[dev] = (opt.leaf_list(_to(new, torch.device("cpu"))),
                    opt.leaf_list(_to(grads, torch.device("cpu"))),
                    {k: float(v) for k, v in metrics.items()})
    for k, v in out["cpu"][2].items():
        assert v == pytest.approx(out["cuda"][2][k], rel=2e-4, abs=2e-5), k
    for want, got, g in zip(out["cpu"][0], out["cuda"][0], out["cpu"][1]):
        noise = g.abs() <= 2e-5 + 2e-4 * g.abs().max()
        ok = torch.isclose(got, want, atol=2e-5, rtol=2e-4)
        assert bool(ok[~noise].all())
        assert bool(((got - want).abs()[noise] <= 2 * ocfg.lr).all())
