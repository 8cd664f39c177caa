"""The port's operator-class characterization against the JAX package's, and
the measured breakdown's classifier.

- ``core/characterization.py``: ``op_breakdown`` and ``roofline_times`` equal
  the reference's bit for bit (every class's flops and bytes, and the
  roofline times at the same explicit constants) on every architecture both
  packages register, prefill and decode at two shapes each, and on
  recurrentgemma-2b's hybrid branch through a port ``ModelConfig`` built
  from the reference config's fields; ``roofline_times`` defaults to the
  H100's 989 TFLOP/s and 3.35 TB/s.
- ``launch/op_breakdown.py``: ``classify`` on each rule of ``CLASS_RULES``
  (kernel names, the launching op, the KV-row and embedding-table shapes),
  ``breakdown``'s window arithmetic (overlapping kernels, spin kernels and
  kernels outside the window left out, each class's longest kernels) and
  ``kernel_records``' link from a device kernel to its aten op, all on
  synthetic profiler events; ``problems`` on each fault it names (a kernel
  linked to no op among them) and ``measure``'s retry of a session short
  of the ported kernels, on stand-in sessions; no card is needed."""
import dataclasses
import inspect
from types import SimpleNamespace

import pytest

from repro.configs import CONFIGS as JCONFIGS
from repro.core import characterization as jchar
from repro_torch.configs import CONFIGS
from repro_torch.configs import base as tbase
from repro_torch.core import characterization as tchar
from repro_torch.launch import op_breakdown as ob

SHARED = sorted(set(CONFIGS) & set(JCONFIGS))
#: (batch, prompt or context) of each mode: two shapes
SHAPES = {"prefill": [(1, 7), (4, 154)], "decode": [(8, 321), (16, 1050)]}
CONSTANTS = [dict(peak_flops=197e12, hbm_bw=819e9), dict(peak_flops=989e12, hbm_bw=3.35e12)]


def port_config(jcfg):
    """A port ``ModelConfig`` from a reference config's fields, each
    sub-config rebuilt as the port's class of the same name."""
    def conv(v):
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            cls = getattr(tbase, type(v).__name__)
            return cls(**{f.name: conv(getattr(v, f.name)) for f in dataclasses.fields(v)})
        return v
    return conv(jcfg)


def assert_same(tcfg, jcfg, mode, batch, seq):
    got = tchar.op_breakdown(tcfg, mode=mode, batch=batch, seq=seq)
    want = jchar.op_breakdown(jcfg, mode=mode, batch=batch, seq=seq)
    assert list(got) == list(want)
    for k in want:
        assert (got[k].flops, got[k].bytes) == (want[k].flops, want[k].bytes), k
    for c in CONSTANTS:
        assert tchar.roofline_times(got, **c) == jchar.roofline_times(want, **c)


def test_every_shared_arch_is_covered():
    assert len(SHARED) == len(CONFIGS) == 12


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("arch", SHARED)
def test_op_breakdown_matches_jax_bit_for_bit(arch, mode):
    for batch, seq in SHAPES[mode]:
        assert_same(CONFIGS[arch], JCONFIGS[arch], mode, batch, seq)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_hybrid_branch_matches_jax(mode):
    jcfg = JCONFIGS["recurrentgemma-2b"]
    tcfg = port_config(jcfg)
    assert isinstance(tcfg, tbase.ModelConfig) and isinstance(tcfg.hybrid, tbase.HybridConfig)
    kinds = {tcfg.hybrid.block_kind(i) for i in range(tcfg.n_layers)}
    assert kinds == {"attention", "recurrent"}
    for batch, seq in SHAPES[mode] + [(2, 4096)]:  # past the local window too
        assert_same(tcfg, jcfg, mode, batch, seq)


def test_roofline_defaults_are_the_h100s():
    sig = inspect.signature(tchar.roofline_times).parameters
    assert sig["peak_flops"].default == 989e12 and sig["hbm_bw"].default == 3.35e12
    costs = tchar.op_breakdown(CONFIGS["yi-34b"], mode="decode", batch=4, seq=846)
    assert tchar.roofline_times(costs) == tchar.roofline_times(costs, peak_flops=989e12,
                                                               hbm_bw=3.35e12)


def test_analytic_shares_sum_to_one():
    ana = ob.analytic(CONFIGS["yi-34b"], "P", 4, 154)
    assert set(ana) == set(ob.CLASSES)
    assert abs(sum(a["share"] for a in ana.values()) - 1.0) < 1e-12
    assert max(ana, key=lambda c: ana[c]["ms"]) == "linear"


# ------------------------------------------------------------ classifier
KV = [(8, 128)]
TABLE = [(64000, 7168)]
CASES = [
    # (kernel name, launching op, its input shapes, class)
    ("void flash_attention_mma_kernel<128, 128>(...)", None, (), "attention"),
    ("void decode_attention_kernel<__nv_bfloat16, 128>(...)", None, (), "attention"),
    ("void decode_attention_paged_kernel<__nv_bfloat16, 128>(...)", None, (), "attention"),
    ("void decode_attention_combine_kernel<__nv_bfloat16>(...)", None, (), "attention"),
    ("void decode_latent_kernel<false>(...)", None, (), "attention"),
    ("hstu_attention_mma_kernel", None, (), "attention"),
    ("ssd_chunk_scan_kernel", None, (), "attention"),
    ("void rmsnorm_warp_kernel<__nv_bfloat16, 1, 8, 2>(...)", None, (), "norm"),
    ("rmsnorm_block_kernel", "aten::copy_", ((4, 154, 8, 128),), "norm"),
    ("int8_wo_mma_kernel", None, (), "linear"),
    ("int8_splitk_reduce", None, (), "linear"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT", "aten::mm", ((616, 7168), (7168, 7168)),
     "linear"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", None, (), "linear"),
    ("void gemv2T_kernel_val<int, int, float>(...)", "aten::mm", (), "linear"),
    ("void cutlass::Kernel2<cutlass_80_wmma_tensorop>(...)", None, (), "linear"),
    ("void splitKreduce_kernel<32, 16, int, float>(...)", None, (), "linear"),
    ("void at::native::elementwise_kernel<128, 4>(...)", "aten::bmm",
     ((128, 8, 2048), (128, 2048, 768)), "linear"),
    ("void at::native::index_elementwise_kernel<128, 4>(...)", "aten::index",
     ((64000, 7168), ()), "embed"),
    ("void at::native::index_elementwise_kernel<128, 4>(...)", "aten::index",
     ((48, 16, 8, 128), (8, 21)), "attention"),
    ("void at::native::vectorized_elementwise_kernel<4, copy>(...)", "aten::copy_",
     ((4, 154, 8, 128), (4, 154, 8, 128)), "attention"),
    ("void at::native::vectorized_elementwise_kernel<4, fill>(...)", "aten::fill_",
     ((4, 692, 8, 128), ()), "attention"),
    ("void at::native::index_put_kernel_impl(...)", "aten::_index_put_impl_",
     ((4, 847, 8, 128), (), (4, 8, 128), ()), "attention"),
    ("void at::native::indexSelectLargeIndex<...>(...)", "aten::index_select",
     ((128, 1500, 8, 128), (128,)), "attention"),
    ("void at::native::vectorized_elementwise_kernel<4, copy>(...)", "aten::copy_",
     ((4, 154, 64000), (4, 154, 64000)), "other"),
    ("void at::native::vectorized_elementwise_kernel<4, copy>(...)", "aten::copy_",
     ((8, 128), (8, 128)), "other"),  # a KV row alone is no cache
    ("void at::native::index_elementwise_kernel<128, 4>(...)", "aten::index",
     ((5, 7168), ()), "other"),
    ("void at::native::vectorized_elementwise_kernel<4, mul>(...)", "aten::mul",
     ((4, 154, 56, 64), (4, 154, 1, 64)), "other"),
    ("Memcpy HtoD (Pageable -> Device)", "aten::copy_", ((4, 154), (4, 154)), "other"),
    ("Memset (Device)", None, (), "other"),
]


@pytest.mark.parametrize("name,op,shapes,cls", CASES)
def test_classify(name, op, shapes, cls):
    k = ob.Kernel(name, 0.0, 1.0, op, shapes)
    assert ob.classify(k, kv_rows=KV, tables=TABLE) == cls


def test_classify_latent_rows():
    k = ob.Kernel("copy", 0.0, 1.0, "aten::_index_put_impl_", ((768, 576), (), (8, 576)))
    assert ob.classify(k, kv_rows=[(576,)]) == "attention"
    assert ob.classify(k, kv_rows=KV) == "other"


def test_breakdown_window_arithmetic():
    kern = [
        ob.Kernel("flash_attention_mma_kernel", 10.0, 30.0),
        ob.Kernel("nvjet_gemm", 20.0, 40.0),  # overlaps the flash kernel by 10 us
        ob.Kernel("nvjet_gemm", 50.0, 55.0),
        ob.Kernel("rmsnorm_block_kernel", 60.0, 61.0),
        ob.Kernel("spin_kernel", 70.0, 80.0),  # the profiler's padding
        ob.Kernel("nvjet_gemm", -30.0, -10.0),  # before the window
        ob.Kernel("gemv_tail", 95.0, 120.0),  # clipped at the window's end
        ob.Kernel("other_kernel", 62.0, 64.0),
    ]
    res = ob.breakdown(kern, (0.0, 100.0), top=2)
    c = res["classes"]
    assert res["window_ms"] == 0.1 and res["n_kernels"] == 6 and res["linked"] == 0
    assert res["unlinked"] == {"other_kernel": 1}  # the rest are placed by name
    assert c["linear"]["n"] == 3 and abs(c["linear"]["ms"] - 0.030) < 1e-12
    assert abs(c["attention"]["ms"] - 0.020) < 1e-12 and c["attention"]["n"] == 1
    assert abs(c["norm"]["ms"] - 0.001) < 1e-12 and abs(c["other"]["ms"] - 0.002) < 1e-12
    assert c["embed"] == {"ms": 0.0, "n": 0, "share": 0.0, "top": []}
    # busy: [10, 40] + [50, 55] + [60, 61] + [62, 64] + [95, 100] = 43 us
    assert abs(res["busy_ms"] - 0.043) < 1e-12 and abs(res["idle_ms"] - 0.057) < 1e-12
    assert abs(res["idle_share"] - 0.57) < 1e-9
    assert abs(res["residual"] - 0.1) < 1e-9  # the 10 us counted twice
    assert [t[0] for t in c["linear"]["top"]] == ["nvjet_gemm", "gemv_tail"]
    assert c["linear"]["top"][0][2] == 2 and abs(c["linear"]["top"][0][1] - 0.025) < 1e-12
    total = sum(x["ms"] for x in c.values()) + res["idle_ms"]
    assert abs(total - res["window_ms"] * (1 + res["residual"])) < 1e-12


def test_breakdown_without_overlap_sums_to_the_window():
    kern = [ob.Kernel(f"k{i}", 10.0 * i, 10.0 * i + 4.0) for i in range(10)]
    res = ob.breakdown(kern, (0.0, 100.0))
    assert res["residual"] == pytest.approx(0.0, abs=1e-12)
    assert res["classes"]["other"]["n"] == 10 and res["idle_ms"] == pytest.approx(0.06)
    assert len(res["classes"]["other"]["top"]) == 5


def test_union_us():
    assert ob.union_us([]) == 0.0
    assert ob.union_us([(0, 1), (0.5, 2), (3, 4), (3.5, 3.7)]) == 3.0


def _event(name, dev, start, end, eid=0, shapes=(), parent=None):
    from torch.autograd import DeviceType

    return SimpleNamespace(name=name, device_type=getattr(DeviceType, dev), id=eid,
                           input_shapes=list(shapes), cpu_parent=parent,
                           time_range=SimpleNamespace(start=start, end=end))


def test_kernel_records_links_kernels_to_their_ops():
    window = _event(ob.WINDOW, "CPU", 5.0, 95.0, eid=1)
    index = _event("aten::index", "CPU", 10.0, 12.0, eid=7, shapes=[[64000, 7168], []],
                   parent=window)
    events = [
        window,
        _event(ob.WINDOW, "CUDA", 6.0, 90.0, eid=1),  # the range's device twin
        index,
        _event("cudaLaunchKernel", "CPU", 10.5, 11.0, eid=99, parent=index),
        _event("index_elementwise_kernel", "CUDA", 20.0, 22.0, eid=99),
        _event("cudaLaunchKernel", "CPU", 30.0, 30.5, eid=7, parent=window),  # ids of two spaces
        _event("rmsnorm_block_kernel", "CUDA", 31.0, 32.0, eid=7),
        _event("Memset (Device)", "CUDA", 40.0, 41.0, eid=123),  # no host call recorded
    ]
    kern, win = ob.kernel_records(events)
    assert win == (5.0, 95.0)
    assert kern == [ob.Kernel("index_elementwise_kernel", 20.0, 22.0, "aten::index",
                              ((64000, 7168), ())),
                    ob.Kernel("rmsnorm_block_kernel", 31.0, 32.0, None, ()),
                    ob.Kernel("Memset (Device)", 40.0, 41.0, None, ())]
    res = ob.breakdown(kern, win, kv_rows=KV, tables=TABLE)
    assert res["classes"]["embed"]["n"] == 1 and res["classes"]["norm"]["n"] == 1
    assert res["linked"] == 1 and res["n_kernels"] == 3
    assert res["unlinked"] == {"Memset (Device)": 1}


def test_rules_name_every_class_but_other():
    assert {r[0] for r in ob.CLASS_RULES} == set(ob.CLASSES) - {"other"}
    assert set(ob.WORKLOADS) == {"T-T", "I-T", "S-T", "H-A"}
    assert all(a in CONFIGS for a, *_ in ob.WORKLOADS.values())


@pytest.mark.parametrize("name,op,shapes,cls", CASES)
def test_name_class_decides_only_by_name(name, op, shapes, cls):
    by_name = ob.name_class(name)
    assert by_name is None or by_name == cls
    if by_name is not None:  # the op and its shapes change nothing
        assert ob.classify(ob.Kernel(name, 0.0, 1.0, "aten::index", ((64000, 7168),)),
                           kv_rows=KV, tables=TABLE) == cls


#: a window's kernels: one flash, one decode and its combine, two RMSNorms,
#: a GEMM, the KV write and the token gather (each linked to its op)
WINDOW_KERNELS = [
    ob.Kernel("flash_attention_mma_kernel", 1.0, 2.0),
    ob.Kernel("decode_attention_kernel", 3.0, 4.0),
    ob.Kernel("decode_attention_combine_kernel", 4.0, 5.0),
    ob.Kernel("rmsnorm_warp_kernel", 5.0, 6.0),
    ob.Kernel("rmsnorm_warp_kernel", 6.0, 7.0),
    ob.Kernel("nvjet_gemm", 7.0, 9.0, "aten::mm", ((4, 7168), (7168, 7168))),
    ob.Kernel("copy_kernel", 9.0, 9.5, "aten::copy_", ((4, 847, 8, 128),)),
    ob.Kernel("index_elementwise_kernel", 9.5, 10.0, "aten::index", ((64000, 7168), ())),
]
LAUNCHED = {"flash_attention": 1, "decode_attention": 1, "paged_decode_attention": 0,
            "hstu_attention": 0, "rmsnorm": 2}


def _result(kern, launched=LAUNCHED):
    res = ob.breakdown(kern, (0.0, 10.0), kv_rows=KV, tables=TABLE)
    res["ported"] = ob.ported(kern, (0.0, 10.0), launched, kv_rows=KV, tables=TABLE)
    return res


def test_ported_counts_each_kernel_by_its_wrappers():
    got = _result(WINDOW_KERNELS)["ported"]
    assert got == {
        "flash": {"seen": 1, "launched": 1, "classes": ["attention"], "want": "attention"},
        "decode": {"seen": 1, "launched": 1, "classes": ["attention"], "want": "attention"},
        "hstu": {"seen": 0, "launched": 0, "classes": [], "want": "attention"},
        "rmsnorm": {"seen": 2, "launched": 2, "classes": ["norm"], "want": "norm"}}
    assert set(ob.read_launches()) == {c for ctrs, _, _ in ob.PORTED.values() for c in ctrs}


def test_problems_of_a_sound_window():
    res = _result(WINDOW_KERNELS)
    assert ob.problems(res) == []
    assert res["classes"]["embed"]["n"] == 1 and res["classes"]["attention"]["n"] == 4


@pytest.mark.parametrize("fault", ["unlinked", "lost", "extra", "overlap"])
def test_problems_name_each_fault(fault):
    kern, launched = list(WINDOW_KERNELS), dict(LAUNCHED)
    if fault == "unlinked":  # the KV write's link to its op lost: it would be ``other``
        kern[6] = kern[6]._replace(op=None, shapes=())
        want = "linked to no aten op: {'copy_kernel': 1}"
    elif fault == "lost":  # a session that lost a device record
        del kern[3]
        want = "rmsnorm: 1 kernels seen in ['norm'] of 2 launched"
    elif fault == "extra":  # a wrapper that launched without counting
        launched["flash_attention"] = 0
        want = "flash: 1 kernels seen in ['attention'] of 0 launched"
    else:  # two kernels at once for more than 1 % of the window
        kern[5] = kern[5]._replace(start_us=6.5)
        want = "classes plus idle are 1.0500 of the window"
    got = ob.problems(_result(kern, launched))
    assert len(got) == 1 and want in got[0]


def test_measure_takes_a_short_session_again(monkeypatch):
    """The first session loses an RMSNorm record: ``measure`` profiles the
    window again, with the counters reset before each session."""
    sessions = [WINDOW_KERNELS[:3] + WINDOW_KERNELS[4:], WINDOW_KERNELS]
    calls, counts = [], {}

    def window_call(*a):
        return (lambda: calls.append("fn")), KV, TABLE, "tokens [4, 154]"

    def profile_window(fn, session):
        assert session == "session" and counts == {}
        fn()
        counts.update(LAUNCHED)
        return sessions.pop(0), (0.0, 10.0)

    monkeypatch.setattr(ob, "window_call", window_call)
    monkeypatch.setattr(ob, "wall_ms", lambda fn: 12.5)
    monkeypatch.setattr(ob, "profile_window", profile_window)
    res = ob.measure("T-T", "P", CONFIGS["yi-34b"], None, None, "cpu", session="session",
                     reset=counts.clear, read=lambda: dict(counts))
    assert not sessions and calls == ["fn"] * 3  # the warm-up, then two sessions
    assert [len(k) for k in res["short"]] == [7] and res["kernels"] == WINDOW_KERNELS
    assert ob.problems(res) == [] and res["launched"] == LAUNCHED and res["wall_ms"] == 12.5
    assert (res["batch"], res["seq"], res["arch"]) == (4, 154, "yi-34b")


def test_measure_reports_a_session_short_twice(monkeypatch):
    short = WINDOW_KERNELS[:3] + WINDOW_KERNELS[4:]
    monkeypatch.setattr(ob, "window_call", lambda *a: ((lambda: None), KV, TABLE, ""))
    monkeypatch.setattr(ob, "wall_ms", lambda fn: 1.0)
    monkeypatch.setattr(ob, "profile_window", lambda fn, session: (short, (0.0, 10.0)))
    res = ob.measure("T-T", "D", CONFIGS["yi-34b"], None, None, "cpu", session=None,
                     reset=lambda: None, read=lambda: dict(LAUNCHED))
    assert len(res["short"]) == 2
    assert ob.problems(res) == ["rmsnorm: 1 kernels seen in ['norm'] of 2 launched "
                                "(class norm)"]
