"""The port's analysis pass (``repro_torch.analysis``): the AST lint's rules
on fixtures, the checked-in baseline over ``src/repro_torch``, the step
audit's checks against planted bad steps, the real audit at the smoke
geometry, and the static-shape verify-window write against the reference's
``write_window``.

Each lint rule gets a known-bad fixture (must fire), a known-good one (must
stay silent), the registry and a suppression; the step audit gets one
planted fault a check (a cache-sized copy, an f64, a cache-sized bf16 ->
f32 upcast, a ``nonzero`` whose shape follows the data) and must report
that check and no other. The audit runs on the CPU here (no capture: that
check needs a card, ``chip_smoke.py``'s ``audit`` phase)."""
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import astlint, trace_audit
from repro_torch.analysis.hotpath import HOT_PATHS, hot_path
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention as A
from repro_torch.models import get_model

REPO_ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while the module runs: the audit's serving loops
    are thousands of tiny eager ops, which a thread pool only slows."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rules(findings):
    return sorted(f.rule for f in findings)


# --------------------------------------------------------------------------
# HS001 — host syncs in hot-path functions
# --------------------------------------------------------------------------

HS_BAD = """
import numpy as np
from repro_torch.analysis.hotpath import hot_path

@hot_path
def step(pool, logits):
    toks = np.asarray(logits)
    return toks
"""

HS_GOOD = """
from repro_torch.analysis.hotpath import hot_path

@hot_path
def step(self, pool, fetched):
    host = self._staging.wait(fetched)
    feed, done = host[:2], host[2:]
    n = len(pool.slots)
    return int(feed[0]), bool(done.all()), n
"""


def test_hs001_fires_on_asarray_in_hot_path():
    findings = astlint.lint_source(HS_BAD)
    assert rules(findings) == ["HS001"]
    assert "asarray" in findings[0].snippet


def test_hs001_silent_on_the_staged_wait():
    # the sanctioned idiom: ONE staged copy of the step's outputs; casts of
    # what it returned (and of slices of it, and len() on host lists) are free
    assert astlint.lint_source(HS_GOOD) == []
    assert not any(f.rule == "HS001"
                   for f in astlint.lint_source(HS_GOOD.replace("@hot_path\n", "")))


def test_hs001_registry_hotness_without_decorator():
    src = "def decode_step(model, cache):\n    return cache['lengths'].cpu()\n"
    assert "repro_torch.core.engine.decode_step" in HOT_PATHS
    findings = astlint.lint_source(src, "src/repro_torch/core/engine.py",
                                   "repro_torch.core.engine")
    assert rules(findings) == ["HS001"]
    # the same function in a module off the registry stays silent
    assert astlint.lint_source(src, "x.py", "somewhere.else") == []


@pytest.mark.parametrize("line,what", [
    ("a = logits.item()", ".item()"),
    ("a = logits.tolist()", ".tolist()"),
    ("a = logits.cpu()", ".cpu()"),
    ("a = logits.numpy()", ".numpy()"),
    ("a = np.array(logits)", "np.array()"),
    ("torch.cuda.synchronize()", "synchronize"),
    ("event.synchronize()", "synchronize"),
    ("a = logits.nonzero()", "nonzero()"),
    ("a = torch.masked_select(logits, mask)", "masked_select()"),
    ("a = torch.unique(logits)", "unique()"),
    ("a = torch.tensor([1, 2], device=logits.device)", "torch.tensor"),
    ("a = torch.as_tensor(rows, device='cuda')", "torch.as_tensor"),
    ("a = int(logits[0])", "int()"),
    ("a = float(logits.max())", "float()"),
    ("a = bool(mask.any())", "bool()"),
])
def test_hs001_fires_on_each_sync(line, what):
    src = ("import numpy as np\nimport torch\n"
           "from repro_torch.analysis.hotpath import hot_path\n\n"
           f"@hot_path\ndef step(logits, mask, event, rows):\n    {line}\n")
    findings = astlint.lint_source(src)
    assert rules(findings) == ["HS001"], findings
    assert what in findings[0].message
    # the same line in a cold function is nobody's business
    assert astlint.lint_source(src.replace("@hot_path\n", "")) == []


def test_hs001_item_and_cast_fire():
    src = """
from repro_torch.analysis.hotpath import hot_path

@hot_path
def step(cache, logits):
    a = logits.item()
    b = int(logits[0])
    return a, b
"""
    assert rules(astlint.lint_source(src)) == ["HS001", "HS001"]


def test_hs001_host_tensors_and_plain_copies_stay_silent():
    src = """
import torch
from repro_torch.analysis.hotpath import hot_path

@hot_path
def step(self, n):
    a = torch.tensor([1, 2])  # built on the host: no copy
    b = self._staging.put("token", self._token)
    c = int(len(self.slots))
    return a, b, c
"""
    assert astlint.lint_source(src) == []


def test_hs001_suppression_comment():
    src = """
import numpy as np
from repro_torch.analysis.hotpath import hot_path

@hot_path
def step(slots):
    sl = np.asarray(slots)  # repro-lint: disable=HS001 — host list
    return sl
"""
    assert astlint.lint_source(src) == []


def test_standalone_suppression_above_the_line():
    src = """
from repro_torch.analysis.hotpath import hot_path

@hot_path
def step(key):
    # repro-lint: disable=HS001 — the caller's key, moved once
    # before the loop
    key = key.cpu()
    return key
"""
    assert astlint.lint_source(src) == []


# --------------------------------------------------------------------------
# TB001 — Python branches on device values in hot-path functions
# --------------------------------------------------------------------------

TB_BAD = """
import torch
from repro_torch.analysis.hotpath import hot_path

@hot_path
def step(x, lengths):
    if x.any():
        x = x + 1
    while torch.any(lengths > 3):
        lengths = lengths - 1
    return x, lengths
"""


def test_tb001_fires_on_device_branches():
    findings = astlint.lint_source(TB_BAD)
    assert rules(findings) == ["TB001", "TB001"]
    assert ".any()" in findings[0].message and "torch.any" in findings[1].message


def test_tb001_honours_registry_and_cold_functions():
    src = "def verify_step(model, cache, t_new):\n    if t_new.sum() > 0:\n        pass\n"
    assert rules(astlint.lint_source(src, "e.py", "repro_torch.core.engine")) == ["TB001"]
    assert astlint.lint_source(src, "e.py", "repro_torch.launch.serve") == []


@pytest.mark.parametrize("test", [
    "extra is None", "extra is not None", "n > 2", "torch.cuda.is_available()",
    "torch.is_grad_enabled()", "self.paged and not self.active",
])
def test_tb001_silent_on_host_tests(test):
    src = ("import torch\nfrom repro_torch.analysis.hotpath import hot_path\n\n"
           f"@hot_path\ndef step(self, x, n, extra):\n    if {test}:\n        return x\n"
           "    return n\n")
    assert astlint.lint_source(src) == []


def test_tb001_suppression_covers_the_test_not_the_body():
    src = """
from repro_torch.analysis.hotpath import hot_path

@hot_path
def step(self, x):
    if not self._temp.any():  # repro-lint: disable=TB001 — a numpy array
        if x.any():
            pass
"""
    findings = astlint.lint_source(src)
    assert rules(findings) == ["TB001"] and findings[0].line == 7


# --------------------------------------------------------------------------
# fingerprints + baseline
# --------------------------------------------------------------------------

def test_fingerprints_stable_under_line_drift():
    a = astlint.lint_source(HS_BAD, "m.py", "m")
    b = astlint.lint_source("\n\n\n" + HS_BAD, "m.py", "m")
    assert a and [f.fingerprint for f in a] == [f.fingerprint for f in b]
    assert [f.line for f in a] != [f.line for f in b]


def test_baseline_roundtrip_and_matching(tmp_path):
    findings = astlint.lint_source(HS_BAD, "m.py", "m")
    path = tmp_path / "baseline.json"
    astlint.write_baseline(findings, path)
    baseline = astlint.load_baseline(path)

    new, stale = astlint.apply_baseline(findings, baseline)
    assert new == [] and stale == set()

    # fixing the violation leaves its fingerprint stale in the baseline
    new, stale = astlint.apply_baseline(astlint.lint_source(HS_GOOD, "m.py", "m"), baseline)
    assert new == [] and stale == baseline and stale

    # a fresh violation is NOT absorbed by an unrelated baseline entry
    new, _ = astlint.apply_baseline(astlint.lint_source(TB_BAD, "m.py", "m"), baseline)
    assert rules(new) == ["TB001", "TB001"]


def test_missing_baseline_is_empty(tmp_path):
    assert astlint.load_baseline(tmp_path / "nope.json") == set()


def test_repo_is_lint_clean_against_checked_in_baseline():
    findings = astlint.lint_paths(REPO_ROOT)
    baseline = astlint.load_baseline(REPO_ROOT / "src/repro_torch/analysis/baseline.json")
    new, stale = astlint.apply_baseline(findings, baseline)
    assert new == [], [f.fingerprint for f in new]
    assert stale == set() and baseline == set()


def test_hot_path_decorator_is_a_runtime_noop():
    def fn():
        return 7

    marked = hot_path(fn)
    assert marked is fn and fn.__repro_hot_path__ and fn() == 7


# --------------------------------------------------------------------------
# the step audit: planted faults, each caught by its check alone
# --------------------------------------------------------------------------

def _smoke(dtype):
    model = get_model(get_smoke_config(trace_audit.ARCH).replace(dtype=dtype))
    with torch.inference_mode():
        params = model.init(torch.Generator().manual_seed(0), torch.device("cpu"))
    return model, params


@pytest.fixture(scope="module")
def f32_steps():
    model, params = _smoke("float32")
    steps = trace_audit.serving_steps(model, params, paged=False, device=torch.device("cpu"))
    return params, {s.label: s for s in steps}


@pytest.fixture(scope="module")
def bf16_steps():
    model, params = _smoke("bfloat16")
    steps = trace_audit.serving_steps(model, params, paged=True, device=torch.device("cpu"))
    return params, {s.label: s for s in steps}


def _planted(step, extra):
    """``step`` with ``extra(step, outs)`` run after it."""
    good = step.fn

    def fn():
        outs, new = good()
        extra(step, outs)
        return outs, new

    return trace_audit.Step(step.label, fn, step.cache, step.inputs, step.states,
                            step.in_place_allow, step.forbidden, step.dtype_allow)


def _checks(fails):
    return sorted({f.split(" ", 1)[0] for f in fails})


def test_clean_steps_pass(f32_steps, bf16_steps):
    for params, steps in (f32_steps, bf16_steps):
        for step in steps.values():
            assert trace_audit.audit_step(step, params, capture=False) == [], step.label


def test_audit_catches_a_cache_sized_copy(f32_steps):
    params, steps = f32_steps
    step = _planted(steps["contiguous/decode_step"],
                    lambda s, outs: s.cache["layers"][0]["k"].clone())
    fails = trace_audit.audit_step(step, params, capture=False)
    assert fails and _checks(fails) == ["in"], fails
    assert "cache-sized copy" in fails[0]


def test_audit_catches_a_new_cache_leaf(f32_steps):
    params, steps = f32_steps
    good = steps["contiguous/verify_step"]

    def fn():
        outs, new = good.fn()
        new = dict(new, layers=[dict(new["layers"][0], v=new["layers"][0]["v"] + 0)]
                   + new["layers"][1:])
        return outs, new

    step = trace_audit.Step(good.label, fn, good.cache, good.inputs, good.states)
    fails = trace_audit.audit_step(step, params, capture=False)
    assert _checks(fails) == ["in"] and any("/layers/0/v" in f for f in fails), fails


def test_audit_catches_an_f64(f32_steps):
    params, steps = f32_steps
    step = _planted(steps["contiguous/verify_step"], lambda s, outs: outs[0].double())
    fails = trace_audit.audit_step(step, params, capture=False)
    assert fails and _checks(fails) == ["dtype"] and "f64" in fails[0], fails


def test_audit_catches_a_cache_sized_upcast(bf16_steps):
    params, steps = bf16_steps
    step = _planted(steps["paged/decode_step"],
                    lambda s, outs: s.cache["layers"][1]["v"].float())
    fails = trace_audit.audit_step(step, params, capture=False)
    assert fails and _checks(fails) == ["dtype"] and "widens" in fails[0], fails
    # a small upcast (the step's logits rows are f32 already; its tokens'
    # embeddings are not cache-sized) is no finding
    small = _planted(steps["paged/decode_step"],
                     lambda s, outs: s.cache["layers"][1]["v"][:, :1].float())
    assert trace_audit.audit_step(small, params, capture=False) == []


def test_audit_catches_a_data_dependent_shape(f32_steps):
    params, steps = f32_steps
    step = _planted(steps["contiguous/decode_step"],
                    lambda s, outs: (s.inputs["token"] % 2 == 0).nonzero())
    fails = trace_audit.audit_step(step, params, capture=False)
    assert fails and _checks(fails) == ["static"], fails


def test_paged_decode_bans_the_full_gather(bf16_steps):
    params, steps = bf16_steps
    step = _planted(steps["paged/decode_step"],
                    lambda s, outs: A.paged_gather(s.cache["layers"][0]["k"],
                                                   s.cache["block_tables"]))
    fails = trace_audit.audit_step(step, params, capture=False)
    assert any(f.startswith("growth") and "full gathered" in f for f in fails), fails


def test_the_old_verify_window_write_is_caught(f32_steps, monkeypatch):
    """The verify window's former write selected its live lanes with
    ``nonzero``: a shape that follows the widths, so no one program."""
    params, steps = f32_steps

    def addresses(lengths, t_new, c, s):
        live = torch.arange(c)[None] < t_new.long()[:, None]
        b_idx, lane = live.nonzero(as_tuple=True)
        return {"win_b": b_idx, "win_pos": lengths.long()[b_idx] + lane, "win_lane": lane}

    def write(buf, new, lengths, t_new, addr=None):
        addr = addr or addresses(lengths, t_new, new.shape[1], buf.shape[1])
        buf[addr["win_b"], addr["win_pos"]] = new[addr["win_b"], addr["win_lane"]]
        return buf

    monkeypatch.setattr(A, "window_addresses", addresses)
    monkeypatch.setattr(A, "write_window", write)
    fails = trace_audit.audit_step(steps["contiguous/verify_step"], params, capture=False)
    assert "static" in _checks(fails), fails


def test_the_audit_cli_is_clean_and_fails_on_a_planted_step(monkeypatch, capsys):
    assert cli.main(["--device", "cpu", "-q"]) == 0
    from repro_torch.core import engine

    real = engine.decode_step

    def bad(model, params, cache, token, impl="auto"):
        logits, new = real(model, params, cache, token, impl)
        return logits.double().float(), new

    monkeypatch.setattr(engine, "decode_step", bad)
    assert cli.main(["--device", "cpu", "--trace-only"]) == 1
    out = capsys.readouterr().out
    assert "dtype contiguous/decode_step" in out and "analysis: FAILED" in out


# --------------------------------------------------------------------------
# the static-shape verify-window write against the reference's drop
# --------------------------------------------------------------------------

def test_overhanging_window_keeps_committed_entries_and_other_slots():
    """``lengths + t_new == S`` with lanes past S: every lane below t_new
    lands at its position, nothing else changes (every committed entry and
    every other slot bit for bit), as the reference's ``mode="drop"``
    scatter writes it."""
    import jax.numpy as jnp

    from repro.models import attention as JA

    rng = np.random.default_rng(0)
    b, s, c, h, d = 4, 12, 5, 2, 3
    buf = rng.standard_normal((b, s, h, d)).astype(np.float32)
    new = rng.standard_normal((b, c, h, d)).astype(np.float32)
    lengths = np.array([s - 3, s - 5, 2, s - 1], np.int32)  # row 0: lengths + t_new == S
    t_new = np.array([3, 5, 0, 1], np.int32)  # row 2 idle, row 3 one lane at S - 1
    got = A.write_window(torch.from_numpy(buf.copy()), torch.from_numpy(new),
                         torch.from_numpy(lengths), torch.from_numpy(t_new)).numpy()
    want = np.asarray(JA.write_window(jnp.asarray(buf), jnp.asarray(new),
                                      jnp.asarray(lengths), jnp.asarray(t_new)))
    np.testing.assert_array_equal(got, want)
    for r in range(b):
        written = set(range(lengths[r], lengths[r] + t_new[r]))
        for p in range(s):
            if p in written:
                np.testing.assert_array_equal(got[r, p], new[r, p - lengths[r]])
            else:
                np.testing.assert_array_equal(got[r, p], buf[r, p])
    # a live lane past the cache is dropped as well (the reference's drop)
    over = A.write_window(torch.from_numpy(buf.copy()), torch.from_numpy(new),
                          torch.tensor([s - 2] * b, dtype=torch.int32),
                          torch.tensor([4] * b, dtype=torch.int32)).numpy()
    np.testing.assert_array_equal(over[:, : s - 2], buf[:, : s - 2])
    np.testing.assert_array_equal(over[:, s - 2:], new[:, :2])


def test_window_wider_than_the_cache_is_refused():
    with pytest.raises(ValueError, match="verify window"):
        A.window_addresses(torch.zeros(2, dtype=torch.int32),
                           torch.ones(2, dtype=torch.int32), 6, 5)
