"""Layer 2: record the real serving steps and audit what they run.

The AST lint (layer 1) reads source; this module runs the serving steps —
``engine.prefill``, ``engine.decode_step`` (contiguous and paged), the paged
``engine.mixed_step``, ``layerskip.draft_window`` and ``engine.verify_step``
(both pools) — at the reference's audit geometry (``ARCH`` ... ``N_DRAFT``,
the smoke serving config of ``benchmarks/bench_serve.py``), on the pool
states that two different serving traces leave, and checks each step's
recorded ops. A step is recorded under a ``TorchDispatchMode``
(:class:`Recorder`) as the list of every aten op it runs with its outputs'
shapes and dtypes. A kernel call is one op: the audit sees its inputs and
outputs, never its internals (on the card they live in registers and shared
memory; on the CPU the kernel's plain version stands in for it and is
recorded as the one op it replaces). So the plain paged decode's gather of
a slot's pages (``[B * MB, bs, ...]``, ``kernels/paged_decode_attention.py``)
is a kernel internal on the CPU, as the table walk is on the card, and the
paged decode's ban on the full gather holds the step's own ops. The checks,
each the counterpart of one of the reference's:

- **static program** (:func:`audit_static`, the reference's
  ``audit_recompiles``): both traces' states give the same op list. A
  data-dependent shape (``nonzero``) or a branch on a device value shows as
  a difference, and such a step cannot be one replayed graph;
- **in place** (:func:`audit_in_place`, the counterpart of donation): every
  cache leaf the step returns is the tensor it was given (``lengths``, which
  the forward returns anew, is copied back into the cache's own tensor by
  the step, as ``generate_scanned`` and the scheduler's steps do), and no op
  output that is not a view, an in-place result or a bare allocation is as
  large as a cache K/V leaf;
- **no growth** (:func:`audit_growth`, ``audit_no_growth``): no output above
  1.25 x the largest signature tensor (params, cache and inputs), counted in
  bytes; in the paged decode step, no full gathered per-slot K/V transient
  (:func:`paged_growth_shapes`, ``paged_growth_patterns``);
- **dtypes** (:func:`audit_dtypes`, ``audit_dtypes``): no f64 output, and no
  op that widens a bf16 / f16 input into an f32 output of 32 KB or more but
  the named allowances (:func:`token_upcasts`: RoPE's and the unembed's
  per-token f32 transients; the unembed's table is a persistent f32 copy,
  ``layers.add_f32_table``, so it widens nothing cache-sized);
- **capture** (:func:`audit_capture`, CUDA only): the step warmed up,
  captured as one CUDA graph and replayed on both traces' states, its
  outputs and its cache bit for bit an eager run's.

Every audit function returns failure strings prefixed by the check's name
(empty = clean). :func:`run_trace_audit` runs the whole matrix and is what
``python -m repro_torch.analysis`` calls.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core import kv_cache

# the reference's audit geometry (src/repro/analysis/trace_audit.py)
ARCH = "llama3.2-1b"
SLOTS = 4
PAD_TO = 16
MAX_NEW_CAP = 64
BLOCK_SIZE = 16
NUM_BLOCKS = 14
PREFILL_BUDGET = 4
# the speculative step (SpeculativeProfile defaults; the smoke arch has 2
# layers, so exit_layer=1 is its only early exit)
EXIT_LAYER = 1
N_DRAFT = 4
#: requests a trace serves, and each seed's scheduler steps before its state
#: is taken (two traces, two points mid-flight)
N_REQUESTS = 8
TRACE_STEPS = {0: 6, 1: 10}

SLACK = 1.25
WIDEN_MIN_BYTES = 1 << 15
_NARROW = (torch.bfloat16, torch.float16)
#: ops that allocate without moving a byte (a kernel's output, a workspace)
_ALLOCATIONS = ("aten::empty", "aten::empty_strided", "aten::new_empty", "aten::empty_like")
#: the kernel modules whose ``*_cuda`` wrappers and ``*_plain`` versions the
#: recorder sees as one op each
_KERNEL_MODULES = ("decode_attention", "flash_attention", "hstu_attention", "int8_matmul",
                   "paged_decode_attention", "rmsnorm", "ssd_scan")


# --------------------------------------------------------------------------
# recording
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Out:
    shape: Tuple[int, ...]
    dtype: torch.dtype
    nbytes: int
    fresh: bool  # shares no storage with any input


@dataclass
class OpRecord:
    name: str  # aten op, or "kernel:<wrapper>"
    outs: Tuple[Out, ...]
    narrow_in: int = 0  # elements of the largest bf16 / f16 input

    @property
    def signature(self):
        return (self.name, tuple((o.shape, str(o.dtype)) for o in self.outs))


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _storage(t: torch.Tensor) -> int:
    try:
        return t.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):
        return 0


def _record(name: str, ins, outs) -> OpRecord:
    in_t = _tensors(ins)
    stores = {_storage(t) for t in in_t if t.numel()}
    narrow = max((t.numel() for t in in_t if t.dtype in _NARROW), default=0)
    return OpRecord(name, tuple(
        Out(tuple(t.shape), t.dtype, t.numel() * t.element_size(),
            not t.numel() or _storage(t) not in stores)
        for t in _tensors(outs)), narrow)


class Recorder(TorchDispatchMode):
    """Records every aten op run under it (``ops``); while a kernel wrapper
    or plain version runs (``kernel`` set by :func:`kernels_as_ops`), its
    internals are run but not recorded, and the call is recorded once as
    ``kernel:<name>``."""

    def __init__(self):
        super().__init__()
        self.ops: List[OpRecord] = []
        self.kernel: Optional[str] = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.kernel is None:
            self.ops.append(_record(func._schema.name, (args, kwargs), out))
        return out


_ACTIVE: List[Recorder] = []


def _kernel_op(name: str, fn: Callable) -> Callable:
    def call(*args, **kwargs):
        rec = _ACTIVE[-1] if _ACTIVE else None
        if rec is None or rec.kernel is not None:
            return fn(*args, **kwargs)
        rec.kernel = name
        try:
            out = fn(*args, **kwargs)
        finally:
            rec.kernel = None
        rec.ops.append(_record(f"kernel:{name}", (args, kwargs), out))
        return out

    call.__wrapped__ = fn
    return call


class kernels_as_ops:
    """Context: every kernel wrapper (``*_cuda``) and plain version
    (``*_plain``) of ``repro_torch.kernels`` recorded as one op by the
    innermost active :class:`Recorder`. The module attributes are swapped
    for the span of the context and restored after it."""

    def __enter__(self):
        import importlib

        self._saved = []
        for mod_name in _KERNEL_MODULES:
            mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
            for attr, fn in list(vars(mod).items()):
                if callable(fn) and (attr.endswith("_cuda") or attr.endswith("_plain")):
                    self._saved.append((mod, attr, fn))
                    setattr(mod, attr, _kernel_op(attr, fn))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)
        return False


def record(fn: Callable[[], Any]) -> Tuple[Any, List[OpRecord]]:
    """Run ``fn`` once under a :class:`Recorder`, kernels as one op each;
    returns (its result, the recorded ops)."""
    rec = Recorder()
    _ACTIVE.append(rec)
    try:
        with kernels_as_ops(), rec:
            out = fn()
    finally:
        _ACTIVE.pop()
    return out, rec.ops


# --------------------------------------------------------------------------
# audits over recorded steps
# --------------------------------------------------------------------------

def _leaf_items(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_items(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_items(v, f"{prefix}/{i}")
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree


def kv_rows(cache) -> Dict[Tuple[int, ...], int]:
    """Per-token dims of ``cache``'s K/V leaves (the dims past the slot and
    sequence axes: (Hkv, D), or MLA's latent width) -> the bytes of the
    smallest leaf of that row layout."""
    rows: Dict[Tuple[int, ...], int] = {}
    for _, t in _leaf_items(cache):
        if t.dim() >= 3:
            key = tuple(t.shape[2:])
            rows[key] = min(rows.get(key, 1 << 62), t.numel() * t.element_size())
    return rows


def _is_widening(op: OpRecord, o: Out) -> bool:
    return (o.dtype == torch.float32 and o.fresh and op.narrow_in > 0
            and o.nbytes >= WIDEN_MIN_BYTES and o.nbytes // 4 >= op.narrow_in)


def audit_static(records: Sequence[List[OpRecord]], label: str = "") -> List[str]:
    """The op lists of one step on different states must be one program:
    the same ops with the same output shapes and dtypes."""
    base = [r.signature for r in records[0]]
    fails = []
    for i, recs in enumerate(records[1:], start=1):
        other = [r.signature for r in recs]
        if other == base:
            continue
        at = next((j for j, (a, b) in enumerate(zip(base, other)) if a != b),
                  min(len(base), len(other)))
        fails.append(
            f"static {label}: state {i} runs another program than state 0 ({len(other)} vs "
            f"{len(base)} ops, first difference at op {at}: "
            f"{other[at] if at < len(other) else None} vs {base[at] if at < len(base) else None})"
            f" — a data-dependent shape or a branch on a device value")
    return fails


def audit_in_place(cache, new_cache, ops: Sequence[OpRecord], *,
                   allow: Sequence[Tuple[int, ...]] = (), label: str = "") -> List[str]:
    """Every leaf of ``new_cache`` but ``lengths`` is ``cache``'s own tensor
    (same storage), and no fresh op output (not a view, an in-place result
    or a bare allocation) in a K/V leaf's row layout is as large as that
    leaf (a cache-sized copy), but those whose shape starts with one of
    ``allow``. Widenings are the dtype check's."""
    fails = []
    given = dict(_leaf_items(cache))
    for path, t in _leaf_items(new_cache):
        if path == "/lengths":
            continue
        if path not in given or t.data_ptr() != given[path].data_ptr():
            fails.append(f"in place {label}: cache leaf {path} {tuple(t.shape)} is a new "
                         f"tensor, not the pool's")
    rows = kv_rows(cache)
    for op in ops:
        if op.name in _ALLOCATIONS:
            continue
        for o in op.outs:
            limit = next((n for r, n in rows.items()
                          if len(o.shape) > len(r) and o.shape[-len(r):] == r), None)
            if (limit is None or not o.fresh or o.nbytes < limit or _is_widening(op, o)
                    or any(o.shape[:len(a)] == a for a in allow)):
                continue
            fails.append(f"in place {label}: {op.name} makes a fresh {o.shape} {o.dtype} "
                         f"({o.nbytes} B >= the {limit} B of a cache leaf) — a cache-sized "
                         f"copy")
    return fails


def signature_bytes(*trees) -> int:
    return max((t.numel() * t.element_size() for tree in trees for _, t in _leaf_items(tree)),
               default=0)


def paged_growth_shapes(slots: int, max_blocks: int, block_size: int):
    """Leading dims of the full gathered per-slot K/V transient a paged
    DECODE step must never make: the flat [B, MB * bs, ...] form and its
    pre-reshape [B, MB, bs, ...] form (the mixed and verify steps gather
    for their chunk lanes, so the ban is the decode step's alone)."""
    return [(slots, max_blocks * block_size), (slots, max_blocks, block_size)]


def audit_growth(ops: Sequence[OpRecord], sig_bytes: int, *,
                 forbidden: Sequence[Tuple[int, ...]] = (), label: str = "") -> List[str]:
    """No output above ``SLACK`` x ``sig_bytes`` (the largest signature
    tensor), and no output whose shape starts with a ``forbidden`` prefix
    (the paged decode's full gather), at a K/V rank (four dims or more)."""
    fails = []
    worst = max(((o.nbytes, op.name, o.shape) for op in ops for o in op.outs),
                default=(0, "", ()))
    if sig_bytes and worst[0] > SLACK * sig_bytes:
        fails.append(f"growth {label}: {worst[1]} makes {worst[2]} ({worst[0]} B), above "
                     f"{SLACK} x the largest signature tensor ({sig_bytes} B)")
    for op in ops:
        for o in op.outs:
            if len(o.shape) >= 4 and any(o.shape[:len(f)] == f for f in forbidden):
                fails.append(f"growth {label}: {op.name} makes {o.shape}: the full gathered "
                             f"per-slot K/V transient")
    return fails


def audit_dtypes(ops: Sequence[OpRecord], *, allow: Sequence[Tuple[int, ...]] = (),
                 label: str = "") -> List[str]:
    """No f64 output; no bf16 / f16 input widened into an f32 output of
    ``WIDEN_MIN_BYTES`` or more, but outputs whose shape starts with one of
    ``allow`` (each allowance named, with its reason, by its caller)."""
    fails = []
    for op in ops:
        for o in op.outs:
            if o.dtype == torch.float64:
                fails.append(f"dtype {label}: {op.name} makes an f64 {o.shape}")
            elif _is_widening(op, o) and not any(o.shape[:len(a)] == a for a in allow):
                fails.append(f"dtype {label}: {op.name} widens a narrow input into an f32 "
                             f"{o.shape} ({o.nbytes} B >= {WIDEN_MIN_BYTES} B)")
    return fails


# --------------------------------------------------------------------------
# a step over states, eager and captured
# --------------------------------------------------------------------------

@dataclass
class Step:
    """One serving step over static tensors: ``fn()`` runs it on ``cache``
    (None for prefill) and ``inputs`` and returns (outputs, new cache);
    ``states`` are the (cache leaves, inputs) each trace left, loaded into
    the static tensors in place before a run."""

    label: str
    fn: Callable[[], Tuple[Tuple[torch.Tensor, ...], Any]]
    cache: Any
    inputs: Dict[str, torch.Tensor]
    states: List[Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]]
    in_place_allow: Sequence[Tuple[int, ...]] = ()
    forbidden: Sequence[Tuple[int, ...]] = ()
    dtype_allow: Sequence[Tuple[int, ...]] = ()
    report: Dict[str, Any] = field(default_factory=dict)

    def load(self, i: int) -> None:
        leaves, inputs = self.states[i]
        if self.cache is not None:
            for path, t in _leaf_items(self.cache):
                t.copy_(leaves[path])
        for k, t in self.inputs.items():
            t.copy_(inputs[k])

    def body(self):
        """The step as a capturable unit: the step, then its fresh
        ``lengths`` copied into the cache's own tensor
        (``kv_cache.write_back``)."""
        with torch.inference_mode():
            outs, new = self.fn()
            if self.cache is not None:
                kv_cache.write_back(self.cache, new)
        return outs, new


def _snapshot(outs, cache) -> List[torch.Tensor]:
    """Copies of a step's outputs and cache leaves, for the bit-for-bit
    comparison. A block pool's sink block 0 is left out: freed slots' and
    padding lanes' writes land there in any order (``attention.
    paged_write_rows``), and nothing reads it."""
    if cache is None:
        leaves = []
    else:
        sink = "block_tables" in cache
        leaves = [t[1:] if sink and t.dim() >= 3 else t for _, t in _leaf_items(cache)]
    return [t.clone() for t in list(outs) + leaves]


def audit_step(step: Step, params, *, capture: bool) -> List[str]:
    """Every check on one step: record it on each state (eager), then, with
    ``capture``, capture it once and replay it on each state."""
    fails: List[str] = []
    records, eager = [], []
    for i in range(len(step.states)):
        step.load(i)
        (outs, new), ops = record(step.body)
        records.append(ops)
        eager.append(_snapshot(outs, new if step.cache is None else step.cache))
        lbl = f"{step.label} (state {i})"
        if step.cache is not None:
            fails += audit_in_place(step.cache, new, ops, allow=step.in_place_allow, label=lbl)
        fails += audit_growth(ops, signature_bytes(params, step.cache, step.inputs),
                              forbidden=step.forbidden, label=lbl)
        fails += audit_dtypes(ops, allow=step.dtype_allow, label=lbl)
    fails += audit_static(records, label=step.label)
    step.report["ops"] = len(records[0])
    if capture:
        fails += audit_capture(step, eager)
    return fails


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _wall_ms(fn, dev, n: int = 5) -> float:
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) / n * 1e3


def audit_capture(step: Step, eager: List[List[torch.Tensor]]) -> List[str]:
    """Capture ``step`` as one CUDA graph (warmed up on state 0) and replay
    it on every state: outputs and cache bit for bit the eager run's. Keeps
    the graph, its per-call launches and the eager and replay wall ms in
    ``step.report`` (``replay`` replays it)."""
    from repro_torch.core import graphs

    dev = next(iter(step.inputs.values())).device
    fails: List[str] = []
    step.load(0)
    try:
        graph, (outs, new), per_call = graphs.capture(step.body, restore=lambda: step.load(0))
    except Exception as e:  # the failure is the finding: nothing runs eagerly instead
        return [f"capture {step.label}: the step does not capture: {type(e).__name__}: {e}"]
    for i, want in enumerate(eager):
        step.load(i)
        graph.replay()
        _sync(dev)
        got = _snapshot(outs, new if step.cache is None else step.cache)
        bad = [j for j, (g, w) in enumerate(zip(got, want)) if not torch.equal(g, w)]
        if bad:
            fails.append(f"capture {step.label}: replay on state {i} differs from the eager "
                         f"run in {len(bad)} of {len(want)} tensors (first: #{bad[0]}, "
                         f"{tuple(want[bad[0]].shape)})")
    step.load(0)
    step.report.update(
        graph=graph, replay=graph.replay, launches=per_call,
        eager_ms=_wall_ms(lambda: (step.load(0), step.body()), dev),
        replay_ms=_wall_ms(lambda: (step.load(0), graph.replay()), dev),
        load_ms=_wall_ms(lambda: step.load(0), dev))
    return fails


# --------------------------------------------------------------------------
# the serving steps on two traces' states
# --------------------------------------------------------------------------

def _trace_scheduler(model, params, *, paged: bool, seed: int, device):
    """A scheduler of the audit geometry that served ``TRACE_STEPS[seed]``
    steps of trace ``seed`` (``seamless_s2t`` lengths, greedy and
    speculative requests alternating, all arrived at 0): its pool and host
    state mid-flight."""
    from repro_torch.core import prng
    from repro_torch.core.scheduler import Scheduler
    from repro_torch.launch import serve
    from repro_torch.training import data as data_mod

    reqs = serve.poisson_trace(data_mod.PAPER_PROFILES["seamless_s2t"], N_REQUESTS,
                               pad_to=PAD_TO, max_new_cap=MAX_NEW_CAP,
                               vocab_size=model.config.vocab_size, arrival_rate=0.0, seed=seed)
    serve.apply_profile_mix(reqs, "greedy,speculative", exit_layer=EXIT_LAYER, n_draft=N_DRAFT)
    geometry = dict(paged=True, block_size=BLOCK_SIZE, num_blocks=NUM_BLOCKS, chunked=True,
                    prefill_budget=PREFILL_BUDGET) if paged else {}
    sched = Scheduler(model, params, slots=SLOTS, pad_to=PAD_TO, max_new_cap=MAX_NEW_CAP,
                      device=device, base_key=prng.PRNGKey(seed), **geometry)
    sched.submit(reqs)
    sched.rebase(sched.clock())
    for _ in range(TRACE_STEPS[seed]):
        with torch.inference_mode():
            sched._admit(sched._now())
        sched.step()
    return sched, reqs


def _host_inputs(sched, reqs, vocab: int) -> Dict[str, np.ndarray]:
    """Every step's host inputs from a scheduler's state: each slot's write
    position (a decoding slot's kv_len, a cursor's position, 0 free), its
    pending token, its speculative window width (``_window_widths``), a
    chunk plan (a decoding slot 1 lane, a cursor the rest of its prompt up
    to the budget) and a window of tokens (lane 0 the pending token). A
    paged state's slots are then grown to back every position these reach
    (:func:`serving_steps`): a read of the sink block 0, which padding lanes
    write in any order, would make a step's outputs depend on that order."""
    lengths = np.zeros((SLOTS,), np.int32)
    t_new = np.zeros((SLOTS,), np.int32)
    chunk = np.zeros((SLOTS, PREFILL_BUDGET), np.int32)
    chunk[:, 0] = sched._token
    for slot, st in sched.active.items():
        lengths[slot], t_new[slot] = st.kv_len, 1
    if sched.chunk_mgr is not None:
        for slot, cur in sched.chunk_mgr.cursors.items():
            n = min(PREFILL_BUDGET, cur.n_prompt - cur.pos)
            lengths[slot], t_new[slot] = cur.pos, n
            chunk[slot, :n] = cur.prompt[cur.pos:cur.pos + n]
    w = sched._window_widths()
    window = (sched._token[:, None] + np.arange(N_DRAFT + 1)[None] * 7) % vocab
    prompt = np.zeros((1, PAD_TO), np.int32)
    first = np.asarray(reqs[0].prompt, np.int32)[:PAD_TO]
    prompt[0, :len(first)] = first
    return {"token": sched._token.astype(np.int32), "lengths": lengths,
            "chunk": chunk, "t_new": t_new, "w": w.astype(np.int32),
            "n_live": np.maximum(w - 1, 0).astype(np.int32),
            "window": window.astype(np.int32), "prompt": prompt,
            "prompt_len": np.array([len(first)], np.int32)}


def serving_steps(model, params, *, paged: bool, device) -> List[Step]:
    """The pool's serving steps over static tensors (a fresh pool of the
    audit geometry and one input tensor each), with the states the two
    traces left: contiguous prefill, decode, draft and verify; paged decode,
    mixed, draft and verify."""
    from repro_torch.core import engine, layerskip
    from repro_torch.core.slot_pool import BlockPool, SlotPool

    cfg = model.config
    max_len = PAD_TO + MAX_NEW_CAP + 1
    pool = (BlockPool(model, SLOTS, max_len, device, block_size=BLOCK_SIZE,
                      num_blocks=NUM_BLOCKS) if paged else SlotPool(model, SLOTS, max_len, device))
    cache = pool.cache
    states = []
    for seed in sorted(TRACE_STEPS):
        sched, reqs = _trace_scheduler(model, params, paged=paged, seed=seed, device=device)
        host = _host_inputs(sched, reqs, model.config.vocab_size)
        if paged:  # every position a step may read or write backed by the slot's own blocks
            need = np.maximum(np.maximum(host["t_new"], host["w"]), 1)
            for slot in range(SLOTS):
                if not sched.pool.ensure(slot, int(host["lengths"][slot] + need[slot] - 1)):
                    raise RuntimeError(f"the audit geometry's {NUM_BLOCKS} blocks cannot back "
                                       f"trace {seed}'s state")
            sched.pool.sync()
        leaves = {path: t.clone() for path, t in _leaf_items(sched.pool.cache)}
        # the host's write positions pinned, as the mixed and verify steps pin them
        leaves["/lengths"] = torch.from_numpy(host["lengths"]).to(device)
        states.append((leaves, {k: torch.from_numpy(v).to(device) for k, v in host.items()}))
        del sched
    x = {k: v.clone() for k, v in states[0][1].items()}  # the static inputs
    kind = "paged" if paged else "contiguous"
    pick = lambda *names: {n: x[n] for n in names}  # noqa: E731
    only = lambda names: [(lv, {n: inp[n] for n in names}) for lv, inp in states]  # noqa: E731
    steps = []
    if not paged:
        steps.append(Step(
            "prefill", lambda: _pair(engine.prefill(model, params, x["prompt"],
                                                    x["prompt_len"], max_len)),
            None, pick("prompt", "prompt_len"), only(("prompt", "prompt_len")),
            dtype_allow=token_upcasts(cfg, 1, PAD_TO, PAD_TO)))
    names = ("token",)
    steps.append(Step(
        f"{kind}/decode_step", lambda: _pair(engine.decode_step(model, params, cache,
                                                                x["token"])),
        cache, pick(*names), only(names), dtype_allow=token_upcasts(cfg, SLOTS, 1, 1),
        forbidden=paged_growth_shapes(SLOTS, pool.max_blocks, BLOCK_SIZE) if paged else ()))
    # the mixed and verify steps' flash attention reads each slot's pages
    # gathered into [slots, max_blocks, block_size, ...] (attention.
    # paged_gather): the one transient as large as a pool leaf they may make
    gather = [(SLOTS, pool.max_blocks, BLOCK_SIZE)] if paged else []
    if paged:
        names = ("chunk", "t_new", "lengths")
        steps.append(Step(
            "paged/mixed_step", lambda: _pair(engine.mixed_step(
                model, params, cache, x["chunk"], x["t_new"], x["lengths"])),
            cache, pick(*names), only(names), in_place_allow=gather,
            dtype_allow=token_upcasts(cfg, SLOTS, PREFILL_BUDGET, 1)))
    names = ("token", "n_live", "lengths")
    steps.append(Step(
        f"{kind}/draft_window", lambda: _pair(layerskip.draft_window(
            model, EXIT_LAYER, N_DRAFT, params, cache, x["token"], x["n_live"],
            x["lengths"])),
        cache, pick(*names), only(names), dtype_allow=token_upcasts(cfg, SLOTS, 1, 1)))
    names = ("window", "w", "lengths")
    steps.append(Step(
        f"{kind}/verify_step", lambda: _pair(engine.verify_step(
            model, params, cache, x["window"], x["w"], x["lengths"])),
        cache, pick(*names), only(names), in_place_allow=gather,
        dtype_allow=token_upcasts(cfg, SLOTS, N_DRAFT + 1, N_DRAFT + 1)))
    return steps


def token_upcasts(cfg, b: int, t: int, t_out: int) -> List[Tuple[int, ...]]:
    """The named dtype allowances of a step over ``b`` x ``t`` tokens whose
    unembed reads ``t_out`` lanes a row, each a per-token transient, never
    a cache-sized one: RoPE rotates q and k in f32 (``layers.apply_rope``:
    the angles and the rotation in f32, cast back), [b, t, H, D] for the q
    and the KV heads; the unembed takes the final hidden state to f32
    before the f32 table (``layers.unembed``: logits in f32 for the
    sampler), [b, t_out, d_model]."""
    dh = cfg.head_dim
    return [(b, t, cfg.n_heads, dh), (b, t, cfg.n_kv_heads, dh), (b, t_out, cfg.d_model)]


def _pair(result):
    """(outputs, new cache) from a step's (output, cache) return."""
    out, new = result
    return (out,), new


def run_trace_audit(device: str = "cuda", *, verbose: bool = False, model=None,
                    params=None, steps_out: Optional[List[Step]] = None) -> List[str]:
    """The whole audit on ``device``: on the CPU the smoke config in f32
    (every check but capture) and its bf16 paged steps (dtypes); on CUDA
    full-width ``llama3.2-1b`` in bf16 (random weights, seed 0; or the
    given ``model`` and ``params``) on both pools, every check and capture.
    Returns failure strings (empty = clean); ``steps_out`` receives the
    audited steps with their reports (the CUDA graphs among them)."""
    from repro_torch.launch import serve

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the step audit on cuda needs a CUDA device (--device cpu runs it "
                           "on the CPU)")

    def say(msg: str) -> None:
        if verbose:
            print(f"[trace-audit] {msg}", flush=True)

    fails: List[str] = []
    legs = []
    if dev.type == "cuda":
        if model is None:
            _, model, params = serve.build_model(ARCH, smoke=False, seed=0, device=dev)
        legs.append(("", model, params, (False, True), True, True))
    else:
        from repro_torch.configs import get_smoke_config
        from repro_torch.models import get_model

        for dt, pools, full in (("float32", (False, True), True), ("bfloat16", (True,), False)):
            m = get_model(get_smoke_config(ARCH).replace(dtype=dt))
            gen = torch.Generator(device=dev).manual_seed(0)
            with torch.inference_mode():
                p = m.init(gen, dev)
            legs.append(("bf16 " if dt == "bfloat16" else "", m, p, pools, full, False))
    for tag, m, p, pools, full, capture in legs:
        for paged in pools:
            for step in serving_steps(m, p, paged=paged, device=dev):
                step.label = tag + step.label
                got = audit_step(step, p, capture=capture)
                if not full:  # the bf16 leg on the CPU: the dtype check alone
                    got = [f for f in got if f.startswith("dtype")]
                say(f"{step.label}: {step.report.get('ops')} ops, {len(got)} failure(s)")
                fails += got
                if steps_out is not None:
                    steps_out.append(step)
    say(f"{len(fails)} failure(s)")
    return fails
