"""Measured operator-class breakdown on the card (paper Fig 4 / Fig 10): the
share of one window's time spent in each class of device kernel, and idle,
beside the analytic roofline shares of ``core/characterization.py`` at the
same config, depth, batch and lengths.

Classes follow the reference's definitions (``core/characterization.py``):
``linear`` is every GEMM outside the score and context products (QKV/O,
the FFN, the experts' bmm, the int8 GEMMs, the LM head); ``attention`` the
ported flash, flash-decode, paged-decode, latent and HSTU kernels, the SSD
scan, the LSE combine, and the KV-cache writes, gathers and reorders;
``norm`` RMSNorm with any prologue; ``embed`` the token gather; ``other``
the rest (RoPE, activations and gates, casts, sampling, host copies).
Each device kernel of the window falls into exactly one class by
``CLASS_RULES``: by its name where the name decides (the port's kernel
symbols, cuBLAS's), else by the aten op that launched it and that op's
recorded input shapes (``record_shapes=True``): a write into, or a gather
from, a tensor whose rows are a KV-cache row is ``attention``, a gather
from the embedding table is ``embed``. The model's code carries no spans.
A kernel whose name decides nothing must be linked to its aten op
(``problems``): a lost link would move the KV writes and the token gather
into ``other`` unseen.

``idle`` is the window's host wall (from before the call to after
``torch.cuda.synchronize()``) less the union of its device kernels'
intervals; the profiler's padding kernels (``PAD_NAME``) are left out.
``measure`` profiles one window in a ``padded_session`` and takes it again
when the session saw fewer of the ported kernels (``PORTED``) than their
wrappers launched.

The paper's four workload analogues (``WORKLOADS``, the shapes of
``benchmarks/bench_op_breakdown.py``), prefill (P) and decode (D), one JSON
line a window:

  PYTHONPATH=src python src/repro_torch/launch/op_breakdown.py [--workload T-T]

Needs a CUDA card; random weights and inputs from ``--seed``. Exits non-zero
when a window's ``problems`` are not empty. Chameleon-34B
runs 24 of its 48 layers (``WORKLOADS``): its prefill unembeds every prompt
position, a 4.4 GB f32 logits transient at batch 16 x 1040.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.characterization import op_breakdown, roofline_times

CLASSES = ("linear", "attention", "norm", "embed", "other")
#: the profiler padding's spin kernel (``torch.cuda._sleep``), never counted
PAD_NAME = "spin_kernel"
#: spin kernels that open (after the profiler starts) and close (before it
#: stops) every ``padded_session``, each run synchronised apart from the
#: profiled work: under the H100's NVIDIA stack 580.159.03 a long process's
#: profiler sessions lost their first device records, and the spin kernels
#: take that loss in their place
HEAD_KERNELS, TAIL_KERNELS = 512, 64
#: a window's classes plus idle against its wall: the most that concurrent
#: kernels may count twice
RESIDUAL_BOUND = 0.01
#: the harness's range around one window (outside the model's code)
WINDOW = "op_breakdown.window"

GEMM_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm", "aten::matmul",
            "aten::linear", "aten::_int_mm", "aten::mv", "aten::addmv")
WRITE_OPS = ("aten::copy_", "aten::fill_", "aten::zero_", "aten::index_put_",
             "aten::_index_put_impl_", "aten::index_copy_")
GATHER_OPS = ("aten::index", "aten::index_select", "aten::embedding", "aten::gather")

#: (class, kernel-name substrings, launching aten ops, what the op's first
#: input must be: "table" the embedding table's shape, "kv" rows of a KV
#: cache). The rules that name kernels come first and decide by the name
#: alone; of the rest, a rule matches when every field it sets matches. The
#: first rule that matches decides, and a kernel no rule matches is ``other``.
CLASS_RULES = (
    ("attention", ("flash_attention", "flash_latent", "decode_attention", "decode_latent",
                   "hstu_attention", "ssd_"), (), None),
    ("norm", ("rmsnorm_",), (), None),
    ("linear", ("int8_", "gemm", "gemv", "nvjet", "xmma", "cutlass", "splitkreduce"), (), None),
    ("linear", (), GEMM_OPS, None),
    ("embed", (), GATHER_OPS, "table"),
    ("attention", (), WRITE_OPS + GATHER_OPS, "kv"),
)


class Kernel(NamedTuple):
    """One device kernel (or memcpy / memset) of a profile: name, start and
    end in microseconds on the profiler's clock, the aten op that launched
    it (None if none) and that op's input shapes."""
    name: str
    start_us: float
    end_us: float
    op: Optional[str] = None
    shapes: Sequence = ()


def _is_kv(shape: tuple, kv_rows) -> bool:
    return any(len(shape) > len(r) and shape[-len(r):] == tuple(r) for r in kv_rows)


def name_class(name: str) -> Optional[str]:
    """The class that a kernel's name alone decides under ``CLASS_RULES``,
    else None."""
    low = name.lower()
    return next((cls for cls, names, _, _ in CLASS_RULES
                 if names and any(n in low for n in names)), None)


def classify(k: Kernel, *, kv_rows=(), tables=()) -> str:
    """The class of one kernel under ``CLASS_RULES``. ``kv_rows``: the
    trailing shape of a KV-cache row, e.g. (Hkv, D), or MLA's (r + rope,);
    ``tables``: the embedding tables' shapes."""
    by_name = name_class(k.name)
    if by_name is not None:
        return by_name
    first = tuple(k.shapes[0]) if k.shapes and k.shapes[0] is not None else ()
    for cls, names, ops, need in CLASS_RULES:
        if names:
            continue
        if ops and k.op not in ops:
            continue
        if need == "table" and first not in {tuple(t) for t in tables}:
            continue
        if need == "kv" and not _is_kv(first, kv_rows):
            continue
        return cls
    return "other"


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def breakdown(kernels: Sequence[Kernel], window: Tuple[float, float], *, kv_rows=(),
              tables=(), top: int = 5) -> Dict:
    """Per class: device ms (each kernel's time inside the window), share of
    the window, kernel count and the ``top`` longest kernels by name; the
    window's ms, its busy ms (the union of the kernels' intervals), idle ms
    and share, and ``residual``: (classes + idle - window) / window, the
    overlap of concurrent kernels; ``linked``: the kernels whose launching
    aten op is known; ``unlinked``: the names and counts of the kernels
    that neither their name nor a launching op places."""
    t0, t1 = window
    span = t1 - t0
    classes = {c: {"ms": 0.0, "n": 0, "by_name": {}} for c in CLASSES}
    spans, linked, unlinked = [], 0, {}
    for k in kernels:
        if PAD_NAME in k.name or k.end_us <= t0 or k.start_us >= t1:
            continue
        s, e = max(k.start_us, t0), min(k.end_us, t1)
        spans.append((s, e))
        linked += k.op is not None
        if k.op is None and name_class(k.name) is None:
            unlinked[k.name] = unlinked.get(k.name, 0) + 1
        c = classes[classify(k, kv_rows=kv_rows, tables=tables)]
        c["ms"] += (e - s) / 1e3
        c["n"] += 1
        ms, n = c["by_name"].get(k.name, (0.0, 0))
        c["by_name"][k.name] = (ms + (e - s) / 1e3, n + 1)
    busy = union_us(spans) / 1e3
    window_ms = span / 1e3
    idle = window_ms - busy
    out = {"window_ms": window_ms, "busy_ms": busy, "idle_ms": idle,
           "idle_share": idle / window_ms if window_ms > 0 else 0.0,
           "n_kernels": len(spans), "linked": linked, "unlinked": unlinked, "classes": {}}
    for name, c in classes.items():
        longest = sorted(c["by_name"].items(), key=lambda kv: -kv[1][0])[:top]
        out["classes"][name] = {
            "ms": c["ms"], "n": c["n"],
            "share": c["ms"] / window_ms if window_ms > 0 else 0.0,
            "top": [[n, ms, cnt] for n, (ms, cnt) in longest]}
    summed = sum(c["ms"] for c in out["classes"].values()) + idle
    out["residual"] = (summed - window_ms) / window_ms if window_ms > 0 else 0.0
    return out


def analytic(cfg, phase: str, batch: int, seq: int) -> Dict[str, Dict[str, float]]:
    """The reference's roofline model at the H100's constants: per class
    its ms and its share of the summed time."""
    times = roofline_times(op_breakdown(cfg, mode="prefill" if phase == "P" else "decode",
                                        batch=batch, seq=seq))
    total = sum(times.values()) or 1.0
    return {c: {"ms": t * 1e3, "share": t / total} for c, t in times.items()}


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

def kernel_records(events) -> Tuple[List[Kernel], Optional[Tuple[float, float]]]:
    """The device kernels of a torch.profiler session's events, each with
    the aten op that launched it (and that op's input shapes), and the
    ``WINDOW`` range on the host, if one was recorded. A kernel (or
    memcpy, memset) shares its correlation id with the host runtime call
    that launched it (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...), and
    that call's parent is the innermost aten op around it."""
    from torch.autograd import DeviceType

    launches, window, kern = {}, None, []
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        if e.name == WINDOW:
            window = (e.time_range.start, e.time_range.end)
        elif e.name.startswith("cu"):  # the CUDA runtime and driver calls
            launches[e.id] = e
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name == WINDOW:
            continue
        call = launches.get(e.id)
        op = None if call is None else call.cpu_parent
        if op is not None and not op.name.startswith("aten::"):
            op = None  # launched from no aten op: a kernel of the port's own
        shapes = () if op is None else tuple(
            tuple(s) if isinstance(s, list) else s for s in (op.input_shapes or ()))
        kern.append(Kernel(e.name, e.time_range.start, e.time_range.end,
                           None if op is None else op.name, shapes))
    return kern, window


def padded_session(cpu: bool = True, shapes: bool = True):
    """A torch.profiler session over the card (and the host, with ``cpu``;
    the host ops' input shapes too, with ``shapes``) that runs HEAD_KERNELS
    spin kernels after it starts and TAIL_KERNELS before it stops,
    synchronised apart from the profiled work."""
    from torch.profiler import ProfilerActivity, profile

    def spin(n):
        torch.cuda.synchronize()
        for _ in range(n):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()

    class Padded(profile):
        def __enter__(self):
            out = super().__enter__()
            spin(HEAD_KERNELS)
            return out

        def __exit__(self, *exc):
            spin(TAIL_KERNELS)
            return super().__exit__(*exc)

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    return Padded(activities=acts, acc_events=True, record_shapes=shapes)


def profile_window(fn: Callable[[], object], session: Callable = padded_session):
    """(kernels, window) of one call of ``fn`` and its synchronisation,
    profiled in ``session()`` (host and card, input shapes recorded)."""
    torch.cuda.synchronize()
    with session() as prof:
        with torch.profiler.record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    kern, window = kernel_records(prof.events())
    if window is None:
        raise RuntimeError("the profiler recorded no window range")
    return kern, window


def wall_ms(fn: Callable[[], object], runs: int = 3) -> float:
    """Median host wall of ``fn`` and its synchronisation, unprofiled."""
    walls = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


#: workload -> (arch, layers run (None: all), batch, prompt, context at
#: decode, phases): ``benchmarks/bench_op_breakdown.py``'s shapes. S-T's
#: batch is the decode step's 128 streams (32 utterances x 4 beams); HSTU
#: is non-autoregressive (no decode).
WORKLOADS = {
    "T-T": ("yi-34b", None, 4, 154, 846, ("P", "D")),
    "I-T": ("chameleon-34b", 24, 16, 1040, 1050, ("P", "D")),
    "S-T": ("whisper-base", None, 128, 493, 529, ("P", "D")),
    "H-A": ("hstu", None, 32, 4814, None, ("P",)),
}
#: S-T: utterances a batch, beams a stream group, and the decode step's
#: self-attention rows (``seamless_s2t``'s mean output length)
ST_UTTERANCES, ST_BEAMS, ST_SELF_LEN = 32, 4, 36


def build(workload: str, device, seed: int = 0):
    """(config, model, params) of the workload's arch at its depth, bf16,
    random weights from ``seed``."""
    from repro_torch.launch import serve

    arch, layers = WORKLOADS[workload][:2]
    with torch.inference_mode():
        return serve.build_model(arch, smoke=False, seed=seed, device=device, n_layers=layers)


def _random_cache(cache, lengths: torch.Tensor, gen) -> None:
    """Fill every float leaf of a fresh cache with N(0, 1) and set its
    self-attention lengths, as if ``lengths`` tokens had been decoded."""
    from repro_torch.core.kv_cache import leaves

    for x in leaves(cache):
        if x.is_floating_point():
            x.copy_(torch.randn(x.shape, generator=gen, device=x.device).to(x.dtype))
    cache["lengths"].copy_(lengths)


def st_frame_lengths(n: int, n_frames: int) -> np.ndarray:
    """``seamless_s2t``'s input lengths at seed 2, clipped to the encoder's
    frames (``examples/speech_translation.py``'s)."""
    from repro_torch.training import data as data_mod

    ins, _ = data_mod.sample_lengths(data_mod.PAPER_PROFILES["seamless_s2t"], n, seed=2)
    return np.minimum(ins, n_frames).astype(np.int32)


def window_call(workload: str, phase: str, cfg, model, params, device, seed: int = 0):
    """(fn, kv_rows, tables, shape text): one window of the workload's phase
    as the port runs it, on inputs from ``seed``.

    T-T and I-T: P one ``engine.prefill`` of batch x prompt random tokens;
    D one ``engine.decode_step`` of the batch over a cache of ``context``
    random rows. S-T: P the encoder over 32 utterances' 1500 frames
    (``seamless_s2t`` frame lengths) and the decoder's BOS prefill; D one
    4-beam step of 128 streams (decode, ``BeamProfile.step`` and the
    cache reorder) over the frames and ``ST_SELF_LEN`` self rows. H-A one
    forward over 32 histories of 4814 items."""
    from repro_torch.core import engine, kv_cache, profiles

    _, _, batch, prompt, ctx, _ = WORKLOADS[workload]
    gen = torch.Generator(device=device).manual_seed(seed)
    tables = [tuple(params["embed"]["table"].shape)]
    kv_rows = [] if cfg.family == "hstu" else [(cfg.n_kv_heads, cfg.head_dim)]

    def randint(*shape):
        return torch.randint(0, cfg.vocab_size, shape, generator=gen, device=device,
                             dtype=torch.int32)

    if cfg.family == "hstu":
        toks = randint(batch, prompt)
        lens = torch.full((batch,), prompt, dtype=torch.int32, device=device)

        def fn():
            return model.forward(params, {"tokens": toks, "lengths": lens}, mode="prefill")
        return fn, kv_rows, tables, f"tokens [{batch}, {prompt}]"
    if cfg.family == "encdec":
        f = cfg.encdec.n_frames
        fl = torch.from_numpy(st_frame_lengths(ST_UTTERANCES, f)).to(device)
        if phase == "P":
            frames = torch.randn((ST_UTTERANCES, f, cfg.d_model), generator=gen,
                                 device=device).to(params["embed"]["table"].dtype)
            bos = torch.ones((ST_UTTERANCES, 1), dtype=torch.int32, device=device)
            ones = torch.ones((ST_UTTERANCES,), dtype=torch.int32, device=device)

            def fn():
                return engine.prefill(model, params, bos, ones, ST_SELF_LEN + 1,
                                      extra={"frames": frames, "frame_lengths": fl})
            return fn, kv_rows, tables, (f"frames [{ST_UTTERANCES}, {f}, {cfg.d_model}], "
                                         f"frame lengths mean {float(fl.float().mean()):.1f}; "
                                         f"BOS [{ST_UTTERANCES}, 1]")
        streams = ST_UTTERANCES * ST_BEAMS
        cache = model.init_cache(streams, ST_SELF_LEN + 1, device)
        _random_cache(cache, torch.full((streams,), ST_SELF_LEN, dtype=torch.int32,
                                        device=device), gen)
        cache["frame_lengths"].copy_(fl.repeat_interleave(ST_BEAMS))
        prof = profiles.BeamProfile(n_beams=ST_BEAMS, eos_id=2)
        state = prof.init(ST_UTTERANCES, ST_SELF_LEN + 2, device)
        tok = randint(streams)

        def fn():
            logits, _ = engine.decode_step(model, params, cache, tok)
            out = prof.step(state, logits)
            return kv_cache.reorder_donated(cache, out.perm)
        return fn, kv_rows, tables, (f"{streams} streams, self rows {ST_SELF_LEN}, frames "
                                     f"{f} (lengths mean {float(fl.float().mean()):.1f})")
    if phase == "P":
        toks = randint(batch, prompt)
        lens = torch.full((batch,), prompt, dtype=torch.int32, device=device)

        def fn():
            return engine.prefill(model, params, toks, lens, prompt + 1)
        return fn, kv_rows, tables, f"tokens [{batch}, {prompt}]"
    cache = model.init_cache(batch, ctx + 1, device)
    _random_cache(cache, torch.full((batch,), ctx, dtype=torch.int32, device=device), gen)
    tok = randint(batch)

    def fn():
        return engine.decode_step(model, params, cache, tok)
    return fn, kv_rows, tables, f"{batch} rows at context {ctx}"


def summarize(workload: str, phase: str, cfg, kern, window, *, kv_rows, tables, wall: float,
              shape: str) -> Dict:
    """``breakdown`` of one profiled window beside the analytic model at the
    same config, depth, batch and lengths, with the unprofiled wall."""
    _, _, batch, prompt, ctx, _ = WORKLOADS[workload]
    seq = prompt if phase == "P" else ctx
    res = breakdown(kern, window, kv_rows=kv_rows, tables=tables)
    ana = analytic(cfg, phase, batch, seq)
    res.update(workload=workload, phase=phase, arch=cfg.name, layers=cfg.n_layers,
               batch=batch, seq=seq, shape=shape, wall_ms=wall, analytic=ana,
               measured_over_analytic={c: (res["classes"][c]["ms"] / a["ms"]
                                           if a["ms"] > 0 else None) for c, a in ana.items()})
    return res


#: the ported kernels a window may hold: key -> (the launch counters of
#: their wrappers, the class they belong in, a test of the device kernel's
#: name). A counter is the ``LAUNCHES`` of the kernel module of its name.
PORTED = {
    "flash": (("flash_attention",), "attention", lambda n: "flash_" in n),
    "decode": (("decode_attention", "paged_decode_attention"), "attention",
               lambda n: ("decode_attention" in n or "decode_latent" in n)
               and "combine" not in n),
    "hstu": (("hstu_attention",), "attention", lambda n: "hstu_attention" in n),
    "rmsnorm": (("rmsnorm",), "norm", lambda n: "rmsnorm_" in n),
}


def _counter_modules():
    import importlib

    return {c: importlib.import_module(f"repro_torch.kernels.{c}")
            for ctrs, _, _ in PORTED.values() for c in ctrs}


def reset_launches() -> None:
    """Set the ``PORTED`` wrappers' launch counters to 0."""
    for m in _counter_modules().values():
        m.LAUNCHES = 0


def read_launches() -> Dict[str, int]:
    """The ``PORTED`` wrappers' launch counters, by counter name."""
    return {c: m.LAUNCHES for c, m in _counter_modules().items()}


def ported(kernels: Sequence[Kernel], window: Tuple[float, float], launched: Dict[str, int],
           *, kv_rows=(), tables=()) -> Dict[str, Dict]:
    """Per ``PORTED`` key: the kernels of that name the window holds
    (``seen``), the launches their wrappers counted (``launched``), the
    classes those kernels fell in and the class they belong in."""
    t0, t1 = window
    inside = [k for k in kernels if PAD_NAME not in k.name and k.end_us > t0 and k.start_us < t1]
    out = {}
    for key, (ctrs, cls, match) in PORTED.items():
        mine = [k for k in inside if match(k.name)]
        out[key] = {"seen": len(mine), "launched": sum(launched[c] for c in ctrs),
                    "classes": sorted({classify(k, kv_rows=kv_rows, tables=tables)
                                       for k in mine}), "want": cls}
    return out


def problems(res: Dict) -> List[str]:
    """What makes a ``measure`` result wrong: a kernel in no class, classes
    plus idle off the window by more than ``RESIDUAL_BOUND``, a kernel that
    neither its name nor a launching aten op places (a lost link), and a
    ported kernel seen other than as often as its wrappers launched it, or
    in another class than its own."""
    out = []
    n = sum(c["n"] for c in res["classes"].values())
    if n != res["n_kernels"]:
        out.append(f"{n} of {res['n_kernels']} kernels classified")
    if abs(res["residual"]) > RESIDUAL_BOUND:
        out.append(f"classes plus idle are {1 + res['residual']:.4f} of the window")
    if res["unlinked"]:
        out.append(f"kernels linked to no aten op: {res['unlinked']}")
    for key, p in res["ported"].items():
        if p["seen"] != p["launched"] or p["classes"] not in ([], [p["want"]]):
            out.append(f"{key}: {p['seen']} kernels seen in {p['classes']} of "
                       f"{p['launched']} launched (class {p['want']})")
    return out


def measure(workload: str, phase: str, cfg, model, params, device, seed: int = 0, *,
            session: Callable = padded_session, reset: Callable = reset_launches,
            read: Callable = read_launches) -> Dict:
    """One window of the workload's phase: warmed up, its unprofiled wall,
    then one call profiled in ``session()`` with the launch counters set to
    0 by ``reset()`` just before it and read by ``read()`` just after, and
    ``summarize``d. A session that saw fewer of the ``PORTED`` kernels than
    their wrappers launched lost device records: the window is profiled
    once more. The result adds ``kernels`` (the last
    session's), ``launched`` (``read()``'s counts), ``ported`` and
    ``short``: the kernels of each session that was short."""
    fn, kv_rows, tables, shape = window_call(workload, phase, cfg, model, params, device, seed)
    short = []
    with torch.inference_mode():
        fn()
        wall = wall_ms(fn)
        for _ in range(2):
            reset()
            kern, window = profile_window(fn, session)
            launched = read()
            seen = ported(kern, window, launched, kv_rows=kv_rows, tables=tables)
            if all(p["seen"] >= p["launched"] for p in seen.values()):
                break
            short.append(kern)
    res = summarize(workload, phase, cfg, kern, window, kv_rows=kv_rows, tables=tables,
                    wall=wall, shape=shape)
    res.update(kernels=kern, launched=launched, ported=seen, short=short)
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", choices=sorted(WORKLOADS), action="append")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("op_breakdown: needs a CUDA card")
    dev = torch.device("cuda")
    wrong = 0
    for wl in args.workload or list(WORKLOADS):
        cfg, model, params = build(wl, dev, args.seed)
        for phase in WORKLOADS[wl][5]:
            res = measure(wl, phase, cfg, model, params, dev, args.seed)
            del res["kernels"]
            res["short_sessions"] = [len(k) for k in res.pop("short")]
            res["problems"] = problems(res)
            res["device"] = torch.cuda.get_device_name(0)
            wrong += bool(res["problems"])
            print(json.dumps(res), flush=True)
        del model, params
        torch.cuda.empty_cache()
    if wrong:
        sys.exit(f"op_breakdown: {wrong} windows measured wrong (their \"problems\")")


if __name__ == "__main__":
    main()
