#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. device  — require CUDA, print the card's name and power limit, turn TF32
             off for the f32 checks;
2. build   — compile the kernel library from ``src/repro_torch/kernels/csrc``
             with nvcc (``kernels/_build.py``);
3. kernels — every kernel of the served path against its plain PyTorch
             version at the main path's shapes, bf16 (atol/rtol 2e-2) and f32
             (atol 2e-5, rtol 2e-4), plus edge cases (fully masked rows,
             windows, MQA, D=128); CUDA-event times of kernel, plain version
             and a PyTorch library call, beside the card's bound;
4. serve   — full-width llama3.2-1b in bf16 (random weights from a seeded
             generator) serves 16 requests through the continuous-batching
             scheduler, then through ``policy="fixed"``: every request gets
             its own max_new tokens, all logits are finite, every kernel's
             launch counter rose by exactly its per-forward count, and both
             policies give identical tokens;
5. parity  — prefill logits of two requests through the kernels and through
             the plain versions on the same weights, and their first served
             tokens against greedy generation on the plain path;
6. profile — torch.profiler over served decode steps: device busy share
             and device time by kind (ported kernels, matmuls, other ops).

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the ``{"kernels": [...]}`` summary. Imports nothing of JAX or the JAX package.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
TOL = {"bfloat16": (2e-2, 2e-2), "float32": (2e-5, 2e-4)}  # (atol, rtol)
ARCH = "llama3.2-1b"
N_REQUESTS, SLOTS, MAX_NEW, SEED = 16, 8, 64, 0


class PhaseError(RuntimeError):
    pass


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise PhaseError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, samples: int = 20, inner: int = 10, warmup: int = 5) -> float:
    """Median over ``samples`` of CUDA-event time around ``inner``
    back-to-back calls, divided by ``inner`` (after ``warmup`` calls). A call
    whose host side outlasts its kernels is timed at its host rate."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_kernels(prof):
    """The CUDA kernel (and memcpy/memset) events of a torch.profiler run."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_ms(fn, calls: int = 20):
    """Device time per call: the summed durations of the kernels that
    ``calls`` calls launched, from torch.profiler (CUPTI), over ``calls``;
    None when the profiler saw no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kern = device_kernels(prof)
    if not kern:
        return None
    return sum(e.time_range.elapsed_us() for e in kern) / calls / 1e3


def max_err(got, want, dtype_name: str) -> float:
    """max |got - want| in f32; raises if any element is outside
    atol + rtol * |want| (the assert_allclose rule) or not finite."""
    import torch

    g, w = got.float(), want.float()
    atol, rtol = TOL[dtype_name]
    check(bool(torch.isfinite(g).all()), "kernel output is not finite")
    diff = (g - w).abs()
    bad = diff > atol + rtol * w.abs()
    check(not bool(bad.any()),
          f"{int(bad.sum())} elements outside atol={atol} rtol={rtol} "
          f"(max |diff| {float(diff.max()):.3e})")
    return float(diff.max()) if diff.numel() else 0.0


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_device():
    import torch

    line = gpu_line()
    print(f"[device] {line} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return line


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    secs = time.perf_counter() - t0
    print(f"[build] {path.name} in {secs:.1f}s", flush=True)
    log = _build.BUILD_DIR / "build.log"
    if log.exists():
        for ln in log.read_text().splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                print(f"[build]   {ln.strip()}", flush=True)
    return secs


def _rand(gen, shape, dtype, device):
    import torch

    return torch.randn(shape, generator=gen, device=device).to(dtype)


def phase_kernels(pad_to: int, max_len: int):
    """Correctness of every kernel in both types at the main path's shapes
    and edge cases, then bf16 timings; returns the per-kernel records."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    d_model, hq, hkv, dh = 2048, 32, 8, 64
    errs = {"rmsnorm": {}, "flash_attention": {}, "decode_attention": {}}

    # ---- rmsnorm: decode rows [8, 1, d] and prefill rows [1, pad_to, d]
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        for shape in ((SLOTS, 1, d_model), (1, pad_to, d_model)):
            x = _rand(gen, shape, dt, dev) * 3
            w = (1 + 0.1 * _rand(gen, (d_model,), torch.float32, dev)).to(dt)
            e = max_err(rn.rmsnorm_cuda(x, w, 1e-5), rn.rmsnorm_plain(x, w, 1e-5), name)
            errs["rmsnorm"][f"{name}{list(shape)}"] = e

    # ---- flash attention: the served prefill plus edge cases
    def flash_case(b, t, s, h_q, h_kv, d, dt, *, window=None, positions=None,
                   k_valid=None, causal=True):
        q = _rand(gen, (b, t, h_q, d), dt, dev)
        k = _rand(gen, (b, s, h_kv, d), dt, dev)
        v = _rand(gen, (b, s, h_kv, d), dt, dev)
        if positions is None:
            qp = (torch.arange(t, device=dev) + (s - t)).expand(b, t)
            kp = torch.arange(s, device=dev).expand(b, s)
        else:
            qp, kp = positions
        qp = qp.to(torch.int32).contiguous()
        kp = kp.to(torch.int32).contiguous()
        kw = dict(q_positions=qp, k_positions=kp, causal=causal, window=window,
                  k_valid=k_valid)
        got = fa.flash_attention_cuda(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        return got, want

    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        got, want = flash_case(1, pad_to, pad_to, hq, hkv, dh, dt)
        errs["flash_attention"][f"{name} prefill T={pad_to}"] = max_err(got, want, name)
        for label, args, kw in (
            ("gqa ragged", (2, 67, 67, 8, 2, 64), {}),
            ("window 16", (2, 67, 67, 8, 2, 64), {"window": 16}),
            ("mqa", (1, 128, 128, 4, 1, 64), {}),
            ("mha D=128", (1, 80, 80, 4, 4, 128), {}),
        ):
            got, want = flash_case(*args, dt, **kw)
            errs["flash_attention"][f"{name} {label}"] = max_err(got, want, name)
        # explicit positions + k_valid; batch row 1 sees no valid key at all
        b, t, s = 2, 5, 40
        qp = torch.tensor([[10, 11, 12, 13, 14], [3, 4, 5, 6, 7]], device=dev)
        kp = torch.arange(s, device=dev).expand(b, s)
        kval = kp < torch.tensor([[15], [0]], device=dev)
        got, want = flash_case(b, t, s, 8, 2, 64, dt, positions=(qp, kp),
                               k_valid=kval.contiguous())
        errs["flash_attention"][f"{name} positions+k_valid"] = max_err(got, want, name)
        check(bool((got[1] == 0).all()), "flash: a fully masked row is not exactly zero")

    # ---- decode attention: the served decode step plus edge cases
    def decode_case(b, s, h_q, h_kv, d, dt, lengths):
        q = _rand(gen, (b, h_q, d), dt, dev)
        k = _rand(gen, (b, s, h_kv, d), dt, dev)
        v = _rand(gen, (b, s, h_kv, d), dt, dev)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        return (da.decode_attention_cuda(q, k, v, ln),
                da.decode_attention_plain(q, k, v, ln))

    serve_lengths = [1, max_len, pad_to, pad_to + 1, 44, 100, 200, max_len - 1]
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        got, want = decode_case(SLOTS, max_len, hq, hkv, dh, dt, serve_lengths)
        errs["decode_attention"][f"{name} decode S={max_len}"] = max_err(got, want, name)
        got, want = decode_case(3, 129, 8, 1, 64, dt, [0, 64, 129])
        errs["decode_attention"][f"{name} mqa len 0/64/129"] = max_err(got, want, name)
        check(bool((got[0] == 0).all()), "decode: a row of length 0 is not exactly zero")
        got, want = decode_case(2, 50, 8, 2, 128, dt, [1, 50])
        errs["decode_attention"][f"{name} D=128"] = max_err(got, want, name)
    torch.cuda.synchronize()
    for kname, e in errs.items():
        for case, v in e.items():
            print(f"[kernels] {kname:16s} {case:28s} max|err| {v:.3e}", flush=True)

    # ---- timings at the main path's shapes, bf16
    bf = torch.bfloat16
    records = []

    x = _rand(gen, (SLOTS, 1, d_model), bf, dev)
    w = torch.ones(d_model, dtype=bf, device=dev)
    n = x.numel()
    rms_bytes = (2 * n + d_model) * 2
    records.append(dict(
        name="rmsnorm", route="cuda",
        source="src/repro_torch/kernels/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm.py:25",
        shape=f"x[{SLOTS},1,{d_model}] bf16 (decode step)",
        max_abs_err=errs["rmsnorm"][f"bfloat16[{SLOTS}, 1, {d_model}]"],
        call=lambda: rn.rmsnorm_cuda(x, w, 1e-5),
        ms=cuda_ms(lambda: rn.rmsnorm_cuda(x, w, 1e-5)),
        plain_ms=cuda_ms(lambda: rn.rmsnorm_plain(x, w, 1e-5)),
        library_ms=cuda_ms(lambda: F.rms_norm(x, (d_model,), w, 1e-5)),
        bytes=rms_bytes, flops=4 * n,
    ))

    q = _rand(gen, (1, pad_to, hq, dh), bf, dev)
    k = _rand(gen, (1, pad_to, hkv, dh), bf, dev)
    v = _rand(gen, (1, pad_to, hkv, dh), bf, dev)
    pos = torch.arange(pad_to, device=dev, dtype=torch.int32)[None].contiguous()
    fkw = dict(q_positions=pos, k_positions=pos, causal=True)
    k_exp = k.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
    v_exp = v.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
    q_t = q.transpose(1, 2)
    pairs = pad_to * (pad_to + 1) // 2  # causal (query, key) pairs this input needs
    records.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:88",
        shape=f"q[1,{pad_to},{hq},{dh}] kv[1,{pad_to},{hkv},{dh}] bf16 causal (prefill)",
        max_abs_err=errs["flash_attention"][f"bfloat16 prefill T={pad_to}"],
        call=lambda: fa.flash_attention_cuda(q, k, v, **fkw),
        ms=cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, **fkw)),
        plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, **fkw)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q_t, k_exp, v_exp, is_causal=True)),
        bytes=(q.numel() * 2 + k.numel() + v.numel()) * 2 + 2 * pad_to * 4,
        flops=pairs * hq * 4 * dh,
    ))

    qd = _rand(gen, (SLOTS, hq, dh), bf, dev)
    kc = _rand(gen, (SLOTS, max_len, hkv, dh), bf, dev)
    vc = _rand(gen, (SLOTS, max_len, hkv, dh), bf, dev)
    ln = torch.tensor(serve_lengths, dtype=torch.int32, device=dev)
    kc_exp = kc.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
    vc_exp = vc.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
    amask = (torch.arange(max_len, device=dev)[None] < ln[:, None])[:, None, None, :]
    n_rows = int(sum(serve_lengths))  # cache rows this input needs read
    records.append(dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:80",
        shape=f"q[{SLOTS},{hq},{dh}] cache[{SLOTS},{max_len},{hkv},{dh}] bf16 "
              f"lengths {serve_lengths}",
        max_abs_err=errs["decode_attention"][f"bfloat16 decode S={max_len}"],
        call=lambda: da.decode_attention_cuda(qd, kc, vc, ln),
        ms=cuda_ms(lambda: da.decode_attention_cuda(qd, kc, vc, ln)),
        plain_ms=cuda_ms(lambda: da.decode_attention_plain(qd, kc, vc, ln)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qd[:, :, None], kc_exp, vc_exp, attn_mask=amask)),
        bytes=(2 * qd.numel() + 2 * n_rows * hkv * dh) * 2 + SLOTS * 4,
        flops=n_rows * hq * 4 * dh,
    ))
    for r in records:
        t_bytes = r.pop("bytes") / HBM_BYTES_PER_S * 1e3
        t_ops = r.pop("flops") / BF16_FLOPS_PER_S * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        r["kernel_ms"] = r["ms"]
        r["device_ms"] = device_ms(r.pop("call"))
        dev_txt = "not measured" if r["device_ms"] is None else f"{r['device_ms']:.4f} ms"
        print(f"[kernels] {r['name']:16s} kernel {r['ms']:.4f} ms (device {dev_txt}) | plain "
              f"{r['plain_ms']:.4f} ms | library {r['library_ms']:.4f} ms | bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}) | {r['shape']}", flush=True)
    return records


def _counters():
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn

    return {"rmsnorm": rn, "flash_attention": fa, "decode_attention": da}


def _reset_counts():
    for mod in _counters().values():
        mod.LAUNCHES = 0


def _read_counts():
    return {name: mod.LAUNCHES for name, mod in _counters().items()}


def phase_serve(pad_to: int):
    """Full-width llama3.2-1b, bf16, 16 requests, continuous then fixed."""
    import torch

    from repro_torch.core import engine
    from repro_torch.core.kv_cache import leaves
    from repro_torch.launch import serve
    from repro_torch.training import data as data_mod

    dev = torch.device("cuda")
    cfg, model, params = serve.build_model(ARCH, smoke=False, seed=SEED, device=dev)
    check(cfg.dtype == "bfloat16" and cfg.d_model == 2048 and cfg.n_layers == 16,
          f"unexpected config {cfg}")
    prof = data_mod.PAPER_PROFILES["llama_humaneval"]

    def trace():
        return serve.poisson_trace(prof, N_REQUESTS, pad_to=pad_to, max_new_cap=MAX_NEW,
                                   vocab_size=cfg.vocab_size, arrival_rate=0.0, seed=SEED)

    t0 = time.perf_counter()
    serve.warmup(model, params, slots=SLOTS, pad_to=pad_to, max_new_cap=MAX_NEW,
                 device=dev)
    print(f"[serve] params {sum(p.numel() for p in leaves(params)) / 1e9:.3f}G "
          f"elements | pad_to {pad_to} | warm-up {time.perf_counter() - t0:.1f}s",
          flush=True)

    # every logits tensor the scheduler samples from is checked on the device
    # (one flag, read once per run): no per-step host sync is added
    finite = {"ok": torch.ones((), dtype=torch.bool, device=dev)}
    real_prefill, real_decode = engine.prefill, engine.decode_step

    def prefill(*a, **kw):
        logits, cache = real_prefill(*a, **kw)
        finite["ok"] &= torch.isfinite(logits).all()
        return logits, cache

    def decode_step(*a, **kw):
        logits, cache = real_decode(*a, **kw)
        finite["ok"] &= torch.isfinite(logits).all()
        return logits, cache

    engine.prefill, engine.decode_step = prefill, decode_step
    runs = {}
    try:
        for policy in ("continuous", "fixed"):
            reqs = trace()
            want_new = {r.rid: r.max_new for r in reqs}
            _reset_counts()
            m, done = serve.run_scheduler(
                model, params, reqs, slots=SLOTS, pad_to=pad_to, max_new_cap=MAX_NEW,
                device=dev, policy=policy, return_requests=True,
            )
            counts = _read_counts()
            check(len(done) == N_REQUESTS, f"{policy}: {len(done)} of {N_REQUESTS} done")
            for r in done:
                check(len(r.tokens) == want_new[r.rid],
                      f"{policy}: request {r.rid} got {len(r.tokens)} of "
                      f"{want_new[r.rid]} tokens")
            n_fwd = m["prefills"] + m["decode_steps"]
            want_counts = {
                "rmsnorm": (2 * cfg.n_layers + 1) * n_fwd,
                "flash_attention": cfg.n_layers * m["prefills"],
                "decode_attention": cfg.n_layers * m["decode_steps"],
            }
            check(counts == want_counts,
                  f"{policy}: kernel launches {counts}, expected {want_counts}")
            print(f"[serve/{policy}] {m['n_requests']} requests | "
                  f"{m['tokens_per_s']:.1f} tok/s | ttft p50 {m['ttft_p50_ms']:.2f} ms | "
                  f"tpot p50 {m['tpot_p50_ms']:.3f} ms | decode steps "
                  f"{m['decode_steps']} | prefills {m['prefills']} | occupancy "
                  f"{m['mean_slot_occupancy']:.3f} | wall {m['wall_s']:.2f} s | "
                  f"launches {counts}", flush=True)
            runs[policy] = (m, {r.rid: list(r.tokens) for r in done}, counts)
    finally:
        engine.prefill, engine.decode_step = real_prefill, real_decode
    check(bool(finite["ok"]), "non-finite logits during serving")
    check(runs["continuous"][1] == runs["fixed"][1],
          "continuous and fixed policies gave different tokens")
    return model, params, trace(), runs


def _prefill_last(model, params, seq, impl):
    """Last-position logits of one token sequence, through ``impl``."""
    import torch

    from repro_torch.core import engine

    dev = torch.device("cuda")
    toks = torch.tensor([list(seq)], dtype=torch.int32, device=dev)
    ln = torch.tensor([len(seq)], dtype=torch.int32, device=dev)
    logits, _ = engine.prefill(model, params, toks, ln, len(seq) + 1, impl=impl)
    return logits[0]


def phase_parity(model, params, pad_to, reqs, served):
    """Prefill logits through the kernels vs through the plain versions, and
    the first served tokens vs greedy generation on the plain path. A
    token may differ only at a near tie: where the plain path's top-1/top-2
    gap is below the two paths' max |logit difference| at that step."""
    import numpy as np
    import torch

    from repro_torch.core import engine

    dev = torch.device("cuda")
    n_tok = 16
    for r in reqs:
        lc = _prefill_last(model, params, r.prompt, "cuda")
        lp = _prefill_last(model, params, r.prompt, "torch")
        check(bool(torch.isfinite(lc).all()), "non-finite kernel-path logits")
        delta = float((lc - lp).abs().max())
        span = float(lp.max() - lp.min())
        top2 = torch.topk(lp, 2).values
        gap = float(top2[0] - top2[1])
        same = int(lc.argmax()) == int(lp.argmax())
        print(f"[parity] request {r.rid}: prefill max|dlogit| {delta:.4f} = "
              f"{delta / span:.2e} of the logit range {span:.1f} | top1-top2 gap "
              f"{gap:.4f} | greedy token {'agrees' if same else 'differs'}", flush=True)
        check(same or gap < delta,
              f"request {r.rid}: greedy first token differs with gap {gap} >= {delta}")

        buf = np.zeros((1, pad_to), np.int32)
        buf[0, : len(r.prompt)] = r.prompt
        plain = engine.generate(
            model, params, torch.from_numpy(buf).to(dev),
            prompt_lengths=torch.tensor([len(r.prompt)], dtype=torch.int32, device=dev),
            max_new_tokens=n_tok, impl="torch",
        )["tokens"][0].tolist()
        got = served[r.rid][:n_tok]
        first = next((i for i, (a, b) in enumerate(zip(got, plain)) if a != b), None)
        if first is None:
            print(f"[parity] request {r.rid}: first {n_tok} served tokens equal the "
                  f"plain path's", flush=True)
            continue
        seq = list(r.prompt) + plain[:first]
        lp = _prefill_last(model, params, seq, "torch")
        d = float((_prefill_last(model, params, seq, "cuda") - lp).abs().max())
        top2 = torch.topk(lp, 2).values
        g = float(top2[0] - top2[1])
        print(f"[parity] request {r.rid}: served token {first} differs from the plain "
              f"path (gap {g:.4f}, max|dlogit| {d:.4f})", flush=True)
        check(g < d, f"request {r.rid}: token {first} differs away from a near tie")


def phase_profile(model, params, pad_to, reqs):
    """Where the time of one served decode step goes: torch.profiler over
    a few pool-wide decode steps with every slot live, each ending in the
    scheduler's greedy argmax and host copy."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import engine, sampling
    from repro_torch.core.slot_pool import SlotPool

    dev = torch.device("cuda")
    pool = SlotPool(model, SLOTS, pad_to + MAX_NEW + 1, dev)
    first = []
    for slot, r in enumerate(reqs[:SLOTS]):
        toks = torch.zeros((1, pad_to), dtype=torch.int32, device=dev)
        toks[0, : len(r.prompt)] = torch.as_tensor(r.prompt, dtype=torch.int32)
        logits, row = engine.prefill(model, params, toks,
                                     torch.tensor([len(r.prompt)], dtype=torch.int32,
                                                  device=dev), pool.max_len)
        pool.assign(slot, row)
        first.append(int(sampling.greedy(logits)[0]))
    token = torch.tensor(first, dtype=torch.int32, device=dev)

    def step():
        nonlocal token
        logits, pool.cache = engine.decode_step(model, params, pool.cache, token)
        host = sampling.greedy(logits).cpu()  # the step's one host sync
        token = host.to(dev)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    n_steps = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    t0 = time.perf_counter()
    for _ in range(n_steps):
        step()
    torch.cuda.synchronize()
    bare_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    kern = device_kernels(prof)
    if not kern:
        print(f"[profile] decode step {bare_ms:.3f} ms wall; the profiler saw no device "
              f"activity: device busy share not measured", flush=True)
        return
    cats = {"ported kernels": 0.0, "matmuls (cuBLAS)": 0.0, "other torch ops": 0.0}
    by_name = {}
    for e in kern:
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        low = e.name.lower()
        if any(k in e.name for k in ("rmsnorm_kernel", "flash_attention_kernel",
                                     "decode_attention_kernel")):
            cats["ported kernels"] += us
        elif any(k in low for k in ("gemm", "gemv", "cutlass", "xmma", "nvjet")):
            cats["matmuls (cuBLAS)"] += us
        else:
            cats["other torch ops"] += us
    busy_ms = sum(cats.values()) / n_steps / 1e3
    print(f"[profile] decode step (B={SLOTS}, bf16): wall {bare_ms:.3f} ms unprofiled, "
          f"{wall_ms:.3f} ms profiled | device busy {busy_ms:.3f} ms = "
          f"{busy_ms / bare_ms:.1%} of the unprofiled step ({busy_ms / wall_ms:.1%} of "
          f"the profiled one) | {len(kern) / n_steps:.0f} device kernels per step",
          flush=True)
    for c, us in cats.items():
        print(f"[profile]   {c:18s} {us / n_steps / 1e3:.4f} ms/step "
              f"({us / max(sum(cats.values()), 1e-9):.1%} of device time)", flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[profile]   top: {us / n_steps / 1e3:.4f} ms/step  {name[:110]}", flush=True)


def main() -> None:
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port is not importable from {ROOT}/src: {e}")
    try:
        gpu = phase_device()
        phase_build()
        from repro_torch.launch import serve
        from repro_torch.training import data as data_mod

        pad_to = serve.trace_pad_to(data_mod.PAPER_PROFILES["llama_humaneval"],
                                    N_REQUESTS, SEED)
        records = phase_kernels(pad_to, pad_to + MAX_NEW + 1)
        model, params, trace, runs = phase_serve(pad_to)
        for r in records:
            r["launches"] = runs["continuous"][2][r["name"]]
        phase_parity(model, params, pad_to, trace[:2], runs["continuous"][1])
        phase_profile(model, params, pad_to, trace)
        torch.cuda.synchronize()
    except Exception:  # any phase failure: report and exit non-zero
        traceback.print_exc()
        fail("a phase failed")
    print(gpu, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
