"""Device time by kernel of the bf16 kernels of the Mamba-2 and HSTU paths
and of RMSNorm on every path:

- ``ssd_scan_cuda`` at mamba2-130m's prefill width (x [1, T, 24, 64], B/C
  [1, T, 1, 128], one chunk of 256) at T = 64, 128 and 256, where the
  heaviest 64-row tile walks 1, 2 and 4 column tiles;
- ``hstu_attention_cuda`` at full width (q/k/v [2, 5121, 8, 64], lengths
  4507 / 5121) with the 1024 band and with none;
- RMSNorm at the served shapes, with the op before it: llama's decode step
  (x [8, 1, 2048]: none and add) and prefill ([1, 256, 2048]: add),
  Mamba-2's gated norm ([1, 256, 1536], z a slice of rows of 3352) and
  HSTU's forward ([8, 5030, 512]: none, add, and mul with u a slice of rows
  of 2048). A tree without the fused ops times the unfused pair (the torch
  op, then its ``rmsnorm_cuda``), so parent and change compare.

Each time is the profiler's (CUPTI) device time per call, summed by kernel
name, so a call's stages show apart (and ``total``). ``ok`` says whether
every output held its plain version's tolerance (bf16 atol = rtol = 2e-2;
the SSD's final state atol 2e-4 / rtol 2e-3). One JSON line per run,
naming the ``repro_torch`` it imported, so two trees compare in one process
order (parent, change, change, parent):

  PYTHONPATH=src python src/repro_torch/launch/kernel_times.py
  PYTHONPATH=<other checkout>/src python src/repro_torch/launch/kernel_times.py

Needs a CUDA card; random inputs from ``--seed``.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys

import torch

import repro_torch
from repro_torch.kernels import hstu_attention as ha
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssd_scan as ss

#: (label, prologue, x shape, row stride of the second operand or None)
RMSNORM_CASES = [
    ("llama decode", "none", (8, 1, 2048), None),
    ("llama decode", "add", (8, 1, 2048), None),
    ("llama prefill", "add", (1, 256, 2048), None),
    ("mamba2 prefill", "mul_silu", (1, 256, 1536), 3352),
    ("hstu forward", "none", (8, 5030, 512), None),
    ("hstu forward", "add", (8, 5030, 512), None),
    ("hstu forward", "mul", (8, 5030, 512), 2048),
]


def by_kernel(fn, calls: int = 20) -> dict:
    """Device ms per call of ``fn`` by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type.name != "CUDA":
            continue
        m = re.search(r"(\w+)[<(]", e.name)
        name = m.group(1) if m else e.name
        out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / calls / 1e3
    out["total"] = sum(out.values())
    return out


def rmsnorm_calls(prologue, x, other, w):
    """(the call that this tree's package makes, its plain version): the
    fused kernel, or on a tree without it the torch op and then
    ``rmsnorm_cuda``."""
    silu = torch.nn.functional.silu
    if prologue == "none":
        return lambda: rn.rmsnorm_cuda(x, w), lambda: rn.rmsnorm_plain(x, w)
    unfused = {"add": lambda: x + other, "mul": lambda: x * other,
               "mul_silu": lambda: x * silu(other)}[prologue]
    fused = getattr(rn, f"{prologue}_rmsnorm_cuda", None)
    call = ((lambda: fused(x, other, w)) if fused is not None
            else (lambda: rn.rmsnorm_cuda(unfused(), w)))
    return call, lambda: rn.rmsnorm_plain(unfused(), w)


def within(got, want, atol: float, rtol: float) -> bool:
    return bool(((got.float() - want.float()).abs() <= atol + rtol * want.float().abs()).all())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("kernel_times: needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    times, ok = {}, True
    for t in (64, 128, 256):
        kw = dict(x=randn(1, t, 24, 64).to(bf),
                  dt=torch.nn.functional.softplus(randn(1, t, 24)) * 0.1,
                  A=-torch.linspace(1.0, 16.0, 24, device=dev), B_=randn(1, t, 1, 128).to(bf),
                  C=randn(1, t, 1, 128).to(bf), D=torch.ones(24, device=dev))
        y, s = ss.ssd_scan_cuda(chunk=256, **kw)
        wy, ws = ss.ssd_scan_plain(chunk=256, **kw)
        ok &= within(y, wy, 2e-2, 2e-2) and within(s, ws, 2e-4, 2e-3)
        times[f"ssd_scan T={t}"] = by_kernel(lambda kw=kw: ss.ssd_scan_cuda(chunk=256, **kw))
    q, k, v = (randn(2, 5121, 8, 64).to(bf) for _ in range(3))
    rb = randn(4095) * 0.1
    lengths = torch.tensor([4507, 5121], dtype=torch.int32, device=dev)
    for band in (1024, None):
        hkw = dict(max_attn_len=band, lengths=lengths)
        ok &= within(ha.hstu_attention_cuda(q, k, v, rb, **hkw),
                     ha.hstu_attention_plain(q, k, v, rb, **hkw), 2e-2, 2e-2)
        times[f"hstu_attention band {band}"] = by_kernel(
            lambda hkw=hkw: ha.hstu_attention_cuda(q, k, v, rb, **hkw), calls=5)
    for label, prologue, shape, stride in RMSNORM_CASES:
        x = randn(*shape).to(bf)
        other = randn(*shape[:-1], stride or shape[-1]).to(bf)[..., :shape[-1]]
        w = (1 + 0.1 * randn(shape[-1])).to(bf)
        call, plain = rmsnorm_calls(prologue, x, other, w)
        got = call()
        ok &= within(got[1] if isinstance(got, tuple) else got, plain(), 2e-2, 2e-2)
        times[f"rmsnorm {prologue} {label} {list(shape)}"] = by_kernel(call)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"repro_torch": repro_torch.__file__, "card": card.stdout.strip(),
                      "ok": ok, "device_ms": times}))


if __name__ == "__main__":
    main()
