"""Host and CUDA-event time of the decode step's two redesigned kernel
wrappers, ``decode_attention_cuda`` and ``int8_matmul_weight_only_cuda``,
at llama3.2-1b's served shapes: the decode attention of one step (q [8, 32,
64] bf16 against an [8, 321, 8, 64] cache at the served lengths) and every
weight-only linear at M = 8 (decode) and M = 256 (prefill).

``host_ms`` is the enqueue rate from an idle card (calls with no
synchronisation between them): the wrapper's Python, its workspace and its
launches. ``ms`` is the median of CUDA-event time around back-to-back
calls. One JSON line per run, naming the ``repro_torch`` it imported, so
two trees compare in one process order (parent, change, change, parent):

  PYTHONPATH=src python src/repro_torch/launch/wrapper_times.py
  PYTHONPATH=<other checkout>/src python src/repro_torch/launch/wrapper_times.py

Needs a CUDA card; random inputs from ``--seed``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

import repro_torch
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import int8_matmul as im

#: llama3.2-1b's linears (K, N): q/o, k/v, w1/w3, w2
LINEARS = ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048))
#: the served decode step's cache lengths at S = 321 (chip_smoke's)
SERVE_LENGTHS = (1, 321, 256, 257, 44, 100, 200, 320)


def host_ms(fn, calls: int = 500) -> float:
    """Host time per call of ``fn`` over ``calls`` calls with no
    synchronisation between them, from an idle card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e3


def cuda_ms(fn, samples: int = 20, inner: int = 10) -> float:
    """Median over ``samples`` of CUDA-event time around ``inner``
    back-to-back calls, over ``inner``."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("wrapper_times: needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    calls = {}
    q, k, v = randn(8, 32, 64), randn(8, 321, 8, 64), randn(8, 321, 8, 64)
    lengths = torch.tensor(SERVE_LENGTHS, dtype=torch.int32, device=dev)
    calls["decode_attention q[8,32,64] cache[8,321,8,64]"] = (
        lambda: da.decode_attention_cuda(q, k, v, lengths))
    for m in (8, 256):
        for kk, n in LINEARS:
            x = randn(m, kk)
            w_q = torch.randint(-127, 128, (kk, n), generator=gen, device=dev,
                                dtype=torch.int8)
            w_scale = torch.rand(n, generator=gen, device=dev) * 1e-2
            calls[f"int8_matmul_weight_only [{m},{kk}]x[{kk},{n}]"] = (
                lambda x=x, w_q=w_q, s=w_scale: im.int8_matmul_weight_only_cuda(x, w_q, s))
    for fn in calls.values():  # build the library and warm every shape
        fn()
    torch.cuda.synchronize()
    out = {name: {"host_ms": host_ms(fn), "ms": cuda_ms(fn)} for name, fn in calls.items()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"repro_torch": repro_torch.__file__, "card": card.stdout.strip(),
                      "times": out}))


if __name__ == "__main__":
    main()
