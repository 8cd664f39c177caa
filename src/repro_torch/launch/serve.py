"""Serving launcher of the port: continuous-batching request serving over
the contiguous KV slot-pool (``core/slot_pool.py`` + ``core/scheduler.py``).

ONE batch-1 prefill admits requests into free slots, ONE pool-wide decode
step runs every step, and the scheduler recycles a slot the moment its
request finishes. ``--policy fixed`` degrades the same machinery to
run-to-completion batches for A/B comparison. Weights are random, drawn
from a ``torch.Generator`` seeded with ``--seed``; attention and RMSNorm
run through the hand-written CUDA kernels on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --smoke --device cpu --n-requests 8 --batch-slots 4 --max-new 16

Reported per request: TTFT (arrival -> first token), TPOT (mean inter-
token), e2e latency; aggregate: tokens/s, mean slot-occupancy and the
decode-stall-per-admission metric (the inter-step gap an admission's
prefill sat inside).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.scheduler import Scheduler, ServeRequest
from repro_torch.models import get_model
from repro_torch.training import data as data_mod


def poisson_trace(
    profile: data_mod.LengthProfile,
    n_requests: int,
    *,
    pad_to: int,
    max_new_cap: int,
    vocab_size: int,
    arrival_rate: float,
    seed: int = 0,
) -> List[ServeRequest]:
    """Requests with paper-profile lengths and Poisson (exponential
    inter-arrival) arrival offsets; rate <= 0 means all arrive at t=0.
    Draws the same prompts and lengths as the JAX launcher's trace."""
    rng = np.random.default_rng(seed)
    ins, outs = data_mod.sample_lengths(profile, n_requests, seed=seed + 1)
    t = 0.0
    reqs = []
    for i in range(n_requests):
        if arrival_rate > 0:
            t += rng.exponential(1.0 / arrival_rate)
        reqs.append(
            ServeRequest(
                rid=i,
                prompt=rng.integers(0, vocab_size, size=min(int(ins[i]), pad_to)),
                max_new=max(1, min(int(outs[i]), max_new_cap)),
                t_arrival=t if arrival_rate > 0 else 0.0,
            )
        )
    return reqs


def trace_pad_to(profile: data_mod.LengthProfile, n_requests: int, seed: int) -> int:
    """The launcher's prompt pad: the longest sampled prompt, capped at 256."""
    ins, _ = data_mod.sample_lengths(profile, n_requests, seed=seed + 1)
    return int(min(max(ins), 256))


def serve_metrics(done: List[ServeRequest], wall: float) -> Dict[str, object]:
    total_tok = sum(len(r.tokens) for r in done)
    ttft = [r.ttft for r in done]
    tpot = [r.tpot for r in done if len(r.tokens) > 1]
    e2e = [r.e2e for r in done]
    return {
        "n_requests": len(done),
        "total_tokens": total_tok,
        "tokens_per_s": total_tok / max(wall, 1e-9),
        "ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
        "ttft_p99_ms": float(np.percentile(ttft, 99)) * 1e3,
        "tpot_p50_ms": (float(np.percentile(tpot, 50)) * 1e3) if tpot else 0.0,
        "e2e_p50_s": float(np.percentile(e2e, 50)),
        "e2e_p99_s": float(np.percentile(e2e, 99)),
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_scheduler(
    model, params, requests: List[ServeRequest], *,
    slots: int, pad_to: int, max_new_cap: int, device,
    eos_id: Optional[int] = None, policy: str = "continuous",
    return_requests: bool = False,
):
    """Serve one trace; returns metrics (plus the scheduler's counters)."""
    device = torch.device(device)
    sched = Scheduler(
        model, params, slots=slots, pad_to=pad_to, max_new_cap=max_new_cap,
        device=device, eos_id=eos_id, policy=policy,
    )
    _sync(device)
    t0 = time.perf_counter()
    done = sched.run(requests)
    _sync(device)
    wall = time.perf_counter() - t0
    m = serve_metrics(done, wall)
    stalls = np.asarray(sched.admission_stalls, np.float64)
    m.update(
        wall_s=wall,
        decode_steps=sched.n_decode_steps,
        prefills=sched.n_prefills,
        mean_slot_occupancy=sched.mean_occupancy,
        kv_reserved_bytes=sched.pool.reserved_bytes,
        n_admission_stalls=len(stalls),
        admission_stall_p50_ms=(
            float(np.percentile(stalls, 50)) * 1e3 if len(stalls) else 0.0
        ),
        admission_stall_max_ms=float(stalls.max()) * 1e3 if len(stalls) else 0.0,
        device=str(device),
    )
    if return_requests:
        return m, done
    return m


def warmup(model, params, *, slots: int, pad_to: int, max_new_cap: int, device) -> None:
    """Run two tiny requests through a throwaway scheduler before any timed
    run: builds and loads the kernel library on the card, and brings up
    the matmul libraries, at the serving shapes."""
    sched = Scheduler(model, params, slots=slots, pad_to=pad_to,
                      max_new_cap=max_new_cap, device=device)
    rng = np.random.default_rng(0)
    sched.run([
        ServeRequest(rid=0, prompt=rng.integers(0, 8, size=pad_to), max_new=2),
        ServeRequest(rid=1, prompt=rng.integers(0, 8, size=3), max_new=2),
    ])
    _sync(torch.device(device))


def resolve_device(name: str) -> torch.device:
    """``cuda`` unless the caller asked for the CPU; a missing card raises
    instead of falling back."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda: no CUDA device is available (pass --device cpu to run "
            "the plain PyTorch path on the CPU)"
        )
    return dev


def build_model(arch: str, *, smoke: bool, seed: int, device):
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    model = get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.inference_mode():
        params = model.init(gen, device)
    return cfg, model, params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--n-requests", type=int, default=8)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--policy", choices=["continuous", "fixed"], default="continuous")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="Poisson arrivals per second; 0 = all at t=0")
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the random weights and the trace")
    ap.add_argument("--profile", default="llama_humaneval",
                    choices=sorted(data_mod.PAPER_PROFILES))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises when there is no card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg, model, params = build_model(args.arch, smoke=args.smoke, seed=args.seed,
                                     device=device)
    prof = data_mod.PAPER_PROFILES[args.profile]
    pad_to = trace_pad_to(prof, args.n_requests, args.seed)
    reqs = poisson_trace(
        prof, args.n_requests, pad_to=pad_to, max_new_cap=args.max_new,
        vocab_size=cfg.vocab_size, arrival_rate=args.arrival_rate, seed=args.seed,
    )
    warmup(model, params, slots=args.batch_slots, pad_to=pad_to,
           max_new_cap=args.max_new, device=device)
    m = run_scheduler(
        model, params, reqs, slots=args.batch_slots, pad_to=pad_to,
        max_new_cap=args.max_new, device=device, eos_id=args.eos_id,
        policy=args.policy,
    )
    mode = args.policy
    print(f"[serve/{mode}] {m['n_requests']} requests in "
          f"{m['wall_s']:.2f}s | {m['tokens_per_s']:.1f} tok/s | "
          f"occupancy={m['mean_slot_occupancy']:.2f} | "
          f"ttft p50={m['ttft_p50_ms']:.0f}ms p99={m['ttft_p99_ms']:.0f}ms | "
          f"tpot p50={m['tpot_p50_ms']:.1f}ms | "
          f"e2e p50={m['e2e_p50_s']:.2f}s p99={m['e2e_p99_s']:.2f}s | "
          f"stall p50={m['admission_stall_p50_ms']:.1f}ms "
          f"max={m['admission_stall_max_ms']:.1f}ms | "
          f"kv reserved={m['kv_reserved_bytes'] / 1e6:.1f}MB")
    return m


if __name__ == "__main__":
    main()
