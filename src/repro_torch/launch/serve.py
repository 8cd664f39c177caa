"""Serving launcher of the port: continuous-batching request serving over
the KV pools (``core/slot_pool.py`` + ``core/scheduler.py``).

ONE batch-1 prefill admits requests into free slots, ONE pool-wide decode
step runs every step, and the scheduler recycles a slot the moment its
request finishes. ``--policy fixed`` degrades the same machinery to
run-to-completion batches for A/B comparison. ``--paged`` serves from the
paged block pool (``--block-size``, ``--num-blocks``; back-pressure by
preemption), and ``--chunked`` (with ``--paged``) streams each admitted
prompt into its blocks ``--prefill-budget`` tokens per mixed step instead
of a prefill. ``--temperature`` / ``--top-p`` sample every request under
its own per-(request, token index) keys, and ``--profile-mix speculative``
serves the requests through LayerSkip draft/verify windows (``--exit-layer``,
``--n-draft``) with the same tokens. Weights are random, drawn from a
``torch.Generator`` seeded with ``--seed``; on the card the model's kernels
(attention and RMSNorm for ``llama3.2-1b``, the SSD scan and RMSNorm for
``mamba2-130m``) are the hand-written CUDA ones.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --smoke --device cpu --n-requests 8 --batch-slots 4 --max-new 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --smoke --device cpu --paged --chunked --block-size 16 --num-blocks 14 \
      --prefill-budget 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --profile-mix speculative --exit-layer 8 --n-draft 4 --temperature 0.8 \
      --top-p 0.9

Reported per request: TTFT (arrival -> first token), TPOT (mean inter-
token), e2e latency; aggregate: tokens/s, mean slot-occupancy and the
decode-stall-per-admission metric (the inter-step gap an admission's
prefill sat inside). Paged runs add block occupancy, preemptions and the
KV bytes reserved against the peak bytes used; chunked runs the mixed
steps and chunk counts; speculative runs the draft/verify steps, the
acceptance and the tokens committed a slot-step.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import profiles
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
    temperature: float = 0.0,
    top_p: float = 1.0,
) -> List[ServeRequest]:
    """Requests with paper-profile lengths and Poisson (exponential
    inter-arrival) arrival offsets; rate <= 0 means all arrive at t=0.
    Draws the same prompts and lengths as the JAX launcher's trace; every
    request samples at ``temperature`` / ``top_p``."""
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
                temperature=temperature,
                top_p=top_p,
            )
        )
    return reqs


def apply_profile_mix(requests: List[ServeRequest], mix: str, *, exit_layer: int = 1,
                      n_draft: int = 4) -> List[ServeRequest]:
    """Cycle decoding kinds over a trace, round-robin by request order (a
    comma list, so A/B arms see identical work): ``greedy`` (temperature 0,
    no profile), ``sampling`` (the request's own temperature and top-p, no
    profile) and ``speculative`` (a ``SpeculativeProfile`` at the request's
    temperature and top-p: draft/verify windows give the plain tokens, so
    the mix changes only how many tokens a step commits). ``beam``,
    ``contrastive`` and ``cfg`` need slot groups, a later slice."""
    kinds = [k.strip() for k in mix.split(",") if k.strip()]
    for i, r in enumerate(requests):
        kind = kinds[i % len(kinds)]
        if kind == "greedy":
            r.profile, r.temperature, r.top_p = None, 0.0, 1.0
        elif kind == "sampling":
            r.profile = None
        elif kind == "speculative":
            r.profile = profiles.SpeculativeProfile(
                temperature=r.temperature, top_p=r.top_p, eos_id=r.eos_id,
                exit_layer=exit_layer, n_draft=n_draft)
        elif kind in ("beam", "contrastive", "cfg"):
            raise NotImplementedError(
                f"profile kind {kind!r} needs the scheduler's slot groups: a later slice")
        else:
            raise ValueError(f"unknown profile kind {kind!r}")
    return requests


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
    paged: bool = False, block_size: int = 16, num_blocks: Optional[int] = None,
    chunked: bool = False, prefill_budget: Optional[int] = None,
    return_requests: bool = False,
):
    """Serve one trace; returns metrics (plus the scheduler's counters).
    Paged runs report the bytes the pool keeps reserved against the bytes
    its peak block working set used, and the blocks still owned at the end
    (``leaked_blocks``: 0 once every request finished). Runs with
    speculative steps report them (``spec_*``): the acceptance (accepted
    over drafted tokens), the tokens committed a speculative slot-step and
    the histogram of commits."""
    device = torch.device(device)
    sched = Scheduler(
        model, params, slots=slots, pad_to=pad_to, max_new_cap=max_new_cap,
        device=device, eos_id=eos_id, policy=policy, paged=paged,
        block_size=block_size, num_blocks=num_blocks, chunked=chunked,
        prefill_budget=prefill_budget,
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
    if sched.n_spec_steps:
        m.update(
            spec_steps=sched.n_spec_steps,
            spec_slot_steps=sched.n_spec_slot_steps,
            spec_drafted=sched.n_spec_drafted,
            spec_accepted=sched.n_spec_accepted,
            spec_committed=sched.n_spec_committed,
            spec_acceptance=sched.n_spec_accepted / max(sched.n_spec_drafted, 1),
            # > 1: the draft/verify pair beat one token a step
            spec_tokens_per_step=sched.n_spec_committed / max(sched.n_spec_slot_steps, 1),
            spec_commit_hist={str(k): v for k, v in sorted(sched.spec_commit_hist.items())},
        )
    if paged:
        pool = sched.pool
        token_bytes = pool.reserved_bytes / max(pool.num_blocks * pool.block_size, 1)
        m.update(
            n_preemptions=sched.n_preemptions,
            mean_block_occupancy=sched.mean_block_occupancy,
            peak_used_blocks=sched.peak_used_blocks,
            kv_used_peak_bytes=int(sched.peak_used_blocks * pool.block_size * token_bytes),
            leaked_blocks=pool.n_used_blocks,
        )
    if chunked:
        m.update(
            mixed_steps=sched.n_mixed_steps,
            prefill_chunks=sched.n_chunks,
            prefill_chunk_tokens=sched.n_chunk_tokens,
            full_prefills=sched.n_prefills,  # 0 under chunking
        )
    if return_requests:
        return m, done
    return m


def warmup(model, params, *, slots: int, pad_to: int, max_new_cap: int, device,
           paged: bool = False, block_size: int = 16, num_blocks: Optional[int] = None,
           chunked: bool = False, prefill_budget: Optional[int] = None,
           speculative: bool = False, exit_layer: int = 1, n_draft: int = 4) -> None:
    """Run two tiny requests through a throwaway scheduler of the serving
    geometry before any timed run: builds and loads the kernel library on
    the card, and brings up the matmul libraries, at the serving shapes.
    ``speculative`` adds a sampled speculative request long enough for one
    full draft/verify step at (``exit_layer``, ``n_draft``)."""
    sched = Scheduler(model, params, slots=slots, pad_to=pad_to,
                      max_new_cap=max_new_cap, device=device, paged=paged,
                      block_size=block_size, num_blocks=num_blocks, chunked=chunked,
                      prefill_budget=prefill_budget)
    rng = np.random.default_rng(0)
    reqs = [
        ServeRequest(rid=0, prompt=rng.integers(0, 8, size=pad_to), max_new=2),
        ServeRequest(rid=1, prompt=rng.integers(0, 8, size=3), max_new=2),
    ]
    if speculative:
        reqs.append(ServeRequest(
            rid=2, prompt=rng.integers(0, 8, size=3), max_new=min(n_draft + 2, max_new_cap),
            profile=profiles.SpeculativeProfile(temperature=0.8, top_p=0.9,
                                                exit_layer=exit_layer, n_draft=n_draft)))
    sched.run(reqs)
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
    ap.add_argument("--paged", action="store_true",
                    help="paged KV block-pool instead of per-slot rows")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="physical KV blocks incl. the sink block; default "
                         "= full per-slot parity (no memory saving)")
    ap.add_argument("--chunked", action="store_true",
                    help="chunked prefill (requires --paged): admission "
                         "streams prompts into KV blocks inside the "
                         "pool-wide mixed step instead of stalling it")
    ap.add_argument("--prefill-budget", type=int, default=None,
                    help="prefill tokens per mixed step; default = --block-size")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="Poisson arrivals per second; 0 = all at t=0")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="per-request sampling temperature; 0 = greedy")
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--profile-mix", default=None, metavar="KINDS",
                    help="comma list of decoding kinds cycled over the requests: greedy | "
                         "sampling | speculative (beam / cfg wait for slot groups)")
    ap.add_argument("--exit-layer", type=int, default=1,
                    help="LayerSkip early-exit layer of speculative requests")
    ap.add_argument("--n-draft", type=int, default=4,
                    help="draft tokens a speculative window")
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
        temperature=args.temperature, top_p=args.top_p,
    )
    speculative = False
    if args.profile_mix:
        apply_profile_mix(reqs, args.profile_mix, exit_layer=args.exit_layer,
                          n_draft=args.n_draft)
        speculative = any(r.profile is not None for r in reqs)
    geometry = dict(paged=args.paged, block_size=args.block_size,
                    num_blocks=args.num_blocks, chunked=args.chunked,
                    prefill_budget=args.prefill_budget)
    warmup(model, params, slots=args.batch_slots, pad_to=pad_to,
           max_new_cap=args.max_new, device=device, speculative=speculative,
           exit_layer=args.exit_layer, n_draft=args.n_draft, **geometry)
    m = run_scheduler(
        model, params, reqs, slots=args.batch_slots, pad_to=pad_to,
        max_new_cap=args.max_new, device=device, eos_id=args.eos_id,
        policy=args.policy, **geometry,
    )
    mode = args.policy + ("+chunked" if args.chunked else "+paged" if args.paged else "")
    print(f"[serve/{mode}] {m['n_requests']} requests in "
          f"{m['wall_s']:.2f}s | {m['tokens_per_s']:.1f} tok/s | "
          f"occupancy={m['mean_slot_occupancy']:.2f} | "
          f"ttft p50={m['ttft_p50_ms']:.0f}ms p99={m['ttft_p99_ms']:.0f}ms | "
          f"tpot p50={m['tpot_p50_ms']:.1f}ms | "
          f"e2e p50={m['e2e_p50_s']:.2f}s p99={m['e2e_p99_s']:.2f}s | "
          f"stall p50={m['admission_stall_p50_ms']:.1f}ms "
          f"max={m['admission_stall_max_ms']:.1f}ms | "
          f"kv reserved={m['kv_reserved_bytes'] / 1e6:.1f}MB")
    if args.paged:
        print(f"[serve/{mode}] block occupancy={m['mean_block_occupancy']:.2f} | "
              f"preemptions={m['n_preemptions']} | kv used peak="
              f"{m['kv_used_peak_bytes'] / 1e6:.1f}MB of "
              f"{m['kv_reserved_bytes'] / 1e6:.1f}MB reserved | "
              f"leaked blocks={m['leaked_blocks']}")
    if args.chunked:
        print(f"[serve/{mode}] mixed steps={m['mixed_steps']} of {m['decode_steps']} | "
              f"chunks={m['prefill_chunks']} ({m['prefill_chunk_tokens']} tokens) | "
              f"full prefills={m['full_prefills']}")
    if "spec_steps" in m:
        print(f"[serve/{mode}] spec steps={m['spec_steps']} of {m['decode_steps']} | "
              f"acceptance={m['spec_acceptance']:.2f} | "
              f"tokens/slot-step={m['spec_tokens_per_step']:.2f} | "
              f"commit hist={m['spec_commit_hist']}")
    return m


if __name__ == "__main__":
    main()
