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
its own per-(request, token index) keys. ``--profile-mix`` cycles decoding
kinds over the trace: ``beam`` requests serve as ``--n-beams``-slot groups
(the Obs #4 KV reorder a host table permutation on the paged pool, a row
gather on the contiguous one), ``contrastive`` ones as cond/uncond pairs
(``--guidance``; restricted to the image tokens on a VLM), ``speculative``
ones through LayerSkip draft/verify windows (``--exit-layer``,
``--n-draft``) with the plain tokens. ``--mix-classes`` draws a class per
request instead, with bursty arrivals, and prints each class's latencies.
``--prefix-cache`` (with ``--chunked``) adopts every cached full prompt
block at admission and prefills only the suffix, with the cold tokens;
``--shared-prefix N`` makes the trace for it (N system prompts of
``--prefix-len`` tokens reused Zipf(``--zipf-a``) in bursts of up to
``--burst-size``). ``--replicas N`` serves through N replica pools of
this geometry behind one shared queue (``core/router.py``), every replica
on the one card (or round-robin over the cards when there are several; on
the CPU with ``--device cpu``), and prints the fleet's spills, requeues,
busy-time rate and one line per replica; with ``--tp N`` every replica is
a tensor-parallel pool of N ranks (a DP x TP fleet: N processes, each rank r
of every replica; ``--tp-devices`` names one group of N devices, which the
replicas wrap onto whole), and the fleet prints the KV bytes a device
reserves and each replica's reduces. ``--boost-after S`` ages waiting
requests: one priority a full ``S`` seconds waited. ``--tp N`` serves one pool
as N tensor-parallel ranks (``distributed/tp_pool.py``; the dense, vlm, moe,
mla_moe, ssm, encdec, seamless and hybrid families, bf16 or ``--quant``'d):
N processes, each holding its shard of the params and of the pool (its KV
heads, MLA's whole latent, its SSM heads' state, its self and cross K/V
heads, its RG-LRU channels and its rows of a ring split along them), on
the first N cards, on the cards ``--tp-devices`` lists
(``cuda:0,cuda:0`` puts two ranks on one card) or, with ``--device cpu``,
all on the CPU; rank 0 prints, with the KV bytes each rank reserves, the
reduces the run made and, measured, a forward's. ``--quant wo|dyn``
quantizes every linear of the whole model with one AutoQuant mode
(``quantization.quantize_params``) before any shard is cut. Weights are
random, drawn from a
``torch.Generator`` seeded with ``--seed``; on the card the model's kernels
(attention and RMSNorm for ``llama3.2-1b`` and the MoE models, the latent
attention too for ``deepseek-v2-236b``, the SSD scan and RMSNorm for
``mamba2-130m``, windowed attention and RMSNorm for ``recurrentgemma-2b``,
whose paged pool ``--paged`` refuses) are the hand-written CUDA ones. ``--n-layers`` cuts the
depth of a model too large for one card. An encoder-decoder
(``whisper-base``, ``seamless-m4t``) serves its T2TT path: each request
carries stub encoder frames drawn from ``--seed`` (``attach_frames``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --n-layers 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b --n-layers 3 \
      --paged --chunked --block-size 16 --num-blocks 48 --prefill-budget 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --smoke --device cpu --n-requests 8 --batch-slots 4 --max-new 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --smoke --device cpu --paged --chunked --block-size 16 --num-blocks 14 \
      --prefill-budget 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --profile-mix speculative --exit-layer 8 --n-draft 4 --temperature 0.8 \
      --top-p 0.9
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --smoke --device cpu --profile-mix greedy,beam,contrastive --n-beams 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --smoke --device cpu --paged --chunked --prefix-cache --shared-prefix 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --smoke --device cpu --replicas 2 --boost-after 0.05
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --smoke --device cpu --tp 2 --paged --chunked --num-blocks 40 --prefill-budget 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \
      --smoke --device cpu --tp 2 --paged --chunked --num-blocks 40 --prefill-budget 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --smoke --device cpu --tp 2 --quant dyn
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --tp 2 --tp-devices cuda:0,cuda:0 --paged --chunked --num-blocks 48 \
      --prefill-budget 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --smoke --device cpu --tp 2 --replicas 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --tp 2 --tp-devices cuda:0,cuda:0 --replicas 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b \
      --n-layers 3 --tp 2 --tp-devices cuda:0,cuda:0
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \
      --smoke --device cpu --tp 2 --profile seamless_s2t --profile-mix greedy,beam
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
      --tp 2 --tp-devices cuda:0,cuda:0
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \
      --tp 2 --tp-devices cuda:0,cuda:0

Reported per request: TTFT (arrival -> first token), TPOT (mean inter-
token), e2e latency; aggregate: tokens/s, mean slot-occupancy and the
decode-stall-per-admission metric (the inter-step gap an admission's
prefill sat inside). Paged runs add block occupancy, preemptions and the
KV bytes reserved against the peak bytes used; chunked runs the mixed
steps and chunk counts; speculative runs the draft/verify steps, the
acceptance and the tokens committed a slot-step; runs with groups the
group admissions, row gathers, table permutations and copy-on-write
copies; prefix-cache runs the hits, prompt tokens skipped and cached
blocks; replica runs the fleet's spills, requeues, busy-time rate and
each replica's line; TP runs the backend, the KV bytes a rank reserves
against the whole pool's, the reduces and the forwards.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import engine, prng, profiles, sampling
from repro_torch.core.kv_cache import leaves
from repro_torch.core.scheduler import Scheduler, ServeRequest
from repro_torch.distributed import tp_pool
from repro_torch.models import get_model
from repro_torch.training import data as data_mod


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    t_submit: float = field(default_factory=time.perf_counter)
    t_done: Optional[float] = None
    output: Optional[np.ndarray] = None


class BatchServer:
    """Fixed-slot batcher, the paper's unoptimized baseline: takes up to
    ``slots`` requests, right-pads their prompts and runs prefill and decode
    to completion through ``engine.generate``. A partial batch marks its dead
    rows (``live``), so padding rows neither hold back the EOS exit nor
    emit tokens. Runs on the params' device; batch ``i``'s key is
    ``PRNGKey(requests served before it)``."""

    def __init__(self, model, params, *, slots: int, sampler=None,
                 eos_id: Optional[int] = None):
        self.model = model
        self.params = params
        self.slots = slots
        self.sampler = sampler or sampling.top_p(0.9)
        self.eos_id = eos_id
        self.device = next(leaves(params)).device

    def serve(self, requests: List[Request], *, pad_to: int, max_new: int) -> List[Request]:
        done: List[Request] = []
        queue = list(requests)
        while queue:
            batch, queue = queue[: self.slots], queue[self.slots:]
            prompts = np.zeros((self.slots, pad_to), np.int32)
            lengths = np.ones((self.slots,), np.int32)
            live = np.zeros((self.slots,), bool)
            for i, r in enumerate(batch):
                p = np.asarray(r.prompt, np.int32)[:pad_to]
                prompts[i, : len(p)] = p
                lengths[i] = len(p)
                live[i] = True
            out = engine.generate(
                self.model, self.params, torch.from_numpy(prompts).to(self.device),
                prompt_lengths=torch.from_numpy(lengths).to(self.device),
                max_new_tokens=max_new, sampler=self.sampler, key=prng.PRNGKey(len(done)),
                eos_id=self.eos_id, live=torch.from_numpy(live).to(self.device),
            )
            toks = out["tokens"].cpu().numpy()  # always [slots, max_new]
            for i, r in enumerate(batch):
                r.output = toks[i, : r.max_new]
                r.t_done = time.perf_counter()
                done.append(r)
        return done


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


def _bursty_arrivals(rng: np.random.Generator, arrival_rate: float, burst_size: int):
    """Arrival offsets, one a request, drawn from ``rng`` when asked (so the
    trace's other draws keep their order): exponential gaps between bursts
    of 1..``burst_size`` requests 1 ms apart, the long-run rate
    ``arrival_rate``; rate <= 0: all at t=0."""
    t, burst_left = 0.0, 0
    while True:
        if arrival_rate <= 0:
            yield 0.0
            continue
        if burst_left == 0:
            t += rng.exponential(burst_size / arrival_rate)
            burst_left = int(rng.integers(1, burst_size + 1))
        else:
            t += 1e-3
        burst_left -= 1
        yield t


def shared_prefix_trace(
    n_requests: int,
    *,
    n_prefixes: int,
    prefix_len: int,
    pad_to: int,
    max_new_cap: int,
    vocab_size: int,
    arrival_rate: float,
    zipf_a: float = 1.1,
    burst_size: int = 4,
    seed: int = 0,
    temperature: float = 0.0,
    top_p: float = 1.0,
) -> List[ServeRequest]:
    """Shared-system-prompt traffic, the prefix cache's workload (the
    reference's trace, draw for draw): ``n_prefixes`` system prompts of
    ``prefix_len`` tokens, prompt rank ``r`` drawn with probability
    ``r**-zipf_a`` (normalised), each followed by a fresh random suffix of
    1..(pad_to - prefix_len) tokens, arriving in bursts
    (``_bursty_arrivals``)."""
    if not 0 < prefix_len < pad_to:
        raise ValueError("need 0 < prefix_len < pad_to")
    if n_prefixes < 1 or n_requests < 1:
        raise ValueError("need n_prefixes >= 1 and n_requests >= 1")
    rng = np.random.default_rng(seed)
    prefixes = rng.integers(0, vocab_size, size=(n_prefixes, prefix_len))
    ranks = np.arange(1, n_prefixes + 1, dtype=np.float64)
    pmf = ranks ** -zipf_a
    pmf /= pmf.sum()
    max_suffix = pad_to - prefix_len
    arrivals = _bursty_arrivals(rng, arrival_rate, burst_size)
    reqs: List[ServeRequest] = []
    for i in range(n_requests):
        t = next(arrivals)
        j = int(rng.choice(n_prefixes, p=pmf))
        suffix = rng.integers(0, vocab_size, size=int(rng.integers(1, max_suffix + 1)))
        reqs.append(ServeRequest(
            rid=i, prompt=np.concatenate([prefixes[j], suffix]),
            max_new=int(rng.integers(1, max_new_cap + 1)), t_arrival=t,
            temperature=temperature, top_p=top_p,
        ))
    return reqs


def _group_profile(kind: str, *, n_beams: int, beam_eos_id: int, guidance: float,
                   uncond_token: int, mask_offset: Optional[int]):
    if kind == "beam":
        return profiles.BeamProfile(n_beams=n_beams, eos_id=beam_eos_id)
    return profiles.ContrastiveProfile(uncond_token=uncond_token, guidance=guidance,
                                       mask_offset=mask_offset)


def apply_profile_mix(
    requests: List[ServeRequest],
    mix: str,
    *,
    n_beams: int = 2,
    beam_eos_id: int = 2,
    guidance: float = 2.0,
    uncond_token: int = 0,
    mask_offset: Optional[int] = None,
    exit_layer: int = 1,
    n_draft: int = 4,
) -> List[ServeRequest]:
    """Cycle decoding profiles over a trace, round-robin by request order
    (a comma list of kinds, so A/B arms see identical work): ``greedy``
    leaves the request on the per-slot sampling path at its own
    temperature; ``beam`` a ``BeamProfile`` slot group; ``contrastive`` a
    ``ContrastiveProfile`` pair; ``speculative`` a ``SpeculativeProfile`` at
    the request's own temperature and top-p (draft/verify windows give the
    plain tokens, so the mix moves only how many tokens a step commits)."""
    kinds = [k.strip() for k in mix.split(",") if k.strip()]
    for i, r in enumerate(requests):
        kind = kinds[i % len(kinds)]
        if kind == "greedy":
            r.profile = None
        elif kind in ("beam", "contrastive"):
            r.profile = _group_profile(kind, n_beams=n_beams, beam_eos_id=beam_eos_id,
                                       guidance=guidance, uncond_token=uncond_token,
                                       mask_offset=mask_offset)
        elif kind == "speculative":
            r.profile = profiles.SpeculativeProfile(
                temperature=r.temperature, top_p=r.top_p, eos_id=r.eos_id,
                exit_layer=exit_layer, n_draft=n_draft)
        else:
            raise ValueError(f"unknown profile kind {kind!r}")
    return requests


MIX_CLASSES = ("greedy", "sampling", "beam", "cfg", "speculative")


def mix_class_trace(
    profile: data_mod.LengthProfile,
    n_requests: int,
    *,
    pad_to: int,
    max_new_cap: int,
    vocab_size: int,
    arrival_rate: float,
    classes: Sequence[str] = MIX_CLASSES,
    burst_size: int = 4,
    seed: int = 0,
    temperature: float = 0.8,
    top_p: float = 0.9,
    n_beams: int = 2,
    beam_eos_id: int = 2,
    guidance: float = 2.0,
    uncond_token: int = 0,
    mask_offset: Optional[int] = None,
    exit_layer: int = 1,
    n_draft: int = 4,
) -> List[ServeRequest]:
    """A heterogeneous trace (the reference's, draw for draw): every request
    draws a class at random from ``classes``: ``greedy`` (t = 0),
    ``sampling`` (``temperature`` / ``top_p``), ``beam``, ``cfg`` (a
    contrastive pair; ``contrastive`` is its alias) or ``speculative``,
    arriving in bursts (``_bursty_arrivals``). The workload of
    ``serve_metrics``' per-class TTFT/TPOT rows."""
    known = {"greedy", "sampling", "beam", "cfg", "contrastive", "speculative"}
    classes = [c.strip() for c in classes if c.strip()]
    for c in classes:
        if c not in known:
            raise ValueError(f"unknown request class {c!r}")
    if not classes:
        raise ValueError("need at least one request class")
    rng = np.random.default_rng(seed)
    ins, outs = data_mod.sample_lengths(profile, n_requests, seed=seed + 1)
    arrivals = _bursty_arrivals(rng, arrival_rate, burst_size)
    reqs: List[ServeRequest] = []
    for i in range(n_requests):
        t = next(arrivals)
        cls = classes[int(rng.integers(0, len(classes)))]
        r = ServeRequest(
            rid=i, prompt=rng.integers(0, vocab_size, size=min(int(ins[i]), pad_to)),
            max_new=max(1, min(int(outs[i]), max_new_cap)), t_arrival=t,
            temperature=temperature if cls == "sampling" else 0.0,
            top_p=top_p if cls == "sampling" else 1.0,
        )
        if cls in ("beam", "cfg", "contrastive"):
            r.profile = _group_profile("beam" if cls == "beam" else "contrastive",
                                       n_beams=n_beams, beam_eos_id=beam_eos_id,
                                       guidance=guidance, uncond_token=uncond_token,
                                       mask_offset=mask_offset)
        elif cls == "speculative":
            r.profile = profiles.SpeculativeProfile(
                temperature=r.temperature, top_p=r.top_p, exit_layer=exit_layer,
                n_draft=n_draft)
        reqs.append(r)
    return reqs


def attach_frames(reqs: List[ServeRequest], cfg, seed: int) -> List[ServeRequest]:
    """Give each request of an encoder-decoder ``cfg`` its stub encoder
    input, as ``extra_inputs``: frames [1, F, d] drawn N(0, 1) from
    ``seed`` in the params' type, and a frame length from ``seamless_s2t``'s
    input lengths (seed + 2) clipped to the F frames. Returns ``reqs``."""
    from repro_torch.models import layers as L

    f = cfg.encdec.n_frames
    rng = np.random.default_rng(seed + 1)
    ins, _ = data_mod.sample_lengths(data_mod.PAPER_PROFILES["seamless_s2t"], len(reqs),
                                     seed=seed + 2)
    for r, n in zip(reqs, ins):
        frames = rng.standard_normal((1, f, cfg.d_model), dtype=np.float32)
        r.extra_inputs = {"frames": torch.from_numpy(frames).to(L.param_dtype(cfg)),
                          "frame_lengths": np.asarray([min(int(n), f)], np.int32)}
    return reqs


def trace_pad_to(profile: data_mod.LengthProfile, n_requests: int, seed: int) -> int:
    """The launcher's prompt pad: the longest sampled prompt, capped at 256."""
    ins, _ = data_mod.sample_lengths(profile, n_requests, seed=seed + 1)
    return int(min(max(ins), 256))


def request_class(r: ServeRequest) -> str:
    """A request's class for the per-class latency rows: ``beam`` /
    ``contrastive`` (slot groups), ``speculative``, else ``greedy`` or
    ``sampling`` by temperature."""
    p = r.profile
    if isinstance(p, profiles.SpeculativeProfile):
        return "speculative"
    if p is not None and profiles.n_streams_of(p) > 1:
        return type(p).__name__.replace("Profile", "").lower()
    return "greedy" if r.temperature <= 0.0 else "sampling"


def _p(xs, q: float) -> float:
    return float(np.percentile(xs, q)) * 1e3 if xs else 0.0


def serve_metrics(done: List[ServeRequest], wall: float) -> Dict[str, object]:
    total_tok = sum(len(r.tokens) for r in done)
    ttft = [r.ttft for r in done]
    tpot = [r.tpot for r in done if len(r.tokens) > 1]
    e2e = [r.e2e for r in done]
    per_class: Dict[str, Dict[str, float]] = {}
    for cls in sorted({request_class(r) for r in done}):
        rs = [r for r in done if request_class(r) == cls]
        c_ttft = [r.ttft for r in rs]
        c_tpot = [r.tpot for r in rs if len(r.tokens) > 1]
        per_class[cls] = {"n_requests": len(rs),
                          "ttft_p50_ms": _p(c_ttft, 50), "ttft_p99_ms": _p(c_ttft, 99),
                          "tpot_p50_ms": _p(c_tpot, 50), "tpot_p99_ms": _p(c_tpot, 99)}
    return {
        "n_requests": len(done),
        "total_tokens": total_tok,
        "tokens_per_s": total_tok / max(wall, 1e-9),
        "ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
        "ttft_p99_ms": float(np.percentile(ttft, 99)) * 1e3,
        "tpot_p50_ms": (float(np.percentile(tpot, 50)) * 1e3) if tpot else 0.0,
        "e2e_p50_s": float(np.percentile(e2e, 50)),
        "e2e_p99_s": float(np.percentile(e2e, 99)),
        "per_class": per_class,
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
    prefix_cache: bool = False, priority_boost_after: Optional[float] = None,
    seed: int = 0, replicas: Optional[int] = None, devices="auto",
    return_requests: bool = False, tp=None, group=None,
):
    """Serve one trace under the serve key ``PRNGKey(seed)``; returns
    metrics (plus the scheduler's counters). Paged runs report the bytes
    the pool keeps reserved against the bytes its peak block working set
    used, and the blocks still owned at the end (``leaked_blocks``: 0 once
    every request finished; the prefix cache's blocks are not owned).
    Runs with speculative steps report them (``spec_*``): the acceptance
    (accepted over drafted tokens), the tokens committed a speculative
    slot-step and the histogram of commits; runs with slot groups their
    admissions, row gathers and table permutations (and, paged, the
    copy-on-write copies); prefix-cache runs the trie's counters; aged runs
    the boosts granted. ``replicas=N`` serves through a ``ReplicaRouter`` of
    N pools of this geometry (``_run_router``; on a CPU ``device`` every
    replica is on the CPU, else ``devices`` places them). ``tp`` (a rank's
    ``TPContext``; ``device`` None) serves as that rank of a tensor-parallel
    pool, every rank calling with the same trace: the metrics are the same
    on every rank, and add ``kv_reserved_per_device_bytes`` (the largest
    rank's pool; ``kv_reserved_bytes`` is the whole pool's), the backend, the
    reduces the run made and their host seconds. With ``replicas``, ``tp``
    is the reference's degree instead (an int): a DP x TP fleet whose every
    replica is a tensor-parallel pool of ``tp`` ranks, this process rank
    ``group.rank`` of each (``group``: its ``TPGroup``; ``model`` and
    ``params`` the whole model's; ``_run_router``)."""
    if replicas is not None:
        device = torch.device(device)
        if isinstance(devices, str) and devices == "auto" and device.type != "cuda":
            devices = ([device] * replicas if tp is None or tp <= 1
                       else [(device,) * tp] * replicas)
        return _run_router(
            model, params, requests, replicas=replicas, devices=devices, slots=slots,
            pad_to=pad_to, max_new_cap=max_new_cap, eos_id=eos_id, policy=policy,
            paged=paged, block_size=block_size, num_blocks=num_blocks, chunked=chunked,
            prefill_budget=prefill_budget, prefix_cache=prefix_cache,
            priority_boost_after=priority_boost_after, seed=seed, tp=tp, group=group,
            return_requests=return_requests,
        )
    if tp is not None:
        device = tp.device
    device = torch.device(device)
    sched = Scheduler(
        model, params, slots=slots, pad_to=pad_to, max_new_cap=max_new_cap,
        device=None if tp is not None else device, eos_id=eos_id, policy=policy, paged=paged,
        block_size=block_size, num_blocks=num_blocks, chunked=chunked,
        prefill_budget=prefill_budget, prefix_cache=prefix_cache,
        priority_boost_after=priority_boost_after, base_key=prng.PRNGKey(seed), tp=tp,
    )
    if tp is not None:
        n_red0, red_s0 = tp.group.n_reduces, tp.group.reduce_s
    _sync(device)
    t0 = time.perf_counter()
    done = sched.run(requests)
    _sync(device)
    wall = time.perf_counter() - t0
    m = serve_metrics(done, wall)
    stalls = np.asarray(sched.admission_stalls, np.float64)
    # a TP rank's pool holds its KV heads: the whole pool's bytes count them all
    reserved = sched.pool.reserved_bytes if tp is None else tp.whole_bytes(sched.pool.cache)
    m.update(
        wall_s=wall,
        decode_steps=sched.n_decode_steps,
        prefills=sched.n_prefills,
        mean_slot_occupancy=sched.mean_occupancy,
        kv_reserved_bytes=reserved,
        n_admission_stalls=len(stalls),
        admission_stall_p50_ms=(
            float(np.percentile(stalls, 50)) * 1e3 if len(stalls) else 0.0
        ),
        admission_stall_max_ms=float(stalls.max()) * 1e3 if len(stalls) else 0.0,
        device=str(device),
    )
    if sched.n_group_admissions:
        m.update(
            group_admissions=sched.n_group_admissions,
            cache_reorders=sched.n_cache_reorders,  # contiguous: row gathers
            block_permutes=sched.n_block_permutes,  # paged: table permutations
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
        token_bytes = reserved / max(pool.num_blocks * pool.block_size, 1)
        m.update(
            n_preemptions=sched.n_preemptions,
            mean_block_occupancy=sched.mean_block_occupancy,
            peak_used_blocks=sched.peak_used_blocks,
            kv_used_peak_bytes=int(sched.peak_used_blocks * pool.block_size * token_bytes),
            leaked_blocks=pool.n_used_blocks - pool.n_cached_blocks,
        )
        if sched.n_group_admissions:
            m.update(cow_copies=pool.n_cow_copies)
    if chunked:
        m.update(
            mixed_steps=sched.n_mixed_steps,
            prefill_chunks=sched.n_chunks,
            prefill_chunk_tokens=sched.n_chunk_tokens,
            # 0 under chunking, but for slot groups' (dense) prefills
            full_prefills=sched.n_prefills,
        )
    if prefix_cache:
        m.update(
            prefix_lookups=sched.n_prefix_lookups,
            prefix_hits=sched.n_prefix_hits,
            prefix_hit_rate=sched.prefix_hit_rate,
            prefill_tokens_skipped=sched.n_prefix_tokens_skipped,
            prefix_blocks_reclaimed=sched.n_prefix_reclaimed,
            mean_cached_blocks=sched.mean_cached_blocks,
        )
    if priority_boost_after is not None:
        m.update(priority_boosts=sched.n_priority_boosts)
    if tp is not None:
        m.update(
            tp=tp.size, backend=tp.group.backend,
            kv_reserved_per_device_bytes=tp_pool.max_per_device_bytes(sched.pool.cache,
                                                                      tp.group),
            param_bytes_per_device=tp_pool.max_per_device_bytes(tp.params, tp.group),
            reduces=tp.group.n_reduces - n_red0, reduce_s=tp.group.reduce_s - red_s0,
            # a prefill or a pool-wide step is one forward (a speculative
            # step adds its draft window's)
            forwards=sched.n_prefills + sched.n_decode_steps,
        )
    if return_requests:
        return m, done
    return m


def _run_router(
    model, params, requests: List[ServeRequest], *, replicas: int, devices, slots: int,
    pad_to: int, max_new_cap: int, eos_id: Optional[int], policy: str, paged: bool,
    block_size: int, num_blocks: Optional[int], chunked: bool,
    prefill_budget: Optional[int], prefix_cache: bool,
    priority_boost_after: Optional[float], seed: int, tp: Optional[int] = None,
    group=None, return_requests: bool = False,
):
    """``run_scheduler`` through a ``ReplicaRouter``: one shared queue over
    N pools (core/router.py). ``tokens_per_s`` is the wall rate of the
    replicas sharing this host (and, on one card, its stream);
    ``aggregate_tokens_per_s`` is the tokens over the busiest replica's own
    seconds (``busy_max_s``), the rate a fleet with a card a replica would
    serve at, emulated, not measured. A DP x TP fleet (``tp > 1``, this
    rank's ``group``) adds ``tp``, the backend, the largest replica's KV and
    param bytes a rank (``kv_reserved_per_device_bytes``,
    ``param_bytes_per_device``; ``kv_reserved_bytes`` stays the fleet's
    pools counted whole) and each replica's reduces and their host seconds
    (``per_replica``)."""
    from repro_torch.core.router import ReplicaRouter

    if policy != "continuous":
        raise ValueError("replica routing requires policy='continuous'")
    router = ReplicaRouter(
        model, params, replicas=replicas, devices=devices, slots=slots, pad_to=pad_to,
        max_new_cap=max_new_cap, eos_id=eos_id, paged=paged, block_size=block_size,
        num_blocks=num_blocks, chunked=chunked, prefill_budget=prefill_budget,
        prefix_cache=prefix_cache, priority_boost_after=priority_boost_after,
        base_key=prng.PRNGKey(seed), tp=tp, group=group,
    )
    groups = [s.tp.group for s in router.replicas] if router.tp is not None else []
    reduces0 = [(g.n_reduces, g.reduce_s) for g in groups]
    cards = {s.device for s in router.replicas}
    for dev in cards:
        _sync(dev)
    t0 = time.perf_counter()
    done = router.run(requests)
    for dev in cards:
        _sync(dev)
    wall = time.perf_counter() - t0
    m = serve_metrics(done, wall)
    stalls = np.asarray(router.admission_stalls, np.float64)
    m.update(
        wall_s=wall,
        replicas=replicas,
        decode_steps=router.n_decode_steps,
        steps_max=router.steps_max,
        prefills=router.n_prefills,
        mean_slot_occupancy=router.mean_occupancy,
        kv_reserved_bytes=router.reserved_bytes,
        n_admission_stalls=len(stalls),
        admission_stall_p50_ms=float(np.percentile(stalls, 50)) * 1e3 if len(stalls) else 0.0,
        admission_stall_max_ms=float(stalls.max()) * 1e3 if len(stalls) else 0.0,
        spills=router.n_spills,
        requeues=router.n_requeues,
        busy_max_s=router.busy_max_s,
        aggregate_tokens_per_s=m["total_tokens"] / max(router.busy_max_s, 1e-9),
        per_replica=router.replica_report(done),
        device=",".join(sorted(str(d) for d in cards)),
    )
    if groups:
        # each a collective on its replica's group, every rank in one order
        m.update(
            tp=router.tp, backend=",".join(sorted({g.backend for g in groups})),
            kv_reserved_per_device_bytes=max(
                tp_pool.max_per_device_bytes(s.pool.cache, s.tp.group) for s in router.replicas),
            param_bytes_per_device=max(
                tp_pool.max_per_device_bytes(s.tp.params, s.tp.group) for s in router.replicas),
        )
        for e, g, (n0, s0) in zip(m["per_replica"], groups, reduces0):
            e.update(backend=g.backend, reduces=g.n_reduces - n0, reduce_s=g.reduce_s - s0)
    if paged:
        bo = [s.mean_block_occupancy for s in router.replicas if s.block_occupancy_trace]
        pool0 = router.replicas[0].pool
        token_bytes = router.reserved_bytes / max(
            len(router.replicas) * pool0.num_blocks * pool0.block_size, 1)
        m.update(
            n_preemptions=router.n_preemptions,
            mean_block_occupancy=float(np.mean(bo)) if bo else 0.0,
            peak_used_blocks=sum(s.peak_used_blocks for s in router.replicas),
            kv_used_peak_bytes=int(sum(s.peak_used_blocks * s.pool.block_size * token_bytes
                                       for s in router.replicas)),
            leaked_blocks=sum(s.pool.n_used_blocks - s.pool.n_cached_blocks
                              for s in router.replicas),
        )
    if chunked:
        m.update(
            mixed_steps=router.n_mixed_steps,
            prefill_chunks=sum(s.n_chunks for s in router.replicas),
            prefill_chunk_tokens=sum(s.n_chunk_tokens for s in router.replicas),
            full_prefills=router.n_prefills,
        )
    if prefix_cache:
        m.update(
            prefix_lookups=router.n_prefix_lookups,
            prefix_hits=router.n_prefix_hits,
            prefix_hit_rate=router.prefix_hit_rate,
            prefill_tokens_skipped=router.n_prefix_tokens_skipped,
            prefix_blocks_reclaimed=router.n_prefix_reclaimed,
            mean_cached_blocks=router.mean_cached_blocks,
        )
    if priority_boost_after is not None:
        m.update(priority_boosts=router.n_priority_boosts)
    if return_requests:
        return m, done
    return m


def warmup(model, params, *, slots: int, pad_to: int, max_new_cap: int, device,
           paged: bool = False, block_size: int = 16, num_blocks: Optional[int] = None,
           chunked: bool = False, prefill_budget: Optional[int] = None,
           prefix_cache: bool = False, profile_mix: bool = False, n_beams: int = 2,
           speculative: bool = False, exit_layer: int = 1, n_draft: int = 4,
           tp=None) -> None:
    """Run tiny requests through a throwaway scheduler of the serving
    geometry before any timed run: builds and loads the kernel library on
    the card, and brings up the matmul libraries, at the serving shapes.
    ``profile_mix`` adds a beam group (the beam step, the copy-on-write copy
    or the row gather) and a contrastive pair; ``speculative`` a sampled
    speculative request long enough for one full draft/verify step at
    (``exit_layer``, ``n_draft``); ``prefix_cache`` serves the first prompt
    again, so the second run adopts its blocks. ``tp`` warms a rank of a
    tensor-parallel pool (every rank calls it; ``device`` is then unread)."""
    sched = Scheduler(model, params, slots=slots, pad_to=pad_to,
                      max_new_cap=max_new_cap, device=None if tp is not None else device,
                      paged=paged, block_size=block_size, num_blocks=num_blocks,
                      chunked=chunked, prefill_budget=prefill_budget,
                      prefix_cache=prefix_cache, tp=tp)
    rng = np.random.default_rng(0)
    full_prompt = rng.integers(0, 8, size=pad_to)
    reqs = [
        ServeRequest(rid=0, prompt=full_prompt, max_new=2),
        ServeRequest(rid=1, prompt=rng.integers(0, 8, size=3), max_new=2),
    ]
    if profile_mix and slots >= max(n_beams, 2):
        reqs += [ServeRequest(rid=2, prompt=rng.integers(0, 8, size=3), max_new=2,
                              profile=profiles.BeamProfile(n_beams=n_beams, eos_id=2)),
                 ServeRequest(rid=3, prompt=rng.integers(0, 8, size=3), max_new=2,
                              profile=profiles.ContrastiveProfile(uncond_token=0))]
    if speculative:
        reqs.append(ServeRequest(
            rid=4, prompt=rng.integers(0, 8, size=3), max_new=min(n_draft + 2, max_new_cap),
            profile=profiles.SpeculativeProfile(temperature=0.8, top_p=0.9,
                                                exit_layer=exit_layer, n_draft=n_draft)))
    if model.config.encdec is not None:
        attach_frames(reqs, model.config, 0)
    sched.run(reqs)
    if prefix_cache:  # rid 0's blocks are in the trie now: its twin adopts them
        sched.run([ServeRequest(rid=5, prompt=full_prompt, max_new=2)])
    _sync(sched.device)


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


def build_model(arch: str, *, smoke: bool, seed: int, device, n_layers=None):
    """(config, model, random params from ``seed``) of ``arch``; ``n_layers``
    cuts the depth (the widths stay the published ones)."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    model = get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.inference_mode():
        params = model.init(gen, device)
    return cfg, model, params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the model to its first N layers (published widths kept; "
                         "qwen3-moe-30b-a3b and deepseek-v2-236b fit one card only so)")
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
                         "beam | contrastive | speculative; beam and contrastive requests "
                         "serve as slot groups")
    ap.add_argument("--n-beams", type=int, default=2,
                    help="beams of a beam request (--profile-mix, --mix-classes)")
    ap.add_argument("--guidance", type=float, default=2.0,
                    help="guidance of a contrastive request (--profile-mix, --mix-classes)")
    ap.add_argument("--exit-layer", type=int, default=1,
                    help="LayerSkip early-exit layer of speculative requests")
    ap.add_argument("--n-draft", type=int, default=4,
                    help="draft tokens a speculative window")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="cross-request prefix cache over the KV blocks (requires "
                         "--chunked): cached full prompt blocks are adopted at admission "
                         "and only the suffix is prefilled, with the cold tokens")
    ap.add_argument("--shared-prefix", type=int, default=None, metavar="N",
                    help="shared-system-prompt trace: N prefixes reused Zipf(--zipf-a) "
                         "with bursty arrivals (default: the paper-profile trace)")
    ap.add_argument("--prefix-len", type=int, default=64,
                    help="tokens of a shared prefix (--shared-prefix)")
    ap.add_argument("--zipf-a", type=float, default=1.1,
                    help="Zipf exponent of prefix reuse, p ~ rank**-a (--shared-prefix)")
    ap.add_argument("--burst-size", type=int, default=4,
                    help="most requests an arrival burst (--shared-prefix, --mix-classes)")
    ap.add_argument("--mix-classes", nargs="?", metavar="CLASSES",
                    const=",".join(MIX_CLASSES), default=None,
                    help="heterogeneous trace: every request draws a class from this comma "
                         "list (greedy | sampling | beam | cfg | speculative) with bursty "
                         "arrivals; prints each class's TTFT/TPOT (default: all five)")
    ap.add_argument("--boost-after", type=float, default=None,
                    help="priority aging: +1 priority a full this many seconds a request "
                         "waits unadmitted (default: off)")
    ap.add_argument("--replicas", type=int, default=None,
                    help="data-parallel replica pools behind one shared queue "
                         "(core/router.py), each of --batch-slots slots; on the one card "
                         "(round-robin over several), on the CPU with --device cpu; with "
                         "--tp, each replica a tensor-parallel pool (default: one "
                         "scheduler, no router)")
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the random weights, the trace and the serve key")
    ap.add_argument("--profile", default="llama_humaneval",
                    choices=sorted(data_mod.PAPER_PROFILES))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises when there is no card) or cpu")
    ap.add_argument("--tp", type=int, default=None,
                    help="serve one pool as this many tensor-parallel ranks (the dense, "
                         "vlm, moe, mla_moe, ssm, encdec, seamless and hybrid families): on "
                         "the first that many cards, on --tp-devices, or all on the CPU "
                         "with --device cpu")
    ap.add_argument("--quant", choices=["wo", "dyn"], default=None,
                    help="AutoQuant every linear with this one mode (int8 weight-only or "
                         "dynamic), the whole model before any tensor-parallel shard")
    ap.add_argument("--tp-devices", default=None, metavar="DEVS",
                    help="comma list of the ranks' devices, e.g. cuda:0,cuda:0 (two ranks on "
                         "one card); with --replicas, one group that the replicas wrap onto")
    args = ap.parse_args(argv)
    if args.chunked and not args.paged:
        ap.error("--chunked requires --paged (chunks append into KV blocks)")
    if args.prefix_cache and not args.chunked:
        ap.error("--prefix-cache requires --chunked (the cursor must start at the "
                 "first uncached prompt token)")
    if args.mix_classes and (args.profile_mix or args.shared_prefix):
        ap.error("--mix-classes is its own trace generator; drop --profile-mix / "
                 "--shared-prefix")
    if args.tp is None:
        return _serve(args)
    # refused before any rank starts (the ROADMAP item named)
    tp_pool.check_supported(get_smoke_config(args.arch) if args.smoke else get_config(args.arch),
                            args.tp)
    if args.tp_devices:
        devices = args.tp_devices.split(",")
    else:
        devices = None if resolve_device(args.device).type == "cuda" else [args.device] * args.tp
    return tp_pool.spawn(_serve_rank, args.tp, args, devices=devices)[0]


def _serve_rank(group, args):
    return _serve(args, group)


def fleet_devices(args) -> Optional[list]:
    """A DP x TP fleet's device groups, one ``--tp``-sized tuple a replica:
    ``--tp-devices`` is one group (``cuda:0,cuda:0``: two ranks on one
    card), which the replicas wrap onto whole, as
    ``sharding.replica_devices`` wraps them; on the CPU every rank is
    there; else None (the router's ``auto``: whole groups of the cards)."""
    from repro_torch.distributed import sharding

    if args.tp_devices:
        one = args.tp_devices.split(",")
    elif torch.device(args.device).type != "cuda":
        one = [args.device] * args.tp
    else:
        return None
    return sharding.replica_devices(args.replicas, one, group_size=args.tp)


def _serve(args, group=None):
    """Build, warm and serve per ``args``; with ``group`` as that rank of a
    tensor-parallel pool (with ``--replicas``: of every replica of a DP x TP
    fleet), rank 0 printing. Returns the metrics."""
    device = group.device if group is not None else resolve_device(args.device)
    cfg, model, params = build_model(args.arch, smoke=args.smoke, seed=args.seed,
                                     device=device, n_layers=args.n_layers)
    if args.quant is not None:
        from repro_torch.core import quantization

        with torch.inference_mode():
            params = quantization.quantize_params(params, args.quant)
    tp = None
    if group is not None:  # a fleet's router cuts its replicas' shards from the whole
        tp = tp_pool.TPContext(model, params, group)
        if args.replicas is None:
            model, params = tp.model, tp.params
    prof = data_mod.PAPER_PROFILES[args.profile]
    mask_offset = None
    if cfg.vlm is not None:  # a VLM's contrastive requests draw image tokens
        from repro_torch.models import vlm

        mask_offset = vlm.image_token_offset(cfg)
    beam_eos_id = args.eos_id if args.eos_id is not None else 2
    group_kw = dict(n_beams=args.n_beams, beam_eos_id=beam_eos_id, guidance=args.guidance,
                    mask_offset=mask_offset, exit_layer=args.exit_layer,
                    n_draft=args.n_draft)
    class_kinds = [k.strip() for k in (args.mix_classes or "").split(",") if k.strip()]
    if args.mix_classes:
        pad_to = trace_pad_to(prof, args.n_requests, args.seed)
        reqs = mix_class_trace(
            prof, args.n_requests, pad_to=pad_to, max_new_cap=args.max_new,
            vocab_size=cfg.vocab_size, arrival_rate=args.arrival_rate, classes=class_kinds,
            burst_size=args.burst_size, seed=args.seed,
            temperature=args.temperature if args.temperature > 0 else 0.8,
            top_p=args.top_p if args.top_p < 1.0 else 0.9, **group_kw)
    elif args.shared_prefix is not None:
        pad_to = int(min(args.prefix_len * 2, 256))
        reqs = shared_prefix_trace(
            args.n_requests, n_prefixes=args.shared_prefix, prefix_len=args.prefix_len,
            pad_to=pad_to, max_new_cap=args.max_new, vocab_size=cfg.vocab_size,
            arrival_rate=args.arrival_rate, zipf_a=args.zipf_a,
            burst_size=args.burst_size, seed=args.seed, temperature=args.temperature,
            top_p=args.top_p)
    else:
        pad_to = trace_pad_to(prof, args.n_requests, args.seed)
        reqs = poisson_trace(
            prof, args.n_requests, pad_to=pad_to, max_new_cap=args.max_new,
            vocab_size=cfg.vocab_size, arrival_rate=args.arrival_rate, seed=args.seed,
            temperature=args.temperature, top_p=args.top_p,
        )
    if args.profile_mix:
        apply_profile_mix(reqs, args.profile_mix, **group_kw)
    if cfg.encdec is not None:  # the encoder's stub input: frames a request
        attach_frames(reqs, cfg, args.seed)
    kinds = [k.strip() for k in (args.profile_mix or "").split(",")] + class_kinds
    geometry = dict(paged=args.paged, block_size=args.block_size,
                    num_blocks=args.num_blocks, chunked=args.chunked,
                    prefill_budget=args.prefill_budget, prefix_cache=args.prefix_cache)
    try:
        warmup(model, params, slots=args.batch_slots, pad_to=pad_to,
               max_new_cap=args.max_new, device=device,
               profile_mix=bool({"beam", "contrastive", "cfg"} & set(kinds)),
               n_beams=args.n_beams, speculative="speculative" in kinds,
               exit_layer=args.exit_layer, n_draft=args.n_draft, tp=tp, **geometry)
    except NotImplementedError as e:  # the paged pool refuses the family
        if not args.paged:
            raise
        raise SystemExit(f"--paged: {e}") from e
    run_kw = dict(tp=tp)
    if tp is not None and args.replicas is not None:
        tp = None  # the warm-up's shard goes: the router cuts each replica's own
        run_kw = dict(tp=args.tp, group=group, devices=fleet_devices(args) or "auto")
    m = run_scheduler(
        model, params, reqs, slots=args.batch_slots, pad_to=pad_to,
        max_new_cap=args.max_new, device=device, eos_id=args.eos_id,
        policy=args.policy, priority_boost_after=args.boost_after, seed=args.seed,
        replicas=args.replicas, **run_kw, **geometry,
    )
    if group is not None and group.rank != 0:
        return m
    mode = args.policy + ("+chunked" if args.chunked else "+paged" if args.paged else "") + (
        "+pfx" if args.prefix_cache else "") + ("+mix" if args.profile_mix else "") + (
        "+classes" if args.mix_classes else "") + (
        f"+x{args.replicas}" if args.replicas is not None else "") + (
        f"+tp{args.tp}" if args.tp is not None else "")
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
    if "group_admissions" in m:
        print(f"[serve/{mode}] slot groups={m['group_admissions']} | "
              f"cache reorders={m['cache_reorders']} | block permutes={m['block_permutes']}"
              + (f" | cow copies={m['cow_copies']}" if "cow_copies" in m else ""))
    if args.prefix_cache:
        print(f"[serve/{mode}] prefix hits={m['prefix_hits']}/{m['prefix_lookups']} "
              f"(rate={m['prefix_hit_rate']:.2f}) | prefill tokens skipped="
              f"{m['prefill_tokens_skipped']} | cached blocks mean="
              f"{m['mean_cached_blocks']:.1f} | reclaimed={m['prefix_blocks_reclaimed']}")
    if args.mix_classes or args.profile_mix:
        for cls, row in m["per_class"].items():
            print(f"[serve/{mode}]   class {cls}: {row['n_requests']} reqs | "
                  f"ttft p50={row['ttft_p50_ms']:.0f}ms p99={row['ttft_p99_ms']:.0f}ms | "
                  f"tpot p50={row['tpot_p50_ms']:.1f}ms p99={row['tpot_p99_ms']:.1f}ms")
    if args.boost_after is not None:
        print(f"[serve/{mode}] priority boosts={m['priority_boosts']}")
    if "tp" in m and args.replicas is None:
        print(f"[serve/{mode}] tp={m['tp']} on {args.tp_devices or device} ({m['backend']}) | "
              f"kv reserved/rank={m['kv_reserved_per_device_bytes'] / 1e6:.1f}MB of "
              f"{m['kv_reserved_bytes'] / 1e6:.1f}MB "
              f"({m['kv_reserved_per_device_bytes'] / m['kv_reserved_bytes']:.3f}x) | "
              f"params/rank={m['param_bytes_per_device'] / 1e6:.1f}MB | reduces="
              f"{m['reduces']} ({m['reduce_s'] * 1e3:.1f} ms host) over {m['forwards']} "
              f"forwards" + ("" if "spec_steps" in m else
                             f", {m['reduces'] / m['forwards']:g} a forward"))
    if args.replicas is not None:
        if "tp" in m:  # the reference's line, with the rank's params and backend
            print(f"[serve/{mode}] tp={m['tp']} | kv reserved/device="
                  f"{m['kv_reserved_per_device_bytes'] / 1e6:.1f}MB (pool "
                  f"{m['kv_reserved_bytes'] / 1e6:.1f}MB logical) | params/device="
                  f"{m['param_bytes_per_device'] / 1e6:.1f}MB | {m['backend']}")
        print(f"[serve/{mode}] spills={m['spills']} | requeues={m['requeues']} | "
              f"steps max={m['steps_max']} | aggregate={m['aggregate_tokens_per_s']:.1f} "
              f"tok/s over busy max={m['busy_max_s']:.2f}s (a card a replica, emulated; "
              f"the wall tok/s above is the replicas sharing {m['device']})")
        for e in m["per_replica"]:
            print(f"[serve/{mode}]   replica {e['replica']}: {e['n_requests']} reqs | "
                  f"steps={e['decode_steps']} | prefills={e['prefills']} | "
                  f"preempt={e['preemptions']} | busy={e['busy_s']:.2f}s | "
                  f"occ={e['mean_slot_occupancy']:.2f} | ttft p50={e['ttft_p50_ms']:.0f}ms | "
                  f"tpot p50={e['tpot_p50_ms']:.1f}ms"
                  + (f" | on {e['device']} | reduces={e['reduces']} "
                     f"({e['reduce_s'] * 1e3:.1f} ms host)" if "reduces" in e else ""))
    return m


if __name__ == "__main__":
    main()
