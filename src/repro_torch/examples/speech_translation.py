"""Seamless-profile example, the reference's ``examples/speech_translation.py``
on the port: batched speech-to-text translation (S-T) with the whisper-base
backbone (a stubbed conv frontend, the real encoder and decoder, beam search
with the KV reorder in place), first batch-at-a-time, then served: the same
requests as beam slot groups through the continuous-batching pool (each
request's encoder frames ride admission into its own cross-attention cache
rows). Then speech-to-speech (S-S) on seamless-m4t: beam-decoded text, one
T2U forward and one vocoder forward, and the same text served as beam
groups. Both on their smoke configs in f32.

  PYTHONPATH=src python -m repro_torch.examples.speech_translation [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core import engine, profiles
from repro_torch.core.scheduler import Scheduler, ServeRequest
from repro_torch.examples import smoke_model
from repro_torch.launch.serve import resolve_device
from repro_torch.models import seamless
from repro_torch.training import data

BATCH, N_BEAMS, MAX_NEW, BOS, EOS = 4, 4, 16, 1, 2


def inputs_for(cfg, device, batch: int = BATCH):
    """Stub frontend: "audio" as frame embeddings from numpy seed 1, and
    frame lengths from the paper's Fleurs profile (seed 2)."""
    prof = data.PAPER_PROFILES["seamless_s2t"]
    ins, _ = data.sample_lengths(prof, batch, seed=2)
    frames = np.random.default_rng(1).standard_normal(
        (batch, cfg.encdec.n_frames, cfg.d_model)).astype(np.float32)
    lengths = np.minimum(ins, cfg.encdec.n_frames).astype(np.int32)
    return torch.from_numpy(frames).to(device), torch.from_numpy(lengths).to(device)


def served_beams(model, params, device, frames, frame_lengths, batch_tokens, tag):
    """The requests as beam slot groups through the scheduler; each
    request's tokens against the batch run's."""
    reqs = [ServeRequest(rid=b, prompt=np.asarray([BOS]), max_new=MAX_NEW,
                         profile=profiles.BeamProfile(n_beams=N_BEAMS, eos_id=EOS),
                         extra_inputs={"frames": frames[b:b + 1].cpu().numpy(),
                                       "frame_lengths": frame_lengths[b:b + 1].cpu().numpy()})
            for b in range(frames.shape[0])]
    sched = Scheduler(model, params, slots=2 * N_BEAMS, pad_to=4, max_new_cap=MAX_NEW,
                      device=device)
    t0 = time.perf_counter()
    done = sorted(sched.run(reqs), key=lambda r: r.rid)
    dt = time.perf_counter() - t0
    print(f"{tag} served (beam groups in the pool): {dt:.2f}s | "
          f"occupancy={sched.mean_occupancy:.2f} | KV reorders={sched.n_cache_reorders}")
    matches = []
    for r in done:
        want = batch_tokens[r.rid].cpu().numpy()[: len(r.tokens)]
        matches.append(bool(np.array_equal(np.asarray(r.tokens), want)))
        print(f"  hyp[{r.rid}] score={r.score:.2f} ttft={r.ttft * 1e3:.0f}ms "
              f"matches-batch={matches[-1]}")
    return [r.tokens for r in done], matches


def run_st(model, params, device, frames=None, frame_lengths=None) -> Dict[str, Any]:
    """S-T: beam search batch-at-a-time, then served; returns both."""
    cfg = model.config
    if frames is None:
        frames, frame_lengths = inputs_for(cfg, device)
    frames = frames.to(device).to(params["embed"]["table"].dtype)
    frame_lengths = frame_lengths.to(device)
    prof = data.PAPER_PROFILES["seamless_s2t"]
    print(f"S-T batch={frames.shape[0]}, frame lengths={frame_lengths.tolist()} "
          f"(paper Fleurs profile: mean {prof.in_mean})")
    t0 = time.perf_counter()
    out = engine.generate_beam(model, params, batch=frames.shape[0], n_beams=N_BEAMS,
                               bos_id=BOS, eos_id=EOS, max_new_tokens=MAX_NEW,
                               extra_inputs={"frames": frames, "frame_lengths": frame_lengths})
    print(f"beam search (k={N_BEAMS}, KV reorder in place): {time.perf_counter() - t0:.2f}s")
    for b in range(frames.shape[0]):
        print(f"  hyp[{b}] score={float(out['scores'][b]):.2f} "
              f"tokens={out['tokens'][b, :10].tolist()}")
    served, matches = served_beams(model, params, device, frames, frame_lengths,
                                   out["tokens"], "S-T")
    return {"tokens": out["tokens"], "scores": out["scores"], "served": served,
            "matches": matches}


def run_ss(model, params, device, frames=None) -> Dict[str, Any]:
    """S-S: beam text, one T2U and one vocoder forward, then the text served
    as beam groups; returns both."""
    cfg = model.config
    if frames is None:
        frames, _ = inputs_for(cfg, device, batch=2)
    frames = frames.to(device).to(params["embed"]["table"].dtype)
    t0 = time.perf_counter()
    ss = seamless.speech_to_speech(model, params, frames=frames, bos_id=BOS, eos_id=EOS,
                                   n_beams=N_BEAMS, max_text_len=MAX_NEW)
    print(f"S-S {cfg.name}: text {tuple(ss['text'].shape)}, units {tuple(ss['units'].shape)}, "
          f"waveform {tuple(ss['waveform'].shape)} in {time.perf_counter() - t0:.2f}s")
    assert bool(torch.isfinite(ss["waveform"]).all()), "S-S: non-finite waveform"
    full = torch.full((frames.shape[0],), frames.shape[1], dtype=torch.int32, device=device)
    served, matches = served_beams(model, params, device, frames, full, ss["text"], "S-S")
    return {"text": ss["text"], "units": ss["units"], "waveform": ss["waveform"],
            "served": served, "matches": matches}


def build(arch: str, device):
    """The f32 smoke config of ``arch`` and its params from seed 0."""
    return smoke_model(arch, device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises when there is no card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    with torch.inference_mode():
        st = run_st(*build("whisper-base", device), device)
        ss = run_ss(*build("seamless-m4t", device), device)
    return {"st": st, "ss": ss}


if __name__ == "__main__":
    main()
