"""Chameleon T-I profile, the reference's ``examples/image_generation.py``
on the port: contrastive (CFG) image-token generation, the paper's
longest-latency workload (1024 decode steps at full size, two forwards a
step), batch-at-a-time; I-T captioning with the same model; then served:
T-I requests as 2-slot cond/uncond groups through the paged
continuous-batching pool, mixed with plain I-T traffic in the same decode
batches, the served T-I tokens matching the batch run's. On chameleon's
smoke config in f32.

  PYTHONPATH=src python -m repro_torch.examples.image_generation [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core import engine, profiles, sampling
from repro_torch.core.scheduler import Scheduler, ServeRequest
from repro_torch.examples import smoke_model
from repro_torch.launch.serve import resolve_device
from repro_torch.models import vlm

GUIDANCE = 3.0


def prompt_for(cfg, device) -> torch.Tensor:
    """A 14-token text prompt (the paper's MSCOCO mean 13.9) from numpy seed
    1, below the image-token range."""
    off = vlm.image_token_offset(cfg)
    rng = np.random.default_rng(1)
    return torch.from_numpy(rng.integers(0, off, (1, 14)).astype(np.int32)).to(device)


def run(model, params, device, prompt: Optional[torch.Tensor] = None,
        image: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """The example's steps on ``params``; returns what it prints."""
    cfg = model.config
    off = vlm.image_token_offset(cfg)
    prompt = prompt_for(cfg, device) if prompt is None else prompt.to(device)
    n_img = cfg.vlm.n_image_tokens
    print(f"T-I: prompt len {prompt.shape[1]} (paper MSCOCO mean 13.9), generating {n_img} "
          f"image tokens with contrastive decoding (2 fwd/step)")
    t0 = time.perf_counter()
    out = engine.generate_contrastive(model, params, prompt, uncond_token=0,
                                      n_image_tokens=n_img, guidance=GUIDANCE,
                                      sampler=sampling.top_p(0.9))
    dt = time.perf_counter() - t0
    toks = out["tokens"]
    assert bool((toks >= off).all()), "T-I must emit only image tokens"
    print(f"generated {toks.shape[1]} image tokens in {dt:.2f}s "
          f"({1e3 * dt / toks.shape[1]:.1f} ms/step incl. both streams)")
    print(f"VQ ids (first 16): {(toks[0, :16] - off).tolist()}")

    # I-T (captioning) with the same model: the image tokens, then the prompt
    if image is None:
        image = vlm.encode_image_stub(cfg, torch.Generator(device=device).manual_seed(2), 1,
                                      device)
    it_prompt = vlm.build_it_input(cfg, image.to(device), prompt[:, :6])
    cap = engine.generate(model, params, it_prompt, max_new_tokens=8)
    print(f"I-T caption tokens: {cap['tokens'][0].tolist()}")

    # served: two T-I requests (2-slot cond/uncond groups, greedy CFG) share
    # the paged pool's decode batches with a plain greedy request
    ti = profiles.ContrastiveProfile(uncond_token=0, guidance=GUIDANCE, mask_offset=off)
    p0 = prompt[0].cpu().numpy()
    reqs = [ServeRequest(rid=0, prompt=p0, max_new=n_img, profile=ti),
            ServeRequest(rid=1, prompt=p0[:7], max_new=n_img, profile=ti),
            ServeRequest(rid=2, prompt=p0[:10], max_new=8)]
    sched = Scheduler(model, params, slots=5, pad_to=16, max_new_cap=n_img, device=device,
                      paged=True, block_size=8)
    t0 = time.perf_counter()
    done = sched.run(reqs)
    dt = time.perf_counter() - t0
    ref = engine.generate_contrastive(model, params, prompt, uncond_token=0,
                                      n_image_tokens=n_img, guidance=GUIDANCE)["tokens"][0]
    got = next(d for d in done if d.rid == 0)
    match = bool(np.array_equal(np.asarray(got.tokens), ref.cpu().numpy()))
    print(f"served (contrastive groups in the paged pool): {dt:.2f}s | {len(done)} requests | "
          f"groups={sched.n_group_admissions} | matches-batch={match}")
    assert all((np.asarray(d.tokens) >= off).all() for d in done if d.rid in (0, 1)), \
        "T-I groups must emit only image tokens"
    return {"top_p": toks, "caption": cap["tokens"], "greedy_cfg": ref,
            "served": {d.rid: d.tokens for d in done}, "matches": match}


def build(device):
    """The f32 chameleon-34b smoke config and its params from seed 0."""
    return smoke_model("chameleon-34b", device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises when there is no card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    model, params = build(device)
    with torch.inference_mode():
        return run(model, params, device)


if __name__ == "__main__":
    main()
