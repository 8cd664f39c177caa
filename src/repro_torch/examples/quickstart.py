"""Quickstart, the reference's ``examples/quickstart.py`` on the port: build
a model from the registry, generate with top-p sampling from a static KV
cache, quantize it with AutoQuant and generate again, and decode with
LayerSkip, which must give greedy decoding's tokens.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core import engine, layerskip, quantization, sampling
from repro_torch.examples import smoke_model
from repro_torch.launch.serve import resolve_device

N_NEW = 24


def prompts_for(cfg, device) -> torch.Tensor:
    """Two prompts of 12 tokens, drawn from numpy seed 1."""
    rng = np.random.default_rng(1)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)).to(device)


def run(model, params, device, prompts: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """The example's steps on ``params``; returns what it prints."""
    cfg = model.config
    prompts = prompts_for(cfg, device) if prompts is None else prompts.to(device)
    print(f"model={cfg.name} family={cfg.family} params={cfg.n_params() / 1e6:.1f}M "
          f"device={device}")

    # static-KV-cache generation (the paper's section 4.1.2 baseline)
    t0 = time.perf_counter()
    out = engine.generate(model, params, prompts, max_new_tokens=N_NEW,
                          sampler=sampling.top_p(0.9))
    print(f"top-p generate: {tuple(out['tokens'].shape)} in {time.perf_counter() - t0:.2f}s")

    # AutoQuant (section 4.2): per-layer int8, the mode picked by the roofline
    qparams, counts = quantization.autoquant(params, tokens_per_step=2)
    out_q = engine.generate(model, qparams, prompts, max_new_tokens=N_NEW)
    print(f"autoquant modes={counts}; quantized generate OK {tuple(out_q['tokens'].shape)}")

    # LayerSkip (section 4.3): self-speculative decoding, lossless against greedy
    greedy = engine.generate(model, params, prompts, max_new_tokens=N_NEW,
                             sampler=sampling.greedy)["tokens"]
    ls = layerskip.layerskip_generate(model, params, prompts, exit_layer=1, n_draft=4,
                                      max_new_tokens=N_NEW)
    ls_tokens = ls["tokens"].to(greedy.dtype)
    assert torch.equal(ls_tokens, greedy), "LayerSkip must be lossless"
    print(f"layerskip: acceptance={ls['acceptance']:.2f} "
          f"tokens/round={ls['tokens_per_round']:.2f} (lossless)")
    return {"top_p": out["tokens"], "quant_modes": counts, "quant": out_q["tokens"],
            "greedy": greedy, "layerskip": ls_tokens, "acceptance": ls["acceptance"],
            "tokens_per_round": ls["tokens_per_round"]}


def build(device):
    """The f32 llama3.2-1b smoke config and its params from seed 0."""
    return smoke_model("llama3.2-1b", device)


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
