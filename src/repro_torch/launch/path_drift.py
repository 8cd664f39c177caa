"""How far the kernel path's logits drift from the plain path's, in bf16
and in f32, for a full-width model with seeded random weights: one forward
of a random prompt through ``impl="cuda"`` (the hand-written kernels) and
through ``impl="torch"`` (their plain versions), then the same with an f32
copy of the params.

Prints one JSON line per (arch, type): the logits' std and max |logit|,
max |dlogit| and the median over positions of each row's max, and, after
every residual add (``layers.add_rmsnorm``: two a layer), the residual's
max difference relative to its max. The served checks' bounds rest on it:
the random models' logits reach several hundred, so bf16's rounding alone
(the kernels round P to bf16, the plain versions keep f32) moves them by
several units, while in f32 the paths agree to ~1e-3.

  PYTHONPATH=src python src/repro_torch/launch/path_drift.py \
      [--arch recurrentgemma-2b llama3.2-1b] [--tokens 256]

Needs a CUDA card; random weights and prompt from ``--seed``.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.launch import serve
from repro_torch.models import get_model
from repro_torch.models import layers as L


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f32(v) for v in tree]
    return tree.float()


def drift(model, params, tokens) -> dict:
    """One forward through each path; the logits' and residuals' drift."""
    real = L.add_rmsnorm
    sums = {}

    def spy(p, x, r, eps=1e-5, impl="auto"):
        s, h = real(p, x, r, eps, impl)
        sums[impl].append(s.float())
        return s, h

    logits = {}
    L.add_rmsnorm = spy
    try:
        for impl in ("cuda", "torch"):
            sums[impl] = []
            with torch.inference_mode():
                logits[impl] = model.forward(params, {"tokens": tokens}, impl=impl)[0].float()
    finally:
        L.add_rmsnorm = real
    d = (logits["cuda"] - logits["torch"]).abs()
    return {"logit_std": float(logits["torch"].std()),
            "logit_max": float(logits["torch"].abs().max()),
            "dlogit_max": float(d.max()), "dlogit_row_median": float(d.amax(-1).median()),
            "residual_rel": [float((a - b).abs().max() / b.abs().max())
                             for a, b in zip(sums["cuda"], sums["torch"])]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=["recurrentgemma-2b", "llama3.2-1b"])
    ap.add_argument("--tokens", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("path_drift: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    for arch in args.arch:
        cfg, model, params = serve.build_model(arch, smoke=False, seed=args.seed, device=dev)
        gen = torch.Generator(device=dev).manual_seed(args.seed + 3)
        tokens = torch.randint(0, cfg.vocab_size, (1, args.tokens), generator=gen, device=dev,
                               dtype=torch.int32)
        for name in ("bfloat16", "float32"):
            if name == "float32":
                model, params = get_model(cfg.replace(dtype="float32")), _f32(params)
            print(json.dumps({"arch": arch, "dtype": name, "device":
                              torch.cuda.get_device_name(0), **drift(model, params, tokens)}),
                  flush=True)
        del model, params
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
