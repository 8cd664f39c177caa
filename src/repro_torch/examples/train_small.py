"""End-to-end training driver, the reference's ``examples/train_small.py``
on the port: train a small dense llama-family model (67.4 M parameters with
tied embeddings) with AdamW, the learning-rate schedule and checkpoints, and
check that the loss falls. Every step runs the kernels' plain PyTorch
versions (``impl="torch"``): the port's CUDA kernels have no backward.

  PYTHONPATH=src python -m repro_torch.examples.train_small [--device cpu] [--steps 300]
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.serve import resolve_device
from repro_torch.models import get_model
from repro_torch.training import data, optimizer as opt, train_loop

# 100M-class llama-family model (67.4M params, CPU-trainable)
CFG_100M = ModelConfig(
    name="llama-100m-class",
    family="dense",
    n_layers=6,
    d_model=640,
    n_heads=10,
    n_kv_heads=2,
    d_ff=2560,
    vocab_size=50_000,
    tie_embeddings=True,
    dtype="float32",
)

#: the default checkpoint, under the repository's ignored build directory
CKPT = Path(__file__).resolve().parents[3] / "build" / "examples" / "train_small.npz"


def run(model, params, device, *, steps: int = 300, batch: int = 8, seq: int = 128,
        ckpt: Optional[str] = str(CKPT), log_every: int = 20,
        ckpt_every: int = 100) -> Dict[str, Any]:
    """Train ``params`` (None: random from seed 0) for ``steps`` steps on the
    reference's token stream; returns the logged metrics, the first and
    last loss and the checkpoint's path."""
    cfg = model.config
    print(f"training {cfg.name}: {cfg.n_params() / 1e6:.1f}M params, {steps} steps @ batch "
          f"{batch} x seq {seq} on {device}")
    if ckpt:
        Path(ckpt).parent.mkdir(parents=True, exist_ok=True)
    res = train_loop.train(
        cfg, data=data.token_stream(cfg, batch=batch, seq_len=seq), steps=steps,
        opt_cfg=opt.OptimizerConfig(lr=6e-4, warmup_steps=20, total_steps=steps),
        log_every=log_every, ckpt_path=ckpt, ckpt_every=ckpt_every, device=device,
        impl="torch", params=params)
    first, last = res.metrics_history[0]["loss"], res.metrics_history[-1]["loss"]
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({'OK: decreasing' if last < first else 'WARN: not decreasing'})")
    print(f"checkpoint: {ckpt}")
    return {"history": res.metrics_history, "first": first, "last": last, "ckpt": ckpt,
            "params": res.params}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=str(CKPT))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises when there is no card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    model = get_model(CFG_100M)
    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    return run(model, params, device, steps=args.steps, batch=args.batch, seq=args.seq,
               ckpt=args.ckpt)


if __name__ == "__main__":
    main()
