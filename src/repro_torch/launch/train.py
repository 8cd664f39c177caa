"""Training launcher of the port: ``--arch <id>``, the counterpart of
``repro/launch/train.py`` on one device.

It draws random params from ``torch.Generator`` seed 0 on ``--device``, the
reference's token stream (``training/data.token_stream``, seed 0) and
trains with AdamW (``training/train_loop.make_train_step``), printing the
loss, the gradient norm and tok/s as the reference does. Every step runs
the kernels' plain PyTorch versions (``impl="torch"``): the port's CUDA
kernels have no backward, as the reference's Pallas kernels have none.
The reference's mesh and sharding (``distributed/``) are not ported: one
device, no data parallelism. ``--n-layers`` cuts the depth (the published
widths kept); ``--device cpu`` runs on the CPU, and without it a host with
no card raises.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --smoke --device cpu --steps 20 [--ckpt out.npz]
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --steps 100 --batch 4 --seq 128
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.serve import resolve_device
from repro_torch.models import get_model
from repro_torch.models import layers as L
from repro_torch.training import checkpoint, data, optimizer as opt
from repro_torch.training.train_loop import make_train_step, to_batch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the model to its first N layers (published widths kept)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises when there is no card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.n_layers is not None:
        cfg = cfg.replace(n_layers=args.n_layers)
    model = get_model(cfg)
    print(f"[train] arch={cfg.name} params={cfg.n_params() / 1e6:.1f}M "
          f"device={dev} impl=torch")

    opt_cfg = opt.OptimizerConfig(lr=args.lr, total_steps=args.steps)
    params = L.drop_f32_table(model.init(torch.Generator(device=dev).manual_seed(0), dev))
    state = opt.init_state(params, opt_cfg)
    step = make_train_step(model, opt_cfg, impl="torch")

    stream = data.token_stream(cfg, batch=args.batch, seq_len=args.seq)
    t0 = time.perf_counter()
    for i in range(args.steps):
        batch = to_batch(next(stream), dev)
        params, state, metrics = step(params, state, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            tok_s = args.batch * args.seq * (i + 1) / (time.perf_counter() - t0)
            print(f"step {i:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({tok_s:.0f} tok/s)")
    if args.ckpt:
        checkpoint.save(args.ckpt, params, state, step=args.steps)
        print(f"[train] checkpoint -> {args.ckpt}")
    return params, state


if __name__ == "__main__":
    main()
