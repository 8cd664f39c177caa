"""Training loop: the loss, one train step and a host-side loop with
checkpointing and metrics — the counterpart of
``repro/training/train_loop.py``, in eager PyTorch (``loss.backward()``).

The params are the reference's tree (``layers.drop_f32_table``): the
optimizer, the gradient norm and the checkpoint see exactly its leaves.
The port's CUDA kernels have no backward (nor do the reference's Pallas
kernels, which ``jax.grad`` cannot differentiate), so on the card a step
runs the plain PyTorch versions: pass ``impl="torch"``. Under
``impl="auto"`` a kernel wrapper given a tensor that needs a gradient
raises (``kernels/ops.py``) rather than hand autograd a constant.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.registry import Model, get_model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt


def loss_fn(model: Model, params, batch: Dict[str, torch.Tensor],
            impl: str = "auto") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(the mean next-token loss plus the model's aux loss, {"ce", "aux"})."""
    logits, _, aux = model.forward(params, batch, mode="train", impl=impl)
    ce = L.cross_entropy_loss(logits, batch["labels"], batch.get("loss_mask"))
    aux_loss = aux.get("aux_loss", torch.zeros((), device=logits.device))
    return ce + aux_loss, {"ce": ce, "aux": aux_loss}


def value_and_grad(model: Model, params, batch: Dict[str, torch.Tensor],
                   impl: str = "auto"):
    """(loss, {"ce", "aux"}, gradients: a tree like ``params``), the
    gradients by ``loss.backward()`` into detached aliases of the params. A
    leaf the loss does not reach (Seamless's T2U and vocoder, HSTU's ranking
    head) gets a zero gradient, as ``jax.grad`` gives it. ``params`` is the
    reference's tree: it must not hold ``table_f32``."""
    if params is not L.drop_f32_table(params):
        raise ValueError("training takes the reference's tree: drop table_f32 first "
                         "(layers.drop_f32_table)")
    live = opt.tree_map(lambda _, p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, parts = loss_fn(model, live, batch, impl)
        loss.backward()
    grads = opt.tree_map(
        lambda _, p: p.grad if p.grad is not None else torch.zeros_like(p), live)
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads


def make_train_step(model: Model, opt_cfg: opt.OptimizerConfig,
                    impl: str = "auto") -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: ``value_and_grad``, then ``optimizer.apply_updates``."""

    def train_step(params, opt_state, batch):
        loss, parts, grads = value_and_grad(model, params, batch, impl)
        params, opt_state, om = opt.apply_updates(params, grads, opt_state, opt_cfg)
        return params, opt_state, {"loss": loss, **parts, **om}

    return train_step


@dataclass
class TrainResult:
    params: Any
    opt_state: Any
    metrics_history: list


def to_batch(np_batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in np_batch.items()}


def train(
    cfg: ModelConfig,
    *,
    data: Iterator[Dict],
    steps: int,
    opt_cfg: Optional[opt.OptimizerConfig] = None,
    seed: int = 0,
    log_every: int = 10,
    ckpt_path: Optional[str] = None,
    ckpt_every: int = 0,
    jit: bool = True,
    device="cuda",
    impl: str = "auto",
    params=None,
) -> TrainResult:
    """The reference's loop: random params from ``seed`` (a
    ``torch.Generator`` on ``device``), a step a
    batch of ``data`` (numpy arrays), a printed line every ``log_every``
    steps and after the last, and a checkpoint every ``ckpt_every`` steps and
    at the end when ``ckpt_path`` is set. ``jit`` has no PyTorch
    counterpart here (the step runs eagerly) and is accepted for the
    reference's signature. ``params``, when given, are trained instead of
    the random ones (the port's addition: a test can start both packages
    from the same tree). Returns the trained params in the reference's
    tree: ``layers.with_f32_table`` makes them ready to serve."""
    del jit
    model = get_model(cfg)
    opt_cfg = opt_cfg or opt.OptimizerConfig(total_steps=steps)
    if params is None:
        params = model.init(torch.Generator(device=device).manual_seed(seed), device)
    params = L.drop_f32_table(params)
    opt_state = opt.init_state(params, opt_cfg)
    step_fn = make_train_step(model, opt_cfg, impl)

    history = []
    t0 = time.perf_counter()
    for i in range(steps):
        batch = to_batch(next(data), device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if i % log_every == 0 or i == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = i
            m["wall_s"] = time.perf_counter() - t0
            history.append(m)
            print(
                f"step {i:5d} loss {m['loss']:.4f} ce {m['ce']:.4f} "
                f"gnorm {m['grad_norm']:.3f} lr {m['lr']:.2e} ({m['wall_s']:.1f}s)"
            )
        if ckpt_path and ckpt_every and (i + 1) % ckpt_every == 0:
            ckpt.save(ckpt_path, params, opt_state, step=i + 1)
    if ckpt_path:
        ckpt.save(ckpt_path, params, opt_state, step=steps)
    return TrainResult(params=params, opt_state=opt_state, metrics_history=history)
