"""AdamW with global-norm clipping and a cosine LR schedule — the
counterpart of ``repro/training/optimizer.py``, on trees of tensors.

Trees are the reference's: nested dicts and lists (and ``AdamState``, a
NamedTuple) whose leaves are tensors. Leaves are visited in the order JAX
flattens such a tree (dict keys sorted, list items and NamedTuple fields in
order), so sums over leaves add in the reference's order, and a leaf's
path reads as the reference's (``layers/0/attn/wq/w``). The serving-only
``table_f32`` copy is not in these trees (``layers.drop_f32_table``).

The schedule, the bias corrections and every update run in f32 tensors, as
the reference computes them (JAX's weakly typed Python scalars become f32
constants, and so do torch's); the new params are cast back to their own
dtype and the moments to ``moment_dtype``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Iterator, List, NamedTuple, Tuple

import torch


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    # moment dtype: f32 default; bf16 halves the optimizer's memory
    moment_dtype: str = "float32"


class AdamState(NamedTuple):
    step: torch.Tensor  # scalar int32
    mu: Any  # first moments (tree like params)
    nu: Any  # second moments


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def tree_items(tree: Any, path: Tuple = ()) -> Iterator[Tuple[Tuple, torch.Tensor]]:
    """(path, leaf) of every tensor of ``tree`` in JAX's flattening order:
    dict keys sorted, list items and NamedTuple fields in order. A path is
    the keys, indices and field names from the root."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from tree_items(getattr(tree, name), path + (name,))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, path + (i,))
    else:
        yield path, tree


def tree_map(fn: Callable, tree: Any, path: Tuple = ()) -> Any:
    """``tree`` rebuilt with ``fn(path, leaf)`` at every leaf."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, getattr(tree, n), path + (n,)) for n in tree._fields))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def path_str(path: Tuple) -> str:
    return "/".join(str(k) for k in path)


def init_state(params: Any, cfg: OptimizerConfig) -> AdamState:
    dt = _DTYPES[cfg.moment_dtype]
    zeros = lambda _, p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    dev = next(tree_items(params))[1].device
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                     mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def lr_at(step: torch.Tensor, cfg: OptimizerConfig) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_frac``, in f32 (``step``
    an int32 tensor)."""
    step = torch.as_tensor(step, dtype=torch.int32)
    f32 = torch.float32
    warm = cfg.lr * torch.clamp(step + 1, max=cfg.warmup_steps).to(f32) / cfg.warmup_steps
    span = torch.tensor(max(cfg.total_steps - cfg.warmup_steps, 1), dtype=torch.int32,
                        device=step.device)
    prog = torch.clamp((step - cfg.warmup_steps).to(f32) / span.to(f32), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(
        torch.tensor(math.pi, dtype=f32, device=step.device) * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, as XLA's. CUDA's ``sqrt`` is;
    the CPU's vectorized one (SLEEF, within 0.5001 ulp) is not always, so
    there it runs in f64, whose root of an f32 rounds correctly to f32."""
    return torch.sqrt(x) if x.is_cuda else torch.sqrt(x.double()).float()


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the f32 sum of squares over every leaf, leaves summed in the
    reference's order."""
    total = None
    for _, x in tree_items(tree):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return _sqrt(total)


def _is_decayed(path: Tuple) -> bool:
    """No weight decay on norms/biases/scalars (llama convention). The
    reference's substring rule as it is: ``"/b"`` and ``"D"`` match
    anywhere in the path string."""
    s = path_str(path)
    return not any(t in s for t in ("norm", "scale", "/b", "bias", "A_log", "lam", "D"))


@torch.no_grad()
def apply_updates(
    params: Any,
    grads: Any,
    state: AdamState,
    cfg: OptimizerConfig,
) -> Tuple[Any, AdamState, dict]:
    """One AdamW step: (new params, new state, {"grad_norm", "lr"}).
    ``grads`` is a tree like ``params``."""
    gnorm = global_norm(grads)
    # a true division (a Python scalar over a tensor is a reciprocal times it)
    scale = torch.clamp(torch.full_like(gnorm, cfg.clip_norm) / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1, b2 = cfg.betas
    step = state.step + 1
    lr = lr_at(state.step, cfg)
    f32 = dict(dtype=torch.float32, device=step.device)
    bc1 = 1 - torch.pow(torch.tensor(b1, **f32), step.float())
    bc2 = 1 - torch.pow(torch.tensor(b2, **f32), step.float())
    dt = _DTYPES[cfg.moment_dtype]

    def upd(path, p, g, mu, nu):
        g = g.float() * scale
        mu_n = b1 * mu.float() + (1 - b1) * g
        nu_n = b2 * nu.float() + (1 - b2) * g * g
        u = (mu_n / bc1) / (_sqrt(nu_n / bc2) + cfg.eps)
        if _is_decayed(path):
            u = u + cfg.weight_decay * p.float()
        new_p = (p.float() - lr * u).to(p.dtype)
        return new_p, mu_n.to(dt), nu_n.to(dt)

    flat = list(tree_items(params))
    g_flat = [g for _, g in tree_items(grads)]
    mu_flat = [m for _, m in tree_items(state.mu)]
    nu_flat = [n for _, n in tree_items(state.nu)]
    out = {path: upd(path, p, g, m, n)
           for (path, p), g, m, n in zip(flat, g_flat, mu_flat, nu_flat)}
    pick = lambda i: (lambda path, _: out[path][i])  # noqa: E731
    return (tree_map(pick(0), params),
            AdamState(step=step, mu=tree_map(pick(1), params), nu=tree_map(pick(2), params)),
            {"grad_norm": gnorm, "lr": lr})


def leaf_list(tree: Any) -> List[torch.Tensor]:
    return [x for _, x in tree_items(tree)]
