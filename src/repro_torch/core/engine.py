"""Generation engine: the step primitives and greedy ``generate`` — the
counterpart of ``repro/core/engine.py`` for the contiguous cache.

- ``prefill``     — prompt -> fresh cache + last-position logits. With
                    batch=1 this is the scheduler's single-slot refill.
- ``decode_step`` — one decode step for every sequence slot; the cache is
                    updated in place (the reference donates it).
- ``generate``    — prefill + a direct decode loop with
                    ``SamplingProfile``'s greedy semantics (``eos_id``,
                    ``live``, output always [B, max_new], ``n_steps``).

Everything runs eagerly under ``torch.inference_mode()``; the mixed and
verify steps (paged pools, speculation) are later slices.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.core import sampling
from repro_torch.models.registry import Model


def _last_logits(logits: torch.Tensor, prompt_lengths: torch.Tensor) -> torch.Tensor:
    """Gather the logits at each sequence's final prompt position."""
    idx = torch.clamp(prompt_lengths.long() - 1, min=0)
    return logits[torch.arange(logits.shape[0], device=logits.device), idx]


@torch.inference_mode()
def prefill(model: Model, params, tokens: torch.Tensor, prompt_lengths: torch.Tensor,
            max_len: int, impl: str = "auto"):
    """Prompt -> (last-position logits [B, V], fresh cache on the tokens'
    device)."""
    cache = model.init_cache(tokens.shape[0], max_len, tokens.device)
    batch = {"tokens": tokens, "prompt_lengths": prompt_lengths}
    logits, cache, _ = model.forward(params, batch, cache=cache, mode="prefill",
                                     impl=impl)
    return _last_logits(logits, prompt_lengths), cache


@torch.inference_mode()
def decode_step(model: Model, params, cache, token: torch.Tensor, impl: str = "auto"):
    """One decode step for every slot: token [B] -> (logits [B, V], cache),
    the cache's buffers written in place."""
    logits, cache, _ = model.forward(params, {"tokens": token[:, None]}, cache=cache,
                                     mode="decode", impl=impl)
    return logits[:, 0], cache


@torch.inference_mode()
def generate(
    model: Model,
    params,
    prompt_tokens: torch.Tensor,  # [B, Tp] right-padded
    *,
    prompt_lengths: Optional[torch.Tensor] = None,
    max_new_tokens: int = 32,
    eos_id: Optional[int] = None,
    live: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> Dict[str, Any]:
    """Greedy generation with the reference's ``SamplingProfile`` contract:
    ``live`` [B] marks real rows (dead rows emit only the fill token, EOS
    when set else 0, and never block the all-done exit); ``tokens`` is
    ALWAYS [B, max_new_tokens], padded with the fill token after an early
    exit; ``n_steps`` counts the steps actually run."""
    b, tp = prompt_tokens.shape
    dev = prompt_tokens.device
    if prompt_lengths is None:
        prompt_lengths = torch.full((b,), tp, dtype=torch.int32, device=dev)
    max_len = tp + max_new_tokens + 1
    fill = eos_id if eos_id is not None else 0
    done = None
    if eos_id is not None or live is not None:
        done = (torch.zeros((b,), dtype=torch.bool, device=dev) if live is None
                else ~live.to(device=dev, dtype=torch.bool))
    tokens = torch.full((b, max_new_tokens), fill, dtype=torch.int32, device=dev)

    logits, cache = prefill(model, params, prompt_tokens, prompt_lengths, max_len, impl)
    n_steps, halt, feed = 0, False, None
    for i in range(max_new_tokens):
        if i > 0:
            if halt:
                break
            logits, cache = decode_step(model, params, cache, feed, impl)
        token = sampling.greedy(logits)
        if done is not None:
            if eos_id is not None:
                done = done | (token == eos_id)  # the 1st token may stop a row
            token = torch.where(done, torch.full_like(token, fill), token)
        tokens[:, i] = token
        feed = token
        n_steps += 1
        # the loop's one host sync per step: a single scalar transfer
        halt = done is not None and bool(done.all().item())
    return {"tokens": tokens, "cache": cache, "n_steps": n_steps}
