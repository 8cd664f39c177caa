"""LayerSkip self-speculative decoding (paper §4.3, Elhoushi et al. 2024) —
the counterpart of ``repro/core/layerskip.py``.

Draft tokens come auto-regressively from the first E layers and the shared
LM head (the early exit); one full-model forward then verifies the whole
draft window (``engine.verify_step``). Greedy acceptance keeps the scheme
lossless: every committed token is one the full model would have produced,
and with the serving scheduler's per-(request, token index) keys that holds
at any temperature.

Drafting writes the pool cache itself, not a scratch copy: a draft write
lands only at positions >= the committed length, where the validity mask
hides it, and the verify step rewrites the whole window in every layer
(for layers < E the draft's K/V is exactly what the full model writes).
Rolling back a rejected suffix is a host-side lengths rewind (contiguous)
or block-table truncation (paged), never a device copy. Only attention
caches roll back this way: the port's dense and VLM families.

:func:`draft_window` + ``engine.verify_step`` are the serving pool's
speculative step (core/scheduler.py); :func:`layerskip_generate` is the
batch-at-a-time engine on the same primitives (per-row commit).
:func:`tp_draft_window` is the draft on one tensor-parallel rank
(``distributed/tp_pool.py``): each draft's logits are gathered over the
vocab before the argmax, and rank 0's window is broadcast, so every rank
verifies and commits the same window.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import kv_cache
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.models.registry import Model

#: families whose cache rolls back by a lengths rewind / table truncation
FAMILIES = ("dense", "moe", "mla_moe", "vlm")


def early_exit_forward(
    cfg: ModelConfig,
    params,
    batch: Dict[str, torch.Tensor],
    *,
    n_layers: int,
    cache=None,
    mode: str = "decode",
    advance: Optional[torch.Tensor] = None,
    impl: str = "auto",
    tp=None,
):
    """The forward through the first ``n_layers`` layers only, then the
    final norm and the shared LM head — the LayerSkip draft model, on a
    contiguous or a paged cache. ``advance`` [B] replaces each slot's length
    bump (default the token count): the pool's draft loop freezes slots whose
    window is spent by advancing them 0. ``tp`` runs one rank's shard (its
    vocab slice of the logits). Returns (logits, new cache)."""
    logits, new_cache, _ = transformer.forward(cfg, params, batch, cache=cache, mode=mode,
                                               impl=impl, n_layers=n_layers, advance=advance,
                                               tp=tp)
    return logits, new_cache


@torch.inference_mode()
def draft_window(model: Model, exit_layer: int, n_draft: int, params, cache,
                 token0: torch.Tensor, n_live: torch.Tensor, lengths: torch.Tensor,
                 impl: str = "auto"):
    """Greedy-draft up to ``n_draft`` tokens per slot with the early-exit
    model, writing straight into the pool cache. ``token0`` [B] is each
    slot's pending token; slot ``b`` drafts ``n_live[b]`` tokens (0: a
    plain-decode or idle slot, frozen: its repeated write at the frozen
    position is garbage the verify step overwrites). ``lengths`` [B] is the
    host's write position of every slot, pinned in place first. Returns
    ``(window [B, n_draft + 1], cache)``: lane 0 is ``token0``, lanes
    1..n_draft the drafts (a frozen slot repeats its token; those lanes are
    never verified or committed). A tensor-parallel rank's model (``tp``)
    drafts on its shard and gathers each draft's logits over the vocab."""
    cfg, tp = model.config, getattr(model, "tp", None)
    cache["lengths"].copy_(lengths)
    token, lanes = token0, [token0]
    for i in range(n_draft):
        live = i < n_live  # [B]
        logits, cache = early_exit_forward(
            cfg, params, {"tokens": token[:, None]}, n_layers=exit_layer, cache=cache,
            mode="decode", advance=live.to(torch.int32), impl=impl, tp=tp,
        )
        if tp is not None:
            logits = L.gather_vocab(logits, tp, cfg.vocab_size)
        nxt = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
        token = torch.where(live, nxt, token)
        lanes.append(token)
    return torch.stack(lanes, dim=1), cache


@torch.inference_mode()
def tp_draft_window(model: Model, exit_layer: int, n_draft: int, params, cache,
                    token0: torch.Tensor, n_live: torch.Tensor, lengths: torch.Tensor,
                    impl: str = "auto"):
    """``draft_window`` on one tensor-parallel rank: the drafts come from
    the vocab-gathered logits, and rank 0's window (host state: the
    scheduler commits against it) is broadcast to every rank."""
    window, cache = draft_window(model, exit_layer, n_draft, params, cache, token0, n_live,
                                 lengths, impl)
    return model.tp.broadcast(window), cache


def layerskip_generate(
    model: Model,
    params,
    prompt_tokens: torch.Tensor,  # [B, Tp]
    *,
    exit_layer: int,
    n_draft: int = 4,
    max_new_tokens: int = 32,
    impl: str = "auto",
) -> Dict[str, object]:
    """Greedy LayerSkip generation; returns the tokens [B, max_new_tokens]
    and the acceptance statistics. The commit is per row: a row whose draft
    was rejected does not hold the others back, and a finished row idles
    with a zero-width window. The committed tokens equal full-model greedy
    decoding."""
    from repro_torch.core import engine

    cfg = model.config
    if cfg.family not in FAMILIES:
        raise ValueError(
            f"LayerSkip needs a cache that rolls back; family {cfg.family!r} has none")
    b, tp = prompt_tokens.shape
    dev = prompt_tokens.device
    max_len = tp + max_new_tokens + n_draft + 2
    prompt_lengths = torch.full((b,), tp, dtype=torch.int32, device=dev)
    logits, cache = engine.prefill(model, params, prompt_tokens, prompt_lengths, max_len,
                                   impl)
    token = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()  # [B]

    out = np.zeros((b, max_new_tokens), np.int32)
    out[:, 0] = token
    emitted = np.ones((b,), np.int64)
    kv_len = np.full((b,), tp, np.int64)  # the next write position of each row
    n_rounds = n_drafted = n_accepted = 0
    while (emitted < max_new_tokens).any():
        remaining = max_new_tokens - emitted
        w = np.where(remaining > 0, np.minimum(n_draft + 1, remaining), 0).astype(np.int32)
        n_live = np.maximum(w - 1, 0).astype(np.int32)
        lengths = torch.from_numpy(kv_len.astype(np.int32)).to(dev)
        window, cache = draft_window(model, exit_layer, n_draft, params, cache,
                                     torch.from_numpy(token).to(dev),
                                     torch.from_numpy(n_live).to(dev), lengths, impl)
        logits, cache = engine.verify_step(model, params, cache, window,
                                           torch.from_numpy(w).to(dev), lengths)
        preds = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        win = window.cpu().numpy()
        for r in range(b):
            if w[r] == 0:
                continue
            commits = 0
            for j in range(int(w[r])):
                tok = int(preds[r, j])
                out[r, emitted[r]] = tok
                emitted[r] += 1
                commits += 1
                token[r] = tok
                # stop at the first draft the full model contradicts (the
                # committed token is the full model's correction)
                if j + 1 >= int(w[r]) or tok != int(win[r, j + 1]):
                    break
            kv_len[r] += commits
            n_drafted += int(n_live[r])
            n_accepted += commits - 1
        # the rejected suffixes rolled back on the host: one lengths rewind
        cache = kv_cache.rewind(cache, torch.from_numpy(kv_len.astype(np.int32)).to(dev))
        n_rounds += 1

    return {
        "tokens": torch.from_numpy(out).to(dev),
        "n_rounds": n_rounds,
        "acceptance": n_accepted / max(n_drafted, 1),
        # the first token comes from the prefill, not from a round
        "tokens_per_round": (max_new_tokens - 1) / max(n_rounds, 1),
    }
