"""Token samplers and beam search of the port — counterparts of
``repro/core/sampling.py``. Greedy only so far: per-slot temperature /
top-p sampling with per-(request, token-index) keys is a later slice. Beam
search (``BeamState``, ``beam_init``, ``beam_step``, ``beam_finalize``) is
deterministic and needs no key."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch


def greedy(logits: torch.Tensor, key=None) -> torch.Tensor:
    """argmax over the vocabulary as int32; ties go to the first index, as
    ``jnp.argmax`` does."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


# --------------------------------------------------------------------------
# Beam search (Seamless profile, Obs #4)
# --------------------------------------------------------------------------

@dataclass
class BeamState:
    tokens: torch.Tensor  # [B*K, L] int32, generated so far (right-padded with 0)
    scores: torch.Tensor  # [B*K] f32 cumulative log-prob
    finished: torch.Tensor  # [B*K] bool
    step: int


def beam_init(batch: int, n_beams: int, max_len: int, device=None) -> BeamState:
    """Beam 0 of every group starts at score 0, beams 1..K-1 at -1e9, so the
    first step expands beam 0 alone (every beam holds the same prompt)."""
    seed = torch.full((n_beams,), -1e9, dtype=torch.float32, device=device)
    seed[0] = 0.0
    return BeamState(
        tokens=torch.zeros((batch * n_beams, max_len), dtype=torch.int32, device=device),
        scores=seed.repeat(batch),
        finished=torch.zeros((batch * n_beams,), dtype=torch.bool, device=device),
        step=0,
    )


def log_softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_softmax``'s ops in its order over the last axis: the
    shift by the max, then minus the log of the sum of exponentials (which
    ``torch.log_softmax`` rounds differently in the last bit)."""
    shifted = x - x.amax(dim=-1, keepdim=True)
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


def top_k_lower_index(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest entries of each row, equal
    values in ascending index order — ``jax.lax.top_k``'s order, which
    ``torch.topk`` does not promise: a stable descending sort keeps equal
    entries in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_candidates(state: BeamState, logits: torch.Tensor, n_beams: int,
                    eos_id: int) -> torch.Tensor:
    """Every group's ``n_beams * V`` candidate scores [B, K*V]: each beam's
    score plus its next-token log-probabilities, a finished beam extending
    only by EOS, at no cost."""
    bk, v = logits.shape
    logp = log_softmax(logits.float())
    eos_only = torch.full((v,), float("-inf"), device=logits.device)
    eos_only[eos_id] = 0.0
    logp = torch.where(state.finished[:, None], eos_only[None], logp)
    return (state.scores[:, None] + logp).reshape(bk // n_beams, n_beams * v)


def beam_step(
    state: BeamState,
    logits: torch.Tensor,  # [B*K, V] next-token logits for every live beam
    n_beams: int,
    eos_id: int,
) -> Tuple[BeamState, torch.Tensor]:
    """One beam-search step. Returns (new_state, beam_idx [B*K]) where
    ``beam_idx`` is the KV-cache reorder permutation (paper Obs #4: every
    step re-binds each stream to its surviving parent's cache)."""
    bk, v = logits.shape
    b = bk // n_beams
    dev = logits.device
    cand = beam_candidates(state, logits, n_beams, eos_id)
    top_scores, top_idx = top_k_lower_index(cand, n_beams)  # [B, K]
    parent = top_idx // v  # beam index within the group
    token = (top_idx % v).to(torch.int32).reshape(bk)

    beam_idx = (parent + torch.arange(b, device=dev)[:, None] * n_beams).reshape(bk)
    new_tokens = state.tokens.index_select(0, beam_idx)
    new_tokens[:, state.step] = token
    new_finished = state.finished.index_select(0, beam_idx) | (token == eos_id)
    new_state = BeamState(
        tokens=new_tokens,
        scores=top_scores.reshape(bk),
        finished=new_finished,
        step=state.step + 1,
    )
    return new_state, beam_idx


def beam_finalize(state: BeamState, n_beams: int):
    """Pick the best beam per group, its score normalised by its length
    (the reference's default length penalty, 1). A hypothesis' length runs
    to its first token 0, as in the reference."""
    bk, L = state.tokens.shape
    b = bk // n_beams
    dev = state.tokens.device
    stop = torch.cat([state.tokens == 0, torch.ones((bk, 1), dtype=torch.bool, device=dev)],
                     dim=1)
    lengths = torch.argmax(stop.to(torch.int32), dim=1)  # the first True
    norm = state.scores / torch.clamp(lengths, min=1).float()
    best = torch.argmax(norm.reshape(b, n_beams), dim=1)  # the first best
    idx = best + torch.arange(b, device=dev) * n_beams
    return state.tokens.index_select(0, idx), norm.index_select(0, idx)
