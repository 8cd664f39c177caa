"""Token samplers and beam search of the port — counterparts of
``repro/core/sampling.py``.

Samplers share the signature ``sample(logits [B, V], key) -> [B]``:
``greedy``, and ``temperature`` / ``top_k`` / ``top_p`` (nucleus, the Llama
and Chameleon default), which draw through ``core/prng.py``'s copy of
``jax.random``. Continuous batching samples per slot: ``sample_slots``
gives each slot its own request's (temperature, top_p) and its own key, and
``slot_step_keys`` folds (request id, stream, token index) into the serve
key, so a request's tokens do not depend on its slot or its batch mates.
``window_step_keys`` / ``sample_window`` do the same for every lane of a
speculative verify window: lane ``j`` gets the key its token index would get
under plain decoding, which keeps speculative tokens equal to plain ones at
any temperature.

The nucleus filter keeps the reference's op order (sort then reverse,
softmax as exp(x - max) / sum, cumsum, ``cum - p < top_p``, the threshold as
the smallest kept logit); summation order differs from XLA's, which moves
the nucleus edge only where a cumulative sum lands within rounding of
``top_p``. Beam search (``BeamState``, ``beam_init``, ``beam_step``,
``beam_finalize``) is deterministic and needs no key."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import prng

Sampler = Callable[[torch.Tensor, Optional[torch.Tensor]], torch.Tensor]


def greedy(logits: torch.Tensor, key=None) -> torch.Tensor:
    """argmax over the vocabulary as int32; ties go to the first index, as
    ``jnp.argmax`` does."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _need_key(key) -> torch.Tensor:
    if key is None:
        raise ValueError("a sampled step needs a key (core/prng.PRNGKey)")
    return key


def temperature(temp: float = 1.0) -> Sampler:
    def sample(logits, key):
        return prng.categorical(_need_key(key), logits / max(temp, 1e-6)).to(torch.int32)

    return sample


def top_k(k: int, temp: float = 1.0) -> Sampler:
    def sample(logits, key):
        vals, idx = top_k_lower_index(logits, k)
        choice = prng.categorical(_need_key(key), vals / max(temp, 1e-6))
        return torch.gather(idx, -1, choice[..., None])[..., 0].to(torch.int32)

    return sample


def softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax``'s ops over the last axis: exp(x - max) / sum."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def nucleus(scaled: torch.Tensor, p) -> torch.Tensor:
    """``scaled`` with every logit outside the smallest top set of mass >=
    ``p`` set to -inf (the top-1 always kept); ``p`` a float or a tensor that
    broadcasts against ``scaled[..., :1]``."""
    sorted_logits = torch.sort(scaled, dim=-1).values.flip(-1)
    probs = softmax(sorted_logits)
    keep = torch.cumsum(probs, dim=-1) - probs < p
    # scalar operands: a fill in the kernel, no copy from the host
    threshold = torch.where(keep, sorted_logits, float("inf")).amin(dim=-1, keepdim=True)
    return torch.where(scaled >= threshold, scaled, float("-inf"))


def top_p(p: float = 0.9, temp: float = 1.0) -> Sampler:
    """Nucleus sampling (paper: Llama & Chameleon's strategy)."""

    def sample(logits, key):
        filtered = nucleus(logits / max(temp, 1e-6), p)
        return prng.categorical(_need_key(key), filtered).to(torch.int32)

    return sample


# --------------------------------------------------------------------------
# Per-slot sampling (continuous-batching scheduler)
# --------------------------------------------------------------------------

def request_key(base_key, rid, stream=0):
    """Per-(request, stream) key: independent of slot placement and batch
    mates; ``stream`` separates the streams of one multi-stream request."""
    return prng.fold_in(prng.fold_in(base_key, rid), stream)


def _as_index(x, like):
    """``x`` as int64 indices of ``like``'s kind: a numpy array beside a
    numpy key, else a tensor on the key's device."""
    if isinstance(like, np.ndarray):
        return np.asarray(x, dtype=np.int64)
    return torch.as_tensor(x, dtype=torch.int64).to(like.device)


def slot_step_keys(base_key, rids, steps, streams=None):
    """Key per slot for its next token: (request id, stream index, token
    index) folded into the serve key. [B] rids, [B] steps, optional [B]
    streams (default 0) -> [B, 2]; a numpy ``base_key`` hashes on the host
    and gives numpy keys."""
    rids = _as_index(rids, base_key)
    streams = rids * 0 if streams is None else _as_index(streams, base_key)
    return prng.fold_in(request_key(base_key, rids, streams), _as_index(steps, base_key))


def window_step_keys(base_key, rids, steps, streams=None):
    """Key per (slot, window lane): lane ``j`` of slot ``b`` gets the key
    for token index ``steps[b, j]`` of request ``rids[b]`` — the key plain
    one-token-per-step decoding would use for that token. [B] rids, [B, C]
    steps, optional [B] streams -> [B, C, 2] (numpy for a numpy key)."""
    rids = _as_index(rids, base_key)
    streams = rids * 0 if streams is None else _as_index(streams, base_key)
    req = request_key(base_key, rids, streams)  # [B, 2]
    return prng.fold_in(req[:, None], _as_index(steps, base_key))


def sample_slots(logits: torch.Tensor, keys: torch.Tensor, temperature: torch.Tensor,
                 top_p: torch.Tensor) -> torch.Tensor:
    """Per-slot sampler: logits [..., V], keys [..., 2], temperature and
    top_p [...]. Each slot samples its own nucleus at its own temperature
    under its own key (its Gumbel draw is a [V] block of that key); a
    temperature of 0 takes the greedy token. Returns int32 [...]."""
    greedy_tok = greedy(logits)
    temperature = temperature.to(device=logits.device, dtype=torch.float32)
    scaled = logits / torch.clamp(temperature, min=1e-6)[..., None]
    filtered = nucleus(scaled, top_p.to(device=logits.device, dtype=torch.float32)[..., None])
    noise = prng.gumbel(keys, (logits.shape[-1],))
    sampled = torch.argmax(noise + filtered, dim=-1).to(torch.int32)
    return torch.where(temperature <= 0.0, greedy_tok, sampled)


def sample_window(logits: torch.Tensor, keys: torch.Tensor, temperature: torch.Tensor,
                  top_p: torch.Tensor) -> torch.Tensor:
    """``sample_slots`` over every lane of a verify window: logits [B, C, V],
    keys [B, C, 2], temperature and top_p [B] (every lane of a slot samples
    with its request's). Returns int32 [B, C]."""
    return sample_slots(logits, keys, temperature[:, None], top_p[:, None])


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
