"""DecodingProfile: one request-level decoding API for every strategy — the
counterpart of ``repro/core/profiles.py`` for the batch engines.

The paper's workloads differ in their decoding strategies as much as in
their architectures: Llama and Chameleon I-T decode token by token,
Seamless runs beam search with a per-step KV reorder (Obs #4), and
Chameleon T-I decodes two streams per request and mixes them contrastively
every step (§2.1.2). A ``DecodingProfile`` reduces each to the hooks
``engine.run_profile`` drives:

- ``n_streams``      — KV streams a request occupies (1 for sampling,
                       ``n_beams`` for beam, 2 for contrastive);
- ``stream_prompts`` / ``expand_prompts`` — what each stream prefills;
- ``init``           — fresh decoding state (pure);
- ``step``           — the group's per-stream logits in, the next token
                       fed to each stream, an optional cache permutation
                       (beam's surviving parents) and per-group done flags
                       out;
- ``finalize``       — the state collapsed into the request's output.

Hooks are vectorized over G groups laid out group-contiguously: row
``g * n_streams + s`` is group ``g``'s stream ``s``. The permutation is in
flat row indices (``perm[i]``: the row whose cache stream ``i`` continues
from); the caller applies it (``kv_cache.reorder_donated`` by default).

Sampling and contrastive profiles take greedy tokens at ``temperature <= 0``
and nucleus samples above it, drawn under the key ``step`` is given
(``core/prng.py``). ``SpeculativeProfile`` is a ``SamplingProfile`` that the
serving scheduler steps through LayerSkip draft/verify windows; the batch
engines treat it as its base. ``prefix_shared`` tells the serving
scheduler that every stream prefills the same prompt (beam), so a group
prefills once and, on the paged pool, its streams share the prompt's blocks
copy-on-write instead of each holding its own (contrastive: no).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import sampling


def _sampler(custom: Optional[sampling.Sampler], temperature: float,
             top_p: float) -> sampling.Sampler:
    """``custom`` if given, else greedy at ``temperature <= 0`` and nucleus
    sampling above it."""
    if custom is not None:
        return custom
    if temperature <= 0.0:
        return sampling.greedy
    return sampling.top_p(top_p, temperature)


@dataclass
class StepOut:
    """One profile step's result for G groups of S streams."""

    state: Any
    feed: torch.Tensor  # [G*S] next token fed to each stream
    perm: Optional[torch.Tensor]  # [G*S] flat cache permutation, or None
    done: Optional[torch.Tensor]  # [G] bool, or None (no early finish)


class DecodingProfile:
    """Base request-level decoding spec. Instances are immutable specs; all
    mutable decoding state lives in the object ``init`` returns (``step``
    writes its token column in place)."""

    #: streams with identical prompts: the scheduler prefills the group once
    #: and shares the prompt's blocks across it instead of copying them
    prefix_shared: bool = True

    @property
    def n_streams(self) -> int:
        return 1

    def stream_prompts(self, prompt: np.ndarray) -> List[np.ndarray]:
        """The prompt token ids each stream prefills with (one length)."""
        return [np.asarray(prompt, np.int32)] * self.n_streams

    def expand_prompts(
        self,
        prompt_tokens: torch.Tensor,  # [G, Tp]
        prompt_lengths: torch.Tensor,  # [G]
        extra_inputs: Optional[Dict[str, torch.Tensor]],
    ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
        """Expand [G, Tp] prompts (and per-group extra inputs such as
        encoder frames) to the [G*S, ...] stream layout."""
        s = self.n_streams
        if s == 1:
            return prompt_tokens, prompt_lengths, extra_inputs
        toks = prompt_tokens.repeat_interleave(s, dim=0)
        lens = prompt_lengths.repeat_interleave(s, dim=0)
        extra = None
        if extra_inputs:
            extra = {k: v.repeat_interleave(s, dim=0) for k, v in extra_inputs.items()}
        return toks, lens, extra

    def init(self, n_groups: int, max_new: int, device=None) -> Any:
        raise NotImplementedError

    def step(self, state: Any, logits: torch.Tensor, key=None) -> StepOut:
        raise NotImplementedError

    def finalize(self, state: Any) -> Dict[str, torch.Tensor]:
        raise NotImplementedError


# --------------------------------------------------------------------------
# plain sampling (greedy / top-p) — the Llama & Chameleon I-T strategy
# --------------------------------------------------------------------------

@dataclass
class SamplingProfile(DecodingProfile):
    """Single-stream token sampling: greedy at ``temperature <= 0``, else
    nucleus sampling; ``sampler`` overrides both with any callable (the
    ``engine.generate`` escape hatch). ``live`` [G] marks real rows: dead
    rows count as finished, emit only the fill token (``eos_id`` when set,
    else 0) and never block the all-done exit."""

    temperature: float = 0.0
    top_p: float = 1.0
    eos_id: Optional[int] = None
    sampler: Optional[sampling.Sampler] = None
    live: Optional[torch.Tensor] = None  # [G] bool

    prefix_shared = True

    @property
    def _fill(self) -> int:
        return self.eos_id if self.eos_id is not None else 0

    def init(self, n_groups: int, max_new: int, device=None) -> Dict[str, Any]:
        done = None
        if self.eos_id is not None or self.live is not None:
            done = (torch.zeros((n_groups,), dtype=torch.bool, device=device)
                    if self.live is None else ~self.live.to(device=device, dtype=torch.bool))
        return {
            # pre-filled with the fill token: an early exit pads for free
            "tokens": torch.full((n_groups, max_new), self._fill, dtype=torch.int32,
                                 device=device),
            "done": done,
            "i": 0,
        }

    def step(self, state, logits, key=None) -> StepOut:
        token = _sampler(self.sampler, self.temperature, self.top_p)(logits, key)
        done = state["done"]
        if done is not None:
            if self.eos_id is not None:
                done = done | (token == self.eos_id)  # the 1st token may stop a row
            token = torch.where(done, torch.full_like(token, self._fill), token)
        state["tokens"][:, state["i"]] = token
        new_state = {"tokens": state["tokens"], "done": done, "i": state["i"] + 1}
        return StepOut(state=new_state, feed=token, perm=None, done=done)

    def finalize(self, state) -> Dict[str, torch.Tensor]:
        return {"tokens": state["tokens"]}


# --------------------------------------------------------------------------
# speculative (LayerSkip draft/verify) — multi-token pool steps
# --------------------------------------------------------------------------

@dataclass
class SpeculativeProfile(SamplingProfile):
    """Single-stream sampling whose pool steps commit a variable number of
    tokens: each speculative step greedily drafts up to ``n_draft`` tokens
    with the first ``exit_layer`` layers (``core/layerskip.draft_window``),
    scores the whole window in one full-model forward
    (``engine.verify_step``), commits the accepted prefix plus the full
    model's correction, and rewinds the rejected suffix on the host.

    Every committed token is sampled from full-model logits under the key
    plain pool decoding uses for it, so the tokens equal a plain run's at
    any temperature: ``exit_layer`` and ``n_draft`` move only how many
    tokens a step commits."""

    exit_layer: int = 1
    n_draft: int = 4


# --------------------------------------------------------------------------
# beam search — the Seamless S-T/T-T strategy (paper Obs #4)
# --------------------------------------------------------------------------

@dataclass
class BeamProfile(DecodingProfile):
    """Beam search over ``n_beams`` streams: every step rescores the
    ``n_beams * V`` candidates, keeps the top ``n_beams``, and re-binds
    each stream to its surviving parent's cache via the returned
    permutation — the paper's KV_Cache_Reorder op."""

    n_beams: int
    eos_id: int

    prefix_shared = True  # every beam prefills the same prompt

    @property
    def n_streams(self) -> int:
        return self.n_beams

    def init(self, n_groups: int, max_new: int, device=None) -> sampling.BeamState:
        return sampling.beam_init(n_groups, self.n_beams, max_new, device)

    def step(self, state, logits, key=None) -> StepOut:
        state, beam_idx = sampling.beam_step(state, logits, self.n_beams, self.eos_id)
        done = state.finished.reshape(-1, self.n_beams).all(dim=1)
        return StepOut(state=state, feed=state.tokens[:, state.step - 1], perm=beam_idx,
                       done=done)

    def finalize(self, state) -> Dict[str, torch.Tensor]:
        tokens, scores = sampling.beam_finalize(state, self.n_beams)
        return {"tokens": tokens, "scores": scores}


# --------------------------------------------------------------------------
# contrastive / classifier-free guidance — the Chameleon T-I strategy
# --------------------------------------------------------------------------

@dataclass
class ContrastiveProfile(DecodingProfile):
    """Two streams per request — conditional (the prompt) and unconditional
    (a null prompt). Each step runs both (the paper's "decodes twice at each
    time step"), mixes their logits as ``uncond + guidance * (cond -
    uncond)``, restricts them to ids >= ``mask_offset`` when set, samples
    one token (greedy at ``temperature <= 0``) and feeds it to both streams.
    No cache permutation."""

    uncond_token: int
    guidance: float = 3.0
    mask_offset: Optional[int] = None  # restrict to ids >= offset
    temperature: float = 0.0
    top_p: float = 1.0
    sampler: Optional[sampling.Sampler] = None

    prefix_shared = False  # cond and uncond prefill different prompts

    @property
    def n_streams(self) -> int:
        return 2

    def stream_prompts(self, prompt: np.ndarray) -> List[np.ndarray]:
        p = np.asarray(prompt, np.int32)
        return [p, np.full_like(p, self.uncond_token)]

    def expand_prompts(self, prompt_tokens, prompt_lengths, extra_inputs):
        g, tp = prompt_tokens.shape
        uncond = torch.full((g, tp), self.uncond_token, dtype=prompt_tokens.dtype,
                            device=prompt_tokens.device)
        # group-contiguous interleave: [c0, u0, c1, u1, ...]
        toks = torch.stack([prompt_tokens, uncond], dim=1).reshape(2 * g, tp)
        lens = prompt_lengths.repeat_interleave(2, dim=0)
        extra = None
        if extra_inputs:
            extra = {k: v.repeat_interleave(2, dim=0) for k, v in extra_inputs.items()}
        return toks, lens, extra

    def init(self, n_groups: int, max_new: int, device=None) -> Dict[str, Any]:
        return {"tokens": torch.zeros((n_groups, max_new), dtype=torch.int32, device=device),
                "i": 0}

    def step(self, state, logits, key=None) -> StepOut:
        from repro_torch.models import vlm  # the paper's T-I maths lives there

        cond, uncond = logits[0::2], logits[1::2]  # [G, V] each
        mixed = vlm.contrastive_logits(cond, uncond, self.guidance)
        if self.mask_offset is not None:
            mixed = vlm.image_token_mask(self.mask_offset, mixed)
        token = _sampler(self.sampler, self.temperature, self.top_p)(mixed, key)  # [G]
        state["tokens"][:, state["i"]] = token
        new_state = {"tokens": state["tokens"], "i": state["i"] + 1}
        # both streams advance on the same token
        return StepOut(state=new_state, feed=token.repeat_interleave(2), perm=None, done=None)

    def finalize(self, state) -> Dict[str, torch.Tensor]:
        return {"tokens": state["tokens"]}


def n_streams_of(profile: Optional[DecodingProfile]) -> int:
    """Streams a request occupies (1 when it has no profile)."""
    return 1 if profile is None else profile.n_streams
