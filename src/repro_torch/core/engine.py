"""Generation engine: the step primitives and ONE profile-driven decode
loop — the counterpart of ``repro/core/engine.py`` for the contiguous cache.

Step primitives (shared with the continuous-batching scheduler):

- ``prefill``     — prompt (and ``extra`` inputs such as encoder frames) ->
                    fresh cache + last-position logits. With batch=1 this is
                    the scheduler's single-slot refill.
- ``decode_step`` — one decode step for every sequence slot; the cache is
                    updated in place (the reference donates it).
- ``mixed_step``  — one token-budget mixed prefill/decode step over a paged
                    pool (chunked prefill): every slot advances by its own
                    ``t_new`` tokens in the same forward.
- ``verify_step`` — one speculative verification step over either pool:
                    every slot scores its drafted window in one full-model
                    forward and gets every lane's logits back.

Decoding strategies are ``DecodingProfile`` specs (core/profiles.py) driven
by one loop, :func:`run_profile`: prefill the profile's expanded streams
once, then replay ``decode_step``, with the profile choosing each stream's
next token, an optional cache permutation (beam's Obs #4 KV reorder) and
the finish condition; the loop splits its key once a step, as the reference
does, and hands the profile the new half. The public engines build the
profile:

- ``generate``             — ``SamplingProfile`` (Llama / Chameleon I-T);
                             ``tokens`` is always [B, max_new_tokens],
                             padded with the fill token after an early exit.
- ``generate_beam``        — ``BeamProfile`` (Seamless, Obs #4), the
                             reorder in place (``donate_reorder``) or into
                             fresh tensors.
- ``generate_contrastive`` — ``ContrastiveProfile`` (Chameleon T-I): two
                             streams, two forwards a step (§2.1.2).

:func:`generate_scanned` is the whole-generation-as-one-program engine (the
reference's ``lax.scan`` decode): a prefill, then one static decode step
(``decode_step`` plus the sampler and the token's write into the output)
that on a CUDA device is captured as a CUDA graph and replayed once a token,
with one host sync at the end.

The tensor-parallel step family (``tp_prefill``, ``tp_decode_step``,
``tp_mixed_step``, ``tp_verify_step``; ``distributed/tp_pool.py``) has the
same signatures and runs one rank's share of a step: the model is the
rank's (its widths, its group), the params its shard, the cache its KV
heads (a hybrid's: its RG-LRU channels and its ring rows, or the whole
ring). Each runs the step above, whose forward reduces after every
row-parallel linear, and then gathers the rank's vocab slice of the logits
whole (``layers.gather_vocab``; nothing to gather where the LM head is
whole), after ``_last_logits`` has picked the positions that are read.

Everything else runs eagerly under ``torch.inference_mode()``. LayerSkip's draft
and batch engine live in core/layerskip.py on these primitives.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.analysis.hotpath import hot_path
from repro_torch.core import graphs, kv_cache, prng, profiles, sampling
from repro_torch.kernels import counts
from repro_torch.models import layers as L
from repro_torch.models.registry import Model


def _last_logits(logits: torch.Tensor, prompt_lengths: torch.Tensor) -> torch.Tensor:
    """Gather the logits at each sequence's final prompt position."""
    idx = torch.clamp(prompt_lengths.long() - 1, min=0)
    return logits[torch.arange(logits.shape[0], device=logits.device), idx]


@torch.inference_mode()
def prefill(model: Model, params, tokens: torch.Tensor, prompt_lengths: torch.Tensor,
            max_len: int, impl: str = "auto", extra: Optional[Dict[str, torch.Tensor]] = None):
    """Prompt -> (last-position logits [B, V], fresh cache on the tokens'
    device). ``extra`` joins the forward's batch (an encoder-decoder's
    ``frames`` and ``frame_lengths``)."""
    cache = model.init_cache(tokens.shape[0], max_len, tokens.device)
    batch = {"tokens": tokens, "prompt_lengths": prompt_lengths}
    if extra:
        batch.update(extra)
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
def mixed_step(model: Model, params, cache, tokens: torch.Tensor, t_new: torch.Tensor,
               lengths: torch.Tensor):
    """One mixed prefill/decode step over a paged pool: tokens [B, C] holds
    each slot's lanes (a decoding slot's last token in lane 0 with t_new 1,
    a prefilling slot's next prompt chunk in lanes 0..t_new-1, idle rows
    t_new 0). ``lengths`` [B] is the host's authoritative write position of
    every slot: the device counters, which plain decode steps drift on free
    and mid-prefill rows, are pinned to it in place before any write.
    Returns (logits [B, V] at each slot's last valid lane, cache), the
    cache's ``lengths`` advanced by ``t_new``."""
    cache["lengths"].copy_(lengths)
    logits, cache, _ = model.forward(params, {"tokens": tokens, "t_new": t_new},
                                     cache=cache, mode="mixed")
    return logits[:, 0], cache


@torch.inference_mode()
def verify_step(model: Model, params, cache, tokens: torch.Tensor, t_new: torch.Tensor,
                lengths: torch.Tensor):
    """One speculative verification step over the whole pool: tokens [B, C]
    holds each slot's window (lane 0 its last committed token, lanes
    1..t_new-1 its drafts; t_new 1 is a plain decode lane, 0 an idle row).
    ``lengths`` [B] is the host's write position of every slot, pinned in
    place as ``mixed_step`` pins it. Returns every lane's logits [B, C, V]
    (lane j's sample the token at position lengths + j + 1) and the cache,
    the whole window written and ``lengths`` advanced by ``t_new``: the
    caller rewinds the rejected suffix on the host."""
    cache["lengths"].copy_(lengths)
    logits, cache, _ = model.forward(params, {"tokens": tokens, "t_new": t_new},
                                     cache=cache, mode="verify")
    return logits, cache


# --------------------------------------------------------------------------
# the tensor-parallel step family (distributed/tp_pool.py)
# --------------------------------------------------------------------------

@torch.inference_mode()
def tp_prefill(model: Model, params, tokens: torch.Tensor, prompt_lengths: torch.Tensor,
               max_len: int, impl: str = "auto",
               extra: Optional[Dict[str, torch.Tensor]] = None):
    """``prefill`` on one rank: the fresh cache holds the rank's KV heads,
    and the last positions' logits are gathered over the vocab after
    ``_last_logits`` picked them (never the [B, T, V] block)."""
    logits, cache = prefill(model, params, tokens, prompt_lengths, max_len, impl, extra)
    return L.gather_vocab(logits, model.tp, model.config.vocab_size), cache


@torch.inference_mode()
def tp_decode_step(model: Model, params, cache, token: torch.Tensor, impl: str = "auto"):
    """``decode_step`` on one rank, the logits gathered over the vocab."""
    logits, cache = decode_step(model, params, cache, token, impl)
    return L.gather_vocab(logits, model.tp, model.config.vocab_size), cache


@torch.inference_mode()
def tp_mixed_step(model: Model, params, cache, tokens: torch.Tensor, t_new: torch.Tensor,
                  lengths: torch.Tensor):
    """``mixed_step`` on one rank, each slot's last-lane logits gathered
    over the vocab."""
    logits, cache = mixed_step(model, params, cache, tokens, t_new, lengths)
    return L.gather_vocab(logits, model.tp, model.config.vocab_size), cache


@torch.inference_mode()
def tp_verify_step(model: Model, params, cache, tokens: torch.Tensor, t_new: torch.Tensor,
                   lengths: torch.Tensor):
    """``verify_step`` on one rank, every lane's logits gathered over the
    vocab."""
    logits, cache = verify_step(model, params, cache, tokens, t_new, lengths)
    return L.gather_vocab(logits, model.tp, model.config.vocab_size), cache


# --------------------------------------------------------------------------
# the ONE profile-driven decode loop
# --------------------------------------------------------------------------

@hot_path
@torch.inference_mode()
def run_profile(
    model: Model,
    params,
    profile: profiles.DecodingProfile,
    prompt_tokens: torch.Tensor,  # [G, Tp] per-group prompts (right-padded)
    *,
    prompt_lengths: Optional[torch.Tensor] = None,
    max_new_tokens: int = 32,
    max_len: Optional[int] = None,
    key: Optional[torch.Tensor] = None,
    extra_inputs: Optional[Dict[str, torch.Tensor]] = None,
    reorder: Optional[Callable[[Any, torch.Tensor], Any]] = None,
    impl: str = "auto",
) -> Dict[str, Any]:
    """Drive one decoding profile batch-at-a-time: expand the G group
    prompts to the [G * n_streams] stream layout, prefill once, then replay
    ``decode_step``, with the profile choosing each stream's next token,
    the optional cache permutation (applied by ``reorder``, by default
    ``kv_cache.reorder_donated``) and the finish condition. ``key`` (default
    ``PRNGKey(0)``) is split once a step on the host, the second half going
    to the profile. One host sync a step, for ``done``. Returns the
    profile's ``finalize`` output plus ``cache`` and ``n_steps``
    (decode-loop iterations actually run)."""
    g, tp = prompt_tokens.shape
    dev = prompt_tokens.device
    if prompt_lengths is None:
        prompt_lengths = torch.full((g,), tp, dtype=torch.int32, device=dev)
    if max_len is None:
        max_len = tp + max_new_tokens + 1
    # repro-lint: disable=HS001 — the caller's key, moved to the host once before the loop
    key = prng.PRNGKey(0) if key is None else key.cpu()
    reorder = reorder if reorder is not None else kv_cache.reorder_donated

    toks_s, lens_s, extra_s = profile.expand_prompts(prompt_tokens, prompt_lengths,
                                                     extra_inputs)
    logits, cache = prefill(model, params, toks_s, lens_s, max_len, impl, extra_s)
    state = profile.init(g, max_new_tokens, dev)
    n_steps, halt, feed = 0, False, None
    for i in range(max_new_tokens):
        if i > 0:
            if halt:
                break
            logits, cache = decode_step(model, params, cache, feed, impl)
        key, sub = prng.split(key)
        out = profile.step(state, logits, sub)
        state, feed = out.state, out.feed
        if out.perm is not None:  # Obs #4: the KV_Cache_Reorder op
            cache = reorder(cache, out.perm)
        n_steps += 1
        # the loop's one host sync per step: a single scalar transfer
        halt = out.done is not None and bool(out.done.all().item())  # repro-lint: disable=HS001
    result = profile.finalize(state)
    result.update(cache=cache, n_steps=n_steps)
    return result


# --------------------------------------------------------------------------
# the whole generation as one replayed program
# --------------------------------------------------------------------------

class ScannedStep:
    """The static decode step of :func:`generate_scanned`: ``decode_step``
    on the prefill's cache (K/V written in place; the fresh ``lengths`` and
    any recurrent state copied back into the cache's own tensors,
    ``kv_cache.write_back``), the sampler under step ``i``'s key, the
    token written into column ``i + 1`` of ``out`` and fed back, and the
    device step counter ``i`` advanced. Every input it reads is device
    state it owns, so one call can be captured and replayed."""

    def __init__(self, model: Model, params, cache, token: torch.Tensor, out: torch.Tensor,
                 keys: torch.Tensor, sampler: sampling.Sampler, impl: str):
        self.model, self.params, self.cache = model, params, cache
        self.token, self.out, self.keys = token, out, keys
        self.sampler, self.impl = sampler, impl
        self.i = torch.zeros((1,), dtype=torch.int64, device=token.device)

    def __call__(self) -> None:
        logits, new = decode_step(self.model, self.params, self.cache, self.token, self.impl)
        kv_cache.write_back(self.cache, new)
        nxt = self.sampler(logits, self.keys.index_select(0, self.i)[0]).to(torch.int32)
        self.token.copy_(nxt)
        self.out.index_copy_(1, self.i + 1, nxt[:, None])
        self.i.add_(1)

    def state(self):
        """What one call changes besides the K/V row at ``lengths`` (which
        the next call writes again): every cache leaf but the K/V buffers
        (lengths, recurrent state), the token and the step counter."""
        kv = {id(t) for layer in self.cache.get("layers", []) if isinstance(layer, dict)
              for name, t in layer.items() if name in ("k", "v", "latent")}
        return [t for t in kv_cache.leaves(self.cache) if id(t) not in kv] + [self.token, self.i]


@torch.inference_mode()
def generate_scanned(
    model: Model,
    params,
    prompt_tokens: torch.Tensor,  # [B, Tp]
    *,
    max_new_tokens: int = 32,
    sampler: sampling.Sampler = sampling.greedy,
    key: Optional[torch.Tensor] = None,
    extra_inputs: Optional[Dict[str, torch.Tensor]] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Whole-generation-as-one-program decoding (the reference's
    ``generate_scanned``): every prompt at its full length ``Tp``, one
    prefill into a cache of ``Tp + max_new_tokens + 1`` rows, the first
    token sampled under ``key`` itself (default ``PRNGKey(0)``), then
    ``max_new_tokens - 1`` decode steps under ``prng.split(key,
    max_new_tokens - 1)``, split on the host once and staged to the device in
    one copy. Returns the tokens [B, max_new_tokens].

    On a CUDA device the step (:class:`ScannedStep`) is warmed up, captured
    as one CUDA graph and replayed once a token, with one host sync after
    the loop; a step that cannot be captured raises. The kernel wrappers'
    launch counters advance by the captured step's counts once a replay, so
    they read what the eager loop launches. On the CPU the same step runs
    eagerly."""
    b, tp = prompt_tokens.shape
    dev = prompt_tokens.device
    prompt_lengths = torch.full((b,), tp, dtype=torch.int32, device=dev)
    key = prng.PRNGKey(0) if key is None else key.cpu()
    max_len = tp + max_new_tokens + 1
    logits, cache = prefill(model, params, prompt_tokens, prompt_lengths, max_len, impl,
                            extra_inputs)
    out = torch.zeros((b, max_new_tokens), dtype=torch.int32, device=dev)
    token = sampler(logits, key.to(dev)).to(torch.int32)
    out[:, 0] = token
    n = max_new_tokens - 1
    if n <= 0:
        return out
    step = ScannedStep(model, params, cache, token, out, prng.split(key, n).to(dev), sampler,
                       impl)
    if dev.type != "cuda":
        for _ in range(n):
            step()
        return out
    saved = [t.clone() for t in step.state()]

    def undo_warmup():
        for t, s in zip(step.state(), saved):
            t.copy_(s)

    graph, _, per_step = graphs.capture(step, restore=undo_warmup)
    for _ in range(n):
        graph.replay()
    counts.add(per_step, n)
    torch.cuda.current_stream(dev).synchronize()  # the loop's one host sync
    return out


# --------------------------------------------------------------------------
# the engines, each a profile over run_profile
# --------------------------------------------------------------------------

def generate(
    model: Model,
    params,
    prompt_tokens: torch.Tensor,  # [B, Tp] right-padded
    *,
    prompt_lengths: Optional[torch.Tensor] = None,
    max_new_tokens: int = 32,
    sampler: sampling.Sampler = sampling.greedy,
    key: Optional[torch.Tensor] = None,
    eos_id: Optional[int] = None,
    live: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> Dict[str, Any]:
    """Generation, a ``SamplingProfile`` through :func:`run_profile`, each
    token drawn by ``sampler`` under the step's key: ``live`` [B] marks real
    rows (dead rows emit only the fill token, EOS
    when set else 0, and never block the all-done exit); ``tokens`` is
    ALWAYS [B, max_new_tokens], padded with the fill token after an early
    exit; ``n_steps`` counts the steps actually run."""
    prof = profiles.SamplingProfile(eos_id=eos_id, sampler=sampler, live=live)
    out = run_profile(model, params, prof, prompt_tokens, prompt_lengths=prompt_lengths,
                      max_new_tokens=max_new_tokens, key=key, impl=impl)
    return {"tokens": out["tokens"], "cache": out["cache"], "n_steps": out["n_steps"]}


def generate_beam(
    model: Model,
    params,
    *,
    batch: Optional[int] = None,
    n_beams: int,
    bos_id: Optional[int] = None,
    eos_id: int,
    max_new_tokens: int,
    prompt_tokens: Optional[torch.Tensor] = None,  # [B, Tp]; default [bos]
    prompt_lengths: Optional[torch.Tensor] = None,
    extra_inputs: Optional[Dict[str, torch.Tensor]] = None,
    donate_reorder: bool = True,
    impl: str = "auto",
) -> Dict[str, Any]:
    """Beam search with a per-step KV reorder, as a ``BeamProfile``. Inputs
    (e.g. encoder frames) are tiled across beams; each step gathers the
    cache along the batch axis by the surviving-parent permutation (paper
    Obs #4): in place by default (``reorder_donated``, the optimized
    ``copy_`` form), or into fresh tensors when ``donate_reorder=False``
    (``reorder_realloc``, the paper's ``index_select`` baseline). Without
    ``prompt_tokens`` every group prefills ``[bos_id]``, on the params'
    device."""
    if prompt_tokens is None:
        if batch is None or bos_id is None:
            raise ValueError("need prompt_tokens, or batch + bos_id")
        device = next(kv_cache.leaves(params)).device
        prompt_tokens = torch.full((batch, 1), bos_id, dtype=torch.int32, device=device)
    prof = profiles.BeamProfile(n_beams=n_beams, eos_id=eos_id)
    out = run_profile(
        model, params, prof, prompt_tokens, prompt_lengths=prompt_lengths,
        max_new_tokens=max_new_tokens, extra_inputs=extra_inputs,
        reorder=kv_cache.reorder_donated if donate_reorder else kv_cache.reorder_realloc,
        impl=impl,
    )
    return {"tokens": out["tokens"], "scores": out["scores"], "n_steps": out["n_steps"]}


def generate_contrastive(
    model: Model,
    params,
    prompt_tokens: torch.Tensor,  # [B, Tp] conditional (text) prompt
    *,
    uncond_token: int,
    n_image_tokens: int,
    guidance: float = 3.0,
    sampler: sampling.Sampler = sampling.greedy,
    key: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> Dict[str, Any]:
    """Chameleon T-I as a ``ContrastiveProfile``: the conditional stream
    sees the prompt, the unconditional stream a null prompt; each step runs
    both (the paper's "decodes twice at each time step"), mixes their logits
    and feeds the same image token, drawn by ``sampler``, to both. On VLM configs the token
    is restricted to the image-token range; other families run plain
    classifier-free guidance."""
    cfg = model.config
    mask_offset = None
    if cfg.vlm is not None:
        from repro_torch.models import vlm

        mask_offset = vlm.image_token_offset(cfg)
    prof = profiles.ContrastiveProfile(uncond_token=uncond_token, guidance=guidance,
                                       mask_offset=mask_offset, sampler=sampler)
    tp = prompt_tokens.shape[1]
    out = run_profile(model, params, prof, prompt_tokens, max_new_tokens=n_image_tokens,
                      max_len=tp + n_image_tokens + 1, key=key, impl=impl)
    return {"tokens": out["tokens"], "n_steps": out["n_steps"]}
