"""Chameleon-style early-fusion VLM (paper §2.1.2) — the counterpart of
``repro/models/vlm.py``.

Images and text are both discrete tokens of one vocabulary, so the model
body is ``models.transformer`` (with qk-norm). This module adds:

- the stubbed VQ image tokenizer: image tokens are ids in [0, image_vocab)
  offset into the tail of the vocabulary (``image_token_offset``);
- the I-T / IT-T prompt layout (1024 image tokens, then the text);
- the contrastive (classifier-free guidance) logits of T-I — the paper's
  "decodes twice at each time step" profile, driven as a
  ``ContrastiveProfile`` by ``engine.run_profile``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

init = transformer.init
init_cache = transformer.init_cache
forward = transformer.forward


def image_token_offset(cfg: ModelConfig) -> int:
    return cfg.vocab_size - cfg.vlm.image_vocab


def encode_image_stub(cfg: ModelConfig, gen: torch.Generator, batch: int,
                      device=None) -> torch.Tensor:
    """Stub VQ tokenizer: [B, n_image_tokens] int32 ids in the image-token
    range, drawn from ``gen`` (a real Chameleon runs its VQ-VAE here)."""
    v = cfg.vlm
    ids = torch.randint(0, v.image_vocab, (batch, v.n_image_tokens), generator=gen,
                        device=device)
    return (image_token_offset(cfg) + ids).to(torch.int32)


def build_it_input(cfg: ModelConfig, image_tokens: torch.Tensor,
                   text_tokens: torch.Tensor) -> torch.Tensor:
    """[image tokens ; text tokens] — the I-T / IT-T prompt layout (paper
    §3.1: 1024 image tokens + question/prompt tokens)."""
    return torch.cat([image_tokens, text_tokens.to(image_tokens.dtype)], dim=1)


def contrastive_logits(cond_logits: torch.Tensor, uncond_logits: torch.Tensor,
                       guidance: float = 3.0) -> torch.Tensor:
    """Contrastive decoding for T-I: ``uncond + g * (cond - uncond)``, the
    conditional stream as the strong model and the unconditional one as the
    weak model."""
    return uncond_logits + guidance * (cond_logits - uncond_logits)


def image_token_mask(offset: int, vocab_logits: torch.Tensor) -> torch.Tensor:
    """Restrict sampling to the image-token range (ids >= ``offset``) during
    T-I generation: every other logit becomes -inf."""
    keep = torch.arange(vocab_logits.shape[-1], device=vocab_logits.device) >= offset
    return torch.where(keep[None, :], vocab_logits,
                       torch.full_like(vocab_logits, float("-inf")))
