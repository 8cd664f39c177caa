"""Token samplers of the port. Greedy only so far: per-slot temperature /
top-p sampling with per-(request, token-index) keys is a later slice."""
from __future__ import annotations

import torch


def greedy(logits: torch.Tensor, key=None) -> torch.Tensor:
    """argmax over the vocabulary as int32; ties go to the first index, as
    ``jnp.argmax`` does."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
