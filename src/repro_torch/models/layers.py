"""Shared model primitives: inits, RMSNorm, RoPE, sinusoid positions,
SwiGLU, embeddings and the loss — counterparts of ``repro/models/layers.py``.

Params are nested dicts of tensors with the JAX tree paths as names, and
the JAX layout: ``dense`` weights are ``[d_in, d_out]`` applied as
``x @ w``, or an AutoQuant'd int8 linear (``core/quantization.py``).
Param dtype follows ``cfg.dtype``; norms and RoPE run in f32, the tied
unembed in f32.

Under tensor parallelism (``tp``, a rank's ``TPGroup``) the embedding and
the LM head are vocab-split (each rank holds ``V / tp`` rows or columns)
when ``V`` splits, else whole on every rank, as the reference's specs
leave them: ``embed`` looks up the rank's rows and reduces,
``gather_vocab`` puts each rank's logits slice in place and reduces (a
whole leaf takes neither); ``row_parallel`` reduces a
row-parallel linear's output (``dense``'s ``row_group`` marks one for an
AutoQuant'd ``dyn`` linear's whole-row activation scale), so each sublayer
returns its output reduced. Each sum has one nonzero term but for the row
reduces, so the embedding and the logits come out exact.

Serving keeps an f32 copy of a non-f32 tied table (``table_f32``, see
``add_f32_table``); it is not a parameter. Training runs on the
reference's tree without it (``drop_f32_table``), so the unembed converts
``table`` inside the graph and its gradient lands on ``table`` itself.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import qdense
from repro_torch.kernels import ops

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"unsupported param dtype {cfg.dtype!r}")
    return _DTYPES[cfg.dtype]


def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)


def dense_init(gen, d_in: int, d_out: int, dtype, device, bias: bool = False):
    p = {"w": (_normal(gen, (d_in, d_out), device) * d_in ** -0.5).to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(p, x: torch.Tensor, impl: str = "auto", row_group=None) -> torch.Tensor:
    """``x @ w (+ b)``; an AutoQuant'd linear (no ``"w"``) goes through
    ``core.quantization.qdense``, whose int8 GEMMs dispatch on ``impl``.
    ``row_group``: the tensor-parallel group a row-parallel linear's K axis
    is split over (``qdense``)."""
    if "w" not in p:
        return qdense(p, x, impl=impl, row_group=row_group)
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def row_parallel(p, x: torch.Tensor, impl: str = "auto", tp=None) -> torch.Tensor:
    """A row-parallel linear (``attn/wo``, ``ffn/w2``): under ``tp`` ``x``
    holds the rank's slice of K and the ranks' partial outputs are summed,
    in place; ``dense`` itself without a group."""
    y = dense(p, x, impl, row_group=tp)
    return y if tp is None else tp.all_reduce(y)


def embedding_init(gen, vocab: int, d: int, dtype, device):
    return {"table": _normal(gen, (vocab, d), device).to(dtype)}


def embed(p, tokens: torch.Tensor, tp=None, vocab: Optional[int] = None) -> torch.Tensor:
    """Rows of ``table`` for ``tokens``. Vocab-parallel under a group of
    more than one rank whose table holds fewer than ``vocab`` rows: the
    rank's table holds rows ``[rank * n, (rank + 1) * n)``; tokens outside
    them look up zeros, and the reduce sums the one rank's row with zeros,
    exactly. A table left whole (a vocabulary that does not split, as the
    reference's specs leave it) is looked up with no reduce."""
    table = p["table"]
    if tp is None or tp.size == 1 or table.shape[0] == vocab:
        return table[tokens]
    n = table.shape[0]
    local = tokens.long() - tp.rank * n
    mine = (local >= 0) & (local < n)
    x = torch.where(mine[..., None], table[torch.clamp(local, 0, n - 1)],
                    torch.zeros((), dtype=table.dtype, device=table.device))
    return tp.all_reduce(x)


def gather_vocab(logits: torch.Tensor, tp=None, vocab: Optional[int] = None) -> torch.Tensor:
    """The whole vocabulary's logits from each rank's slice [..., V / tp]:
    each rank writes its slice into a zero-filled [..., V] f32 buffer and
    the reduce sums them, exactly. Without a group (or with one rank), or
    when they already span ``vocab`` (an LM head left whole), the logits
    themselves."""
    if tp is None or tp.size == 1 or logits.shape[-1] == vocab:
        return logits
    n = logits.shape[-1]
    out = torch.zeros(logits.shape[:-1] + (n * tp.size,), dtype=torch.float32,
                      device=logits.device)
    out[..., tp.rank * n:(tp.rank + 1) * n] = logits
    return tp.all_reduce(out)


def gather_last(x: torch.Tensor, tp=None) -> torch.Tensor:
    """The ranks' slices [..., n] of a column-split activation put whole,
    [..., n * size] in ``x``'s type: each rank writes its slice into a
    zero-filled buffer and the reduce sums them, exactly (a hybrid rank's
    post-conv channels for the RG-LRU gates, its q heads for a split ring's
    decode). ``x`` itself without a group or with one rank."""
    if tp is None or tp.size == 1:
        return x
    n = x.shape[-1]
    out = torch.zeros(x.shape[:-1] + (n * tp.size,), dtype=x.dtype, device=x.device)
    out[..., tp.rank * n:(tp.rank + 1) * n] = x
    return tp.all_reduce(out)


def add_f32_table(p) -> None:
    """Keep an f32 copy of a non-f32 tied table beside it (``table_f32``),
    so the f32 unembed reads it instead of converting the table on every
    step; an f32 table needs no copy."""
    if p["table"].dtype != torch.float32:
        p["table_f32"] = p["table"].float()


def drop_f32_table(params: dict) -> dict:
    """``params`` as the reference's tree: without the serving-only
    ``table_f32`` beside ``params["embed"]["table"]`` (a shallow copy; the
    tensors are shared)."""
    embed = params.get("embed")
    if not isinstance(embed, dict) or "table_f32" not in embed:
        return params
    return dict(params, embed={k: v for k, v in embed.items() if k != "table_f32"})


def with_f32_table(cfg: ModelConfig, params: dict) -> dict:
    """The reference's tree (trained params, a restored checkpoint) made
    ready to serve: a tied model's embedding gets its f32 unembed copy back,
    as the family's ``init`` gives it (a shallow copy; the tensors are
    shared)."""
    if not cfg.tie_embeddings or "embed" not in params:
        return params
    embed = {k: v for k, v in params["embed"].items() if k != "table_f32"}
    with torch.no_grad():
        add_f32_table(embed)
    return dict(params, embed=embed)


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    """Tied LM head: logits = x @ table^T in f32 (stable softmax/argmax);
    a rank's vocab slice under tensor parallelism (``gather_vocab``)."""
    table = p.get("table_f32", p["table"])
    return x.float() @ table.float().T


def rmsnorm_init(d: int, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5, impl: str = "auto") -> torch.Tensor:
    return ops.rmsnorm(x, p["scale"], eps=eps, impl=impl)


def add_rmsnorm(p, x: torch.Tensor, r: torch.Tensor, eps: float = 1e-5, impl: str = "auto"):
    """``(x + r, rmsnorm(x + r))``: a residual add and the norm after it."""
    return ops.add_rmsnorm(x, r, p["scale"], eps=eps, impl=impl)


def mul_rmsnorm(p, a: torch.Tensor, u: torch.Tensor, eps: float = 1e-5,
                impl: str = "auto") -> torch.Tensor:
    return ops.mul_rmsnorm(a, u, p["scale"], eps=eps, impl=impl)


def mul_silu_rmsnorm(p, y: torch.Tensor, z: torch.Tensor, eps: float = 1e-5,
                     impl: str = "auto") -> torch.Tensor:
    return ops.mul_silu_rmsnorm(y, z, p["scale"], eps=eps, impl=impl)


# ---- RoPE -----------------------------------------------------------------

def rope_frequencies(dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, T, H, D]; positions: [B, T]. Llama-style rotate-half (not
    interleaved), angles in f32."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, device=x.device)  # [D/2]
    angles = positions[..., None].float() * freqs  # [B, T, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoid_positions(n: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings [n, d] in f32: ``[sin,
    cos]`` of ``pos * exp(-ln(10000) i / (d/2 - 1))``; the caller casts them
    to its input's type."""
    half = d // 2
    i = torch.arange(half, dtype=torch.float32, device=device)
    freq = torch.exp(-torch.log(torch.tensor(10_000.0, device=device)) * i / (half - 1))
    args = torch.arange(n, dtype=torch.float32, device=device)[:, None] * freq[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


# ---- SwiGLU FFN -----------------------------------------------------------

def ffn_init(gen, d: int, d_ff: int, dtype, device):
    return {
        "w1": dense_init(gen, d, d_ff, dtype, device),
        "w3": dense_init(gen, d, d_ff, dtype, device),
        "w2": dense_init(gen, d_ff, d, dtype, device),
    }


def ffn(p, x: torch.Tensor, impl: str = "auto", tp=None, reduce: bool = True) -> torch.Tensor:
    """SwiGLU; under ``tp`` the rank's columns of ``w1`` / ``w3`` and rows of
    ``w2``: the output reduced over the ranks, or with ``reduce=False`` the
    rank's partial sum (a MoE layer's shared experts, which it reduces
    beside its routed partial)."""
    h = F.silu(dense(p["w1"], x, impl)) * dense(p["w3"], x, impl)
    if reduce:
        return row_parallel(p["w2"], h, impl, tp)
    return dense(p["w2"], h, impl, row_group=tp)


def cross_entropy_loss(
    logits: torch.Tensor,  # [B, T, V]
    labels: torch.Tensor,  # [B, T]
    mask: Optional[torch.Tensor] = None,  # [B, T]
) -> torch.Tensor:
    """Mean next-token NLL in f32 (f32 log-softmax, the labels' entries
    gathered); with ``mask``, the masked sum over ``max(mask.sum(), 1)``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
