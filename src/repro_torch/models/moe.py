"""Mixture-of-experts FFN with capacity-based dispatch — the counterpart of
``repro/models/moe.py`` (``moe_ffn``; the ``shard_map`` expert-parallel
``moe_ffn_ep`` is not ported).

The reference's semantics, kept exactly: an f32 router over EVERY lane the
step carries (free slots' lanes, a mixed or verify step's padding past
``t_new``, a prompt's padding to ``pad_to``), softmax, top-k in
``jax.lax.top_k``'s order (equal probabilities by ascending expert), the
optional renormalisation, the Switch load-balance loss; each (token, k)
assignment ranked within its expert's queue in (token, k) order, kept while
its rank is below the static capacity ``expert_capacity(N)`` and sent to a
dummy overflow slot otherwise; every expert runs on its ``[capacity, d]``
buffer (rows of unused slots zeroed) as one batched matmul, and the outputs
are scatter-added back in f32 with their router weights, then the shared
experts. Every size is static, so the layer makes no host sync: no
``nonzero``, no boolean-mask indexing, no ``.item()``.

Under tensor parallelism (``tp``, a rank's group; ``distributed/tp_pool.py``)
the experts are split on their axis: a rank holds experts ``[rank * E / tp,
(rank + 1) * E / tp)`` and the config keeps all ``E``, so the replicated
router, the top-k, each assignment's rank in its expert's queue, the
capacity and the aux loss are the whole model's on every rank. A rank runs
only its experts' ``[E / tp, capacity, d]`` buffers and scatter-adds them
into an f32 partial; the shared experts are split column / row as a dense
FFN, a second partial. Both partials are reduced in ONE collective (side by
side in f32), then each is cast to the activation type as on one device:
one reduce a MoE layer.

The expert products are ``torch.bmm`` (the reference leaves them to XLA,
outside any Pallas kernel). At decode every expert's weights are read every
step, mostly for zero rows: the reference's static-capacity dispatch, kept.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def init_moe(gen, cfg: ModelConfig, device):
    m = cfg.moe
    dt = L.param_dtype(cfg)
    d, e, f = cfg.d_model, m.n_experts, m.d_ff_expert
    scale = d ** -0.5
    p = {
        "router": {"w": L._normal(gen, (d, e), device) * scale},  # f32, loss-bearing
        "w1": (L._normal(gen, (e, d, f), device) * scale).to(dt),
        "w3": (L._normal(gen, (e, d, f), device) * scale).to(dt),
        "w2": (L._normal(gen, (e, f, d), device) * f ** -0.5).to(dt),
    }
    if m.n_shared_experts:
        p["shared"] = L.ffn_init(gen, d, m.n_shared_experts * f, dt, device)
    return p


def position_in_expert(flat_e: torch.Tensor, e: int, method: str) -> torch.Tensor:
    """Rank of each (token, k) assignment within its expert's queue, in
    assignment order. ``cumsum``: a one-hot running count; ``sort``: a
    stable sort groups the assignments by expert and the rank is the index
    within the group. Both give the same ranks."""
    nk = flat_e.shape[0]
    if method == "cumsum":
        onehot = F.one_hot(flat_e, e).to(torch.int32)  # [N*K, E]
        pos = torch.cumsum(onehot, dim=0) - 1
        return torch.gather(pos, 1, flat_e[:, None])[:, 0]
    if method != "sort":
        raise ValueError(f"unknown dispatch_rank {method!r}")
    sorted_e, order = torch.sort(flat_e, stable=True)
    starts = torch.searchsorted(sorted_e, torch.arange(e, device=flat_e.device), side="left")
    pos_sorted = torch.arange(nk, device=flat_e.device) - starts[sorted_e]
    return torch.zeros_like(flat_e).scatter_(0, order, pos_sorted)


def expert_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = int(m.capacity_factor * n_tokens * m.top_k / m.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8, floor 8


def route(cfg: ModelConfig, p, xf: torch.Tensor):
    """The f32 router over xf [N, d]: (probs [N, E], top-k weights [N, K]
    renormalised as configured, top-k experts [N, K])."""
    m = cfg.moe
    probs = torch.softmax(xf.float() @ p["router"]["w"].float(), dim=-1)
    # jax.lax.top_k's order: a stable descending sort keeps equal
    # probabilities in ascending expert order (torch.topk does not promise it)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_ids = vals[:, : m.top_k], ids[:, : m.top_k]
    if m.normalize_router_weights:
        top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return probs, top_w, top_ids


def moe_ffn(cfg: ModelConfig, p, x: torch.Tensor, impl: str = "auto",
            tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, d] -> (out [B, T, d] in x's type, aux loss f32 scalar).
    Under ``tp`` ``p`` holds the rank's experts and shared columns, and
    ``out`` is reduced over the ranks (one ``all_reduce``)."""
    m = cfg.moe
    b, t, d = x.shape
    n = b * t
    e, k = m.n_experts, m.top_k
    xf = x.reshape(n, d)
    dev = x.device

    probs, top_w, top_ids = route(cfg, p, xf)
    # Switch-style load-balance loss: mean router probability per expert
    # times the fraction of tokens whose top-1 it is
    ce = F.one_hot(top_ids[:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(probs.mean(dim=0) * ce) * m.router_aux_weight

    cap = expert_capacity(n, cfg)
    flat_e = top_ids.reshape(n * k)
    flat_w = top_w.reshape(n * k)
    flat_tok = torch.arange(n * k, device=dev) // k
    pos = position_in_expert(flat_e, e, m.dispatch_rank)
    slot = torch.where(pos < cap, flat_e * cap + pos, torch.full_like(pos, e * cap))

    # a kept assignment owns its slot alone; dropped ones all land on the
    # dummy slot e * cap, cut off below
    tok_of_slot = torch.zeros(e * cap + 1, dtype=torch.long, device=dev).scatter_(
        0, slot, flat_tok)[: e * cap]
    w_of_slot = torch.zeros(e * cap + 1, dtype=torch.float32, device=dev).scatter_(
        0, slot, flat_w)[: e * cap]
    used = torch.zeros(e * cap + 1, dtype=torch.float32, device=dev).scatter_(
        0, slot, torch.ones_like(flat_w))[: e * cap]

    # the slots of the experts this rank holds (all of them on one device)
    el = p["w1"].shape[0]
    mine = slice(0, e * cap) if tp is None else slice(tp.rank * el * cap,
                                                      (tp.rank + 1) * el * cap)
    tok_of_slot, w_of_slot, used = tok_of_slot[mine], w_of_slot[mine], used[mine]
    xe = xf[tok_of_slot].reshape(el, cap, d) * used.reshape(el, cap, 1).to(x.dtype)
    h = F.silu(torch.bmm(xe, p["w1"])) * torch.bmm(xe, p["w3"])
    ye = torch.bmm(h, p["w2"]).reshape(el * cap, d)
    out = torch.zeros((n, d), dtype=torch.float32, device=dev).index_add_(
        0, tok_of_slot, ye.float() * (w_of_slot * used)[:, None])
    shared = L.ffn(p["shared"], xf, impl, tp, reduce=False) if "shared" in p else None
    if tp is not None:  # one reduce: the routed and the shared partials side by side
        if shared is None:
            out = tp.all_reduce(out)
        else:
            both = tp.all_reduce(torch.cat([out, shared.float()], -1))
            out, shared = both[:, :d], both[:, d:].to(x.dtype)
    out = out.to(x.dtype)
    if shared is not None:
        out = out + shared
    return out.reshape(b, t, d), aux
