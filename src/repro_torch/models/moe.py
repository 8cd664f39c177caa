"""Mixture-of-experts FFN with capacity-based dispatch — the counterpart of
``repro/models/moe.py``: ``moe_ffn`` and the expert-parallel ``moe_ffn_ep``.

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

Under expert parallelism (``ep``, a rank's expert-parallel group,
``tp_pool.ep_group``; ``moe_ffn_ep``) a rank holds experts ``[rank * E / ep,
(rank + 1) * E / ep)`` of its group (``sharding.ep_param_specs``) and the
router and shared experts whole, routes its own tokens, and exchanges them
with its group's ranks in one all-to-all each way: the reference's
single-stage dispatch under ``shard_map``, where the capacity is per expert
and per source, from the rank's own token count.

The expert products are ``torch.bmm`` (the reference leaves them to XLA,
outside any Pallas kernel). At decode every expert's weights are read every
step, mostly for zero rows: the reference's static-capacity dispatch, kept.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

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
            tp=None, ep=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, d] -> (out [B, T, d] in x's type, aux loss f32 scalar).
    Under ``tp`` ``p`` holds the rank's experts and shared columns, and
    ``out`` is reduced over the ranks (one ``all_reduce``). Under ``ep``
    (an expert-parallel group) it is ``moe_ffn_ep``, as the reference's
    ``moe_ffn`` is under ``EP_MESH``."""
    if ep is not None:
        if tp is not None:
            raise ValueError("moe_ffn: ep and tp together (expert parallelism splits the "
                             "experts of whole layers; tensor parallelism is not combined "
                             "with it)")
        return moe_ffn_ep(cfg, p, x, ep, impl)
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


# ---- expert parallelism (the reference's ``moe_ffn_ep``) --------------------

class EPPlan(NamedTuple):
    """A rank's dispatch: each (token, k) assignment's slot in the send
    buffer (``E * cap`` for a dropped one), whether it was kept, and its
    router weight."""

    slot: torch.Tensor  # [n * k]
    keep: torch.Tensor  # [n * k] bool
    flat_w: torch.Tensor  # [n * k] f32


def ep_dispatch(cfg: ModelConfig, p, xf: torch.Tensor):
    """Route a rank's tokens xf [n, d] and pack its send buffer: (x_send
    [E * cap, d] in xf's type, expert-major, so expert e's ``cap`` rows,
    ranked in assignment order, go to the rank that holds e; the rank's
    own aux loss; the ``EPPlan``). Ranks come from ``"sort"`` whatever
    ``dispatch_rank`` says, as the reference's; a dropped assignment goes
    to a dummy row, cut off."""
    m = cfg.moe
    n, d = xf.shape
    e, k = m.n_experts, m.top_k
    probs, top_w, top_ids = route(cfg, p, xf)
    ce = F.one_hot(top_ids[:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(probs.mean(dim=0) * ce) * m.router_aux_weight
    cap = expert_capacity(n, cfg)  # per expert and per source: from the rank's own n
    flat_e = top_ids.reshape(n * k)
    flat_tok = torch.arange(n * k, device=xf.device) // k
    pos = position_in_expert(flat_e, e, "sort")
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos, torch.full_like(pos, e * cap))
    x_send = xf.new_zeros((e * cap + 1, d)).index_put((slot,), xf[flat_tok])[: e * cap]
    return x_send, aux, EPPlan(slot, keep, top_w.reshape(n * k))


def ep_experts(p, x_recv: torch.Tensor, sources: int) -> torch.Tensor:
    """A rank's experts over what its group sent it, x_recv [sources *
    E_loc * cap, d] in source-major order (``[sources, E_loc, cap, d]``):
    each source's rows batched over the experts, with no transpose to
    expert-major order. Returns their outputs in the same order."""
    el, d = p["w1"].shape[0], x_recv.shape[-1]
    xe = x_recv.reshape(sources, el, -1, d)
    ys = []
    for s in range(sources):
        h = F.silu(torch.bmm(xe[s], p["w1"])) * torch.bmm(xe[s], p["w3"])
        ys.append(torch.bmm(h, p["w2"]))
    return torch.stack(ys).reshape(-1, d)


def ep_combine(plan: EPPlan, y_home: torch.Tensor, k: int) -> torch.Tensor:
    """The rank's routed output [n, d] from its send buffer's slots as the
    experts returned them, y_home [E * cap, d]: a gather by slot (a dropped
    assignment reads a zero row), weighted, and each token's k
    contributions added in assignment order in y_home's type (XLA's
    scatter-add order on the CPU; ``index_add_`` on CUDA adds with atomics,
    in no fixed order)."""
    d = y_home.shape[-1]
    gathered = torch.cat([y_home, y_home.new_zeros((1, d))])[plan.slot]
    w = (plan.flat_w * plan.keep.float())[:, None].to(y_home.dtype)
    contrib = (gathered * w).reshape(-1, k, d)
    out = torch.zeros_like(contrib[:, 0])
    for j in range(k):
        out = out + contrib[:, j]
    return out


def moe_ffn_ep(cfg: ModelConfig, p, x: torch.Tensor, ep, impl: str = "auto"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism over ``ep`` (a rank's group, ``tp_pool.ep_group``),
    the reference's ``moe_ffn_ep`` on a rank's tokens x [B, T, d] and its
    experts (``p``: its block of ``w1`` / ``w3`` / ``w2``, the router and
    shared experts whole). Routes the tokens, packs the send buffer
    (``ep_dispatch``), exchanges it in one all-to-all, runs the rank's
    experts on every source's rows (``ep_experts``), exchanges the outputs
    back, combines them in x's type (``ep_combine``), then adds the shared
    experts. The aux loss is the rank's own, averaged over every rank of
    the layout (``ep.whole``). Both exchanges and the mean carry gradients.
    Every rank of the group must hold the same token count (its buffers'
    shapes follow from it): checked, and a mismatch raises on every rank."""
    from repro_torch.distributed import tp_pool

    m = cfg.moe
    b, t, d = x.shape
    n = b * t
    if p["w1"].shape[0] * ep.size != m.n_experts:
        raise ValueError(f"moe_ffn_ep: {p['w1'].shape[0]} experts a rank at ep = {ep.size}, "
                         f"the config has moe.n_experts = {m.n_experts} "
                         "(sharding.ep_param_specs cuts a rank's block)")
    hi, lo = ep.max(n), -ep.max(-n)  # both on every rank, so every rank raises alike
    if hi != n or lo != n:
        raise ValueError(f"moe_ffn_ep: rank {ep.rank} holds {n} tokens and another rank of "
                         "its expert-parallel group holds a different count")
    xf = x.reshape(n, d)
    x_send, aux, plan = ep_dispatch(cfg, p, xf)
    aux = tp_pool.group_mean(aux, ep.whole)
    x_recv = tp_pool.all_to_all(x_send, ep)
    y_home = tp_pool.all_to_all(ep_experts(p, x_recv, ep.size), ep)
    out = ep_combine(plan, y_home, m.top_k)
    if "shared" in p:
        out = out + L.ffn(p["shared"], xf, impl)
    return out.reshape(b, t, d), aux


def moe_ffn_ep_plain(cfg: ModelConfig, p, xs: Sequence[torch.Tensor], ep: int,
                     impl: str = "auto") -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``moe_ffn_ep`` on every rank of a ``(data, ep)`` layout in one
    process, the all-to-alls as reshapes: ``xs`` each rank's x in rank
    order (``len(xs) = data * ep``), ``p`` the layer's whole params.
    Returns (each rank's out, the aux loss), differentiable, bit for bit
    the ranks' on the CPU with the aux summed in rank order as the shared
    slots sum it. Used to hold the ranks against, never by the model."""
    m = cfg.moe
    el = m.n_experts // ep
    plans, sends, aux = [], [], None
    for x in xs:
        x_send, a, plan = ep_dispatch(cfg, p, x.reshape(-1, x.shape[-1]))
        plans.append(plan)
        sends.append(x_send.reshape(ep, -1, x.shape[-1]))
        aux = a if aux is None else aux + a
    outs = []
    for row in range(0, len(xs), ep):
        ys = []
        for j in range(ep):  # rank row + j's experts over its sources' chunks j
            pj = {w: p[w][j * el:(j + 1) * el] for w in ("w1", "w3", "w2")}
            recv = torch.cat([sends[row + s][j] for s in range(ep)])
            ys.append(ep_experts(pj, recv, ep).reshape(ep, -1, recv.shape[-1]))
        for s in range(ep):
            x = xs[row + s]
            y_home = torch.cat([ys[j][s] for j in range(ep)])
            out = ep_combine(plans[row + s], y_home, m.top_k)
            if "shared" in p:
                out = out + L.ffn(p["shared"], x.reshape(-1, x.shape[-1]), impl)
            outs.append(out.reshape(x.shape))
    return outs, aux / len(xs)
