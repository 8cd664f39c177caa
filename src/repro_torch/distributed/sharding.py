"""Sharding rules: param / optimizer / activation / cache specs for a mesh
of named axes (pod, data, model) — the port's copy of the rules in
``repro/distributed/sharding.py``, over the port's trees.

A tree is nested dicts, lists and NamedTuples whose leaves have a
``shape`` (tensors, meta tensors, arrays). A *spec* is a plain tuple with
one entry per dim of its leaf, each an axis name, a tuple of axis names or
None, the form of a JAX ``PartitionSpec``; ``()`` replicates the leaf. A
*mesh* is anything with ``shape`` (axis name -> size) and ``axis_names``:
:class:`MeshShape`, or the reference's ``Mesh``.

Baseline scheme (megatron-style TP + expert parallel + DP):

- ``data`` (+ ``pod``): the batch dim of every activation and KV cache;
- ``model``: tensor parallel — attention q/k/v columns and o rows on the
  flattened head dim, the FFN hidden dim, the vocab dim of the embedding
  and LM head, the expert dim of MoE stacks, MLA's up projections.

Rules match leaves by *path pattern* (``"layers/3/attn/wq/w"``), with
divisibility guards: a dim is split only if the axis size divides it.
Scanned ``[L, ...]`` stacks keep the rule counted from the end, so the
layer axis is never split.

TP serving (``distributed/tp_pool.py``) reuses the same rules on a 1-D
``("model",)`` mesh of ``tp`` ranks: params by :func:`param_specs` with
``enable_tp=True`` (:func:`tp_param_specs` adds the port's own leaves and a
Mamba-2 mixer's head-aligned layout, :func:`tp_rank_index`), the
KV pool by :func:`cache_specs_tp` (the head axis, else its sequence-axis
fallback: the hybrid's one-head ring, split along its rows where they
divide the ranks and whole on every rank where they do not; MLA's
``latent`` matches no KV leaf and stays whole), and :func:`shard_tree`
cuts each rank's slice, the counterpart of ``device_put`` under a
``NamedSharding``. Expert parallelism (``moe.moe_ffn_ep``) cuts every MoE
layer's routed experts into contiguous blocks on the expert axis and keeps
every other leaf whole (:func:`ep_param_specs`, the reference's ``pspec``).
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig

# params smaller than this stay fully replicated (pure data parallel):
# whisper-base, mamba2-130m, hstu — TP gains nothing at this scale.
TP_MIN_PARAMS = 1_000_000_000

Spec = Tuple[Any, ...]


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axes and sizes, with no devices: ``MeshShape({"model": 2})``."""

    axes: Dict[str, int] = field(default_factory=dict)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axes)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.axes)


def _entry(axes: Tuple[str, ...]):
    """One dim's spec entry for ``axes``: a single axis by its name, as
    ``PartitionSpec`` normalises it, several as a tuple."""
    return axes[0] if len(axes) == 1 else axes


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_spec(mesh, batch: int, rank: int = 2, include_model: bool = False) -> Spec:
    """Spec for a [B, ...] activation: the batch over (pod, data) when
    divisible — plus 'model' for pure-FSDP layouts — else replicated."""
    daxes = data_axes(mesh)
    if include_model and "model" in mesh.axis_names:
        daxes = daxes + ("model",)
    total = 1
    for a in daxes:
        total *= _axis_size(mesh, a)
    first = _entry(daxes) if batch % max(total, 1) == 0 and total > 1 else None
    return (first,) + (None,) * (rank - 1)


# ---- tree walking ----------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """(name, child) pairs of a container, or None for a leaf."""
    if isinstance(tree, dict):
        return list(tree.items())
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, list):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _rebuild(tree, values):
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), values))
    if _is_namedtuple(tree):
        return type(tree)(*values)
    return list(values)


def map_with_path(fn: Callable[[str, Any], Any], tree: Any, prefix: str = "") -> Any:
    """``fn(path, leaf)`` over every leaf, the tree's structure kept; a
    path joins dict keys, list indices and NamedTuple fields with ``/``."""
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    return _rebuild(tree, [map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                           for k, v in kids])


def is_spec(x) -> bool:
    return type(x) is tuple


def flat_specs(specs: Any, prefix: str = "") -> Dict[str, Spec]:
    """{path: spec} of a spec tree (its leaves are plain tuples)."""
    if is_spec(specs):
        return {prefix: specs}
    out: Dict[str, Spec] = {}
    for k, v in _children(specs) or []:
        out.update(flat_specs(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _ndim(leaf) -> int:
    return len(tuple(leaf.shape))


def _numel(leaf) -> int:
    return math.prod(tuple(leaf.shape))


# ---- param rules -----------------------------------------------------------
# (pattern, dim to split) over 2D+ weight leaves; dim counted from the END of
# the shape so scanned [L, ...] stacks work unchanged: -1 the output dim, -2
# the input dim.
_W = r"/w(_q_(wo|dyn))?$"  # matches bf16 'w' and AutoQuant'd 'w_q_*' leaves
_RULES = (
    (r"embed/table$", -2),          # [V, d] -> vocab split
    (r"lm_head" + _W, -1),          # [d, V] -> vocab split
    (r"attn/wq" + _W, -1),
    (r"attn/wk" + _W, -1),
    (r"attn/wv" + _W, -1),
    (r"attn/wo" + _W, -2),
    (r"q_up" + _W, -1),             # MLA
    (r"kv_up" + _W, -1),
    (r"ffn/w1" + _W, -1),
    (r"ffn/w3" + _W, -1),
    (r"ffn/w2" + _W, -2),
    (r"shared/w1" + _W, -1),
    (r"shared/w3" + _W, -1),
    (r"shared/w2" + _W, -2),
    (r"moe/w1$", -3),               # [E, d, f] -> expert parallel
    (r"moe/w3$", -3),
    (r"moe/w2$", -3),
    (r"uvqk" + _W, -1),             # HSTU
    (r"out" + _W, -2),
    (r"(proj_x|proj_gate)" + _W, -1),  # RG-LRU branches
    (r"proj_out" + _W, -2),
    (r"in_proj" + _W, -1),          # mamba in_proj
    (r"out_proj" + _W, -2),
    (r"(gate_a|gate_x)" + _W, -1),
)


def _spec_for(path_s: str, leaf, mesh, enable_tp: bool) -> Spec:
    ndim = _ndim(leaf)
    if not enable_tp or "model" not in mesh.axis_names or ndim < 2:
        return ()
    msize = _axis_size(mesh, "model")
    for pat, dim in _RULES:
        if re.search(pat, path_s):
            axis = ndim + dim  # dim counted from the end
            if 0 <= axis < ndim and tuple(leaf.shape)[axis] % msize == 0:
                spec = [None] * ndim
                spec[axis] = "model"
                return tuple(spec)
            return ()
    return ()


def param_specs(cfg: ModelConfig, params_like: Any, mesh,
                enable_tp: Optional[bool] = None) -> Any:
    """Spec tree matching a (meta) param tree."""
    if enable_tp is None:
        enable_tp = cfg.n_params() >= TP_MIN_PARAMS
    return map_with_path(lambda path, leaf: _spec_for(path, leaf, mesh, enable_tp),
                         params_like)


def opt_state_specs(cfg: ModelConfig, opt_like: Any, mesh,
                    enable_tp: Optional[bool] = None) -> Any:
    """Adam moments split exactly like their params; step is replicated."""
    if enable_tp is None:
        enable_tp = cfg.n_params() >= TP_MIN_PARAMS

    def spec(path, leaf):
        if _ndim(leaf) == 0 or "step" in path:
            return ()
        # strip the leading 'mu/' / 'nu/' NamedTuple field from the path
        return _spec_for(re.sub(r"^\.?(mu|nu)/", "", path), leaf, mesh, enable_tp)

    return map_with_path(spec, opt_like)


def cache_specs(cfg: ModelConfig, cache_like: Any, mesh, batch: int) -> Any:
    """KV-cache specs: the batch dim over (pod, data); everything else
    replicated in the baseline (kv heads rarely divide the model axis)."""
    daxes = data_axes(mesh)
    total = 1
    for a in daxes:
        total *= _axis_size(mesh, a)
    bshard = _entry(daxes) if batch % max(total, 1) == 0 and total > 1 else None

    def spec(path, leaf):
        ndim = _ndim(leaf)
        if ndim == 0:
            return ()
        specs = [None] * ndim
        bdim = 1 if "scanned" in path else 0  # [L, B, ...] stacked caches
        if ndim > bdim:
            specs[bdim] = bshard
        return tuple(specs)

    return map_with_path(spec, cache_like)


_KV_LEAF = r"(k|v|c_kv|k_rope)$"


def _upgraded(cache_like: Any, base: Any, upgrade) -> Any:
    flat = flat_specs(base)
    return map_with_path(lambda path, leaf: upgrade(path, leaf, flat[path]), cache_like)


def cache_specs_seqsharded(cfg: ModelConfig, cache_like: Any, mesh, batch: int) -> Any:
    """Beyond-paper variant: the cache SEQUENCE axis over 'model' (flash-
    decode sequence parallelism), on [.., S, H, D] KV leaves with S
    divisible."""
    base = cache_specs(cfg, cache_like, mesh, batch)
    msize = _axis_size(mesh, "model")

    def upgrade(path, leaf, spec):
        ndim = _ndim(leaf)
        if ndim >= 3 and re.search(_KV_LEAF, path):
            sdim = 2 if "scanned" in path else 1
            if tuple(leaf.shape)[sdim] % msize == 0:
                parts = list(spec) + [None] * (ndim - len(spec))
                parts[sdim] = "model"
                return tuple(parts)
        return spec

    return _upgraded(cache_like, base, upgrade)


def cache_specs_tp(cfg: ModelConfig, cache_like: Any, mesh, batch: int) -> Any:
    """Tensor-parallel pool specs: the KV HEAD axis over 'model', so each
    rank holds the heads its column-split wk/wv produce and writes them
    without a collective; the sequence axis when ``n_kv_heads`` does not
    divide the axis, else the replicated base. Scalar and bookkeeping
    leaves (``lengths``, ``block_tables``) replicate: they are the host
    state's mirror, the same on every rank."""
    base = cache_specs(cfg, cache_like, mesh, batch)
    msize = _axis_size(mesh, "model")

    def upgrade(path, leaf, spec):
        ndim = _ndim(leaf)
        shape = tuple(leaf.shape)
        if ndim >= 3 and re.search(_KV_LEAF, path):
            sdim = 2 if "scanned" in path else 1
            hdim = sdim + 1
            parts = list(spec) + [None] * (ndim - len(spec))
            if hdim < ndim and shape[hdim] % msize == 0:
                parts[hdim] = "model"
                return tuple(parts)
            if shape[sdim] % msize == 0:
                parts[sdim] = "model"
                return tuple(parts)
        return spec

    return _upgraded(cache_like, base, upgrade)


def fsdp_upgrade(cfg: ModelConfig, tree_like: Any, spec_tree: Any, mesh,
                 axes: Tuple[str, ...] = ("data",)) -> Any:
    """ZeRO-3-style upgrade: additionally split every large weight leaf over
    ``axes`` on its largest still-unsplit divisible dim. ``axes=("data",
    "model")`` is the pure-FSDP (no-TP) layout."""
    dsize = 1
    for a in axes:
        dsize *= _axis_size(mesh, a)
    if dsize <= 1:
        return spec_tree
    shard_as = _entry(axes)

    def upgrade(path, leaf, spec):
        ndim, shape = _ndim(leaf), tuple(leaf.shape)
        if ndim < 2 or _numel(leaf) * dsize < 2 ** 24:
            return spec  # small leaves: the gather's latency dominates
        parts = list(spec) + [None] * (ndim - len(spec))
        for i in sorted((i for i in range(ndim) if parts[i] is None),
                        key=lambda i: -shape[i]):
            if shape[i] % dsize == 0:
                parts[i] = shard_as
                return tuple(parts)
        return spec

    return _upgraded(tree_like, spec_tree, upgrade)


# ---- the port's TP serving specs and shards --------------------------------

#: q/k/v biases: 1-D, so the rules keep them whole; a rank adds the slice
#: of its own columns (GSPMD slices them implicitly in the reference)
_BIAS = re.compile(r"attn/(wq|wk|wv)/b$")


def _column_split(spec: Spec) -> Spec:
    """A 1-D per-column leaf's spec beside a weight of ``spec``: split with
    its columns, else whole."""
    return ("model",) if spec and spec[-1] == "model" else ()


#: a Mamba-2 mixer's per-head and per-channel leaves, head-split in the
#: port's serving specs (the reference's rules keep the 1-D ones and
#: ``conv_w`` whole and split ``in_proj``'s columns in contiguous halves,
#: which GSPMD can afford and a rank computing its own heads cannot)
_SSM_SPLIT = re.compile(r"mixer/(in_proj/(w|w_q_wo|w_q_dyn|w_scale)|conv_w|conv_b|A_log|D|"
                        r"dt_bias|gate_norm/scale)$")
#: the leaves among them cut at head-aligned indices, not in equal blocks
_SSM_GATHERED = re.compile(r"mixer/(in_proj/(w|w_q_wo|w_q_dyn|w_scale)|conv_w|conv_b)$")
#: a hybrid recurrent block's per-channel leaves, split on their channels
#: (axis 0) as ``proj_x`` splits its columns: a rank's conv, RG-LRU decay
#: and gate biases run at its ``lru_width / tp`` channels (the reference's
#: rules keep these 1-D and ``[w, 4]`` leaves whole; GSPMD computes on the
#: rank's channels anyway). Equal blocks: ``tp_rank_index`` keeps None.
_HYBRID_CHANNELS = re.compile(r"rec/(conv_w|conv_b|lam|gate_a/b|gate_x/b)$")
#: the hybrid's single-KV-head projections, whole on every rank (their
#: biases and scales follow them): the reference's rule splits the one
#: head's columns, which a rank that computes its own heads' scores cannot
#: use
_HYBRID_WHOLE = re.compile(r"attn/(wk|wv)/(w|w_q_wo|w_q_dyn)$")


def tp_param_specs(cfg: ModelConfig, params_like: Any, tp: int) -> Any:
    """The serving spec tree of the port's params at ``tp`` ranks:
    :func:`param_specs` with ``enable_tp=True`` on ``("model",)``, plus the
    port's own leaves — a tied table's f32 unembed copy (``table_f32``) split
    as its table, each q/k/v bias split with its weight's columns, and an
    AutoQuant'd linear's per-column ``w_scale`` [N] split with a
    column-parallel ``w_q_*`` leaf's columns and whole beside a row-parallel
    one (the reference leaves every 1-D ``w_scale`` whole) — and a Mamba-2
    mixer's per-head leaves split on their heads: ``in_proj``'s columns and
    ``conv_w`` / ``conv_b``'s channels (at :func:`tp_rank_index`'s
    head-aligned indices), ``A_log``, ``D``, ``dt_bias`` and ``gate_norm``'s
    channels. A hybrid (recurrentgemma) keeps its attention's ``wk`` / ``wv``
    whole (one KV head, every rank's q heads read it) and splits a
    recurrent block's ``conv_w``, ``conv_b``, ``lam`` and the gates' biases
    on their channels. A vocabulary that does not split leaves ``embed`` and
    ``lm_head`` whole, as the reference's ``_spec_for`` does."""
    specs = param_specs(cfg, params_like, MeshShape({"model": tp}), enable_tp=True)
    flat = flat_specs(specs)
    hybrid = cfg.family == "hybrid"

    def rule(path):
        return () if hybrid and _HYBRID_WHOLE.search(path) else flat[path]

    def fix(path, leaf):
        if path.endswith("embed/table_f32"):
            return flat[path[:-len("_f32")]]
        if cfg.family == "ssm" and _SSM_SPLIT.search(path):
            spec = [None] * _ndim(leaf)
            spec[-1 if "in_proj" in path else 0] = "model"
            return tuple(spec)
        if hybrid and _HYBRID_CHANNELS.search(path):
            return ("model",) + (None,) * (_ndim(leaf) - 1)
        if _BIAS.search(path):
            return _column_split(rule(path[:-1] + "w"))
        if path.endswith("/w_scale") and _ndim(leaf) == 1:
            base = path[:-len("w_scale")]
            weight = next(rule(base + q) for q in ("w_q_wo", "w_q_dyn") if base + q in flat)
            return _column_split(weight)
        return rule(path)

    return map_with_path(fix, params_like)


#: a MoE layer's routed experts ([E, d, f] / [E, f, d]); its shared experts
#: (``shared/w1`` ...) and router stay whole under expert parallelism
_EXPERTS = re.compile(r"(^|moe/)(w1|w3|w2)$")


def ep_param_specs(cfg: ModelConfig, params_like: Any, ep: int) -> Any:
    """The expert-parallel spec tree of a MoE layer's params or a whole
    model's at ``ep`` ranks, the reference's ``moe_ffn_ep`` layout
    (``pspec``): every MoE layer's ``w1``, ``w3`` and ``w2`` split on the
    expert axis into contiguous blocks (``("model", None, None)``; rank r
    holds experts ``[r * E / ep, (r + 1) * E / ep)``), every other leaf
    (the router, the shared experts, attention, the dense layers) whole on
    every rank. Raises when ``moe.n_experts`` does not split over ``ep``."""
    m = cfg.moe
    if m is None:
        raise ValueError(f"{cfg.name}: expert parallelism needs a MoE config")
    if m.n_experts % ep:
        raise ValueError(f"moe.n_experts = {m.n_experts} does not split over ep = {ep}")

    def spec(path, leaf):
        return ("model", None, None) if _EXPERTS.search(path) else ()

    return map_with_path(spec, params_like)


def ssm_rank_columns(cfg: ModelConfig, rank: int, size: int) -> Tuple[torch.Tensor,
                                                                      torch.Tensor]:
    """(``in_proj`` columns, conv channels) of rank ``rank`` of ``size`` in
    a Mamba-2 mixer of the whole ``cfg``, in the mixer's own order: ``z``
    and ``x`` of the rank's heads ``[rank * H / size, (rank + 1) * H /
    size)``, ``B`` and ``C`` whole (their groups do not split), ``dt`` of
    its heads; the conv's channels are ``x`` of its heads, then ``B`` and
    ``C``."""
    s = cfg.ssm
    d_in, nh = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model)
    gn = s.n_groups * s.d_state
    dl, hl = d_in // size, nh // size
    mine = torch.arange(rank * dl, (rank + 1) * dl)
    bc = torch.arange(2 * d_in, 2 * d_in + 2 * gn)
    dt = 2 * d_in + 2 * gn + torch.arange(rank * hl, (rank + 1) * hl)
    cols = torch.cat([mine, d_in + mine, bc, dt])
    conv = torch.cat([mine, torch.arange(d_in, d_in + 2 * gn)])
    return cols, conv


def tp_rank_index(cfg: ModelConfig, path: str, rank: int, size: int) -> Optional[torch.Tensor]:
    """The indices rank ``rank`` keeps along a leaf's split dim where they
    are not its ``rank``-th equal block: a Mamba-2 mixer's ``in_proj``
    columns (``w``, an AutoQuant'd ``w_q_*`` and its ``w_scale``) and
    ``conv_w`` / ``conv_b`` channels (:func:`ssm_rank_columns`); None for
    every other leaf (a hybrid's per-channel leaves too: its channels are
    ``proj_x``'s columns, the rank's equal block)."""
    if cfg.family != "ssm" or not _SSM_GATHERED.search(path):
        return None
    cols, conv = ssm_rank_columns(cfg, rank, size)
    return cols if "in_proj" in path else conv


def shard_tree(tree: Any, specs: Any, rank: int, size: int, axis: str = "model",
               index: Optional[Callable[[str], Optional[torch.Tensor]]] = None) -> Any:
    """Rank ``rank``'s slice of every leaf of ``tree`` under ``specs`` on a
    1-D ``(axis,)`` mesh of ``size`` ranks: a leaf whose spec names ``axis``
    at dim ``d`` keeps the ``rank``-th of ``size`` equal blocks along ``d``,
    or the indices ``index(path)`` gives where it gives any (a head-aligned
    layout, :func:`tp_rank_index`), copied so the whole tensor can be freed;
    a replicated leaf is kept as it is."""
    flat = flat_specs(specs)

    def cut(path, leaf):
        spec = flat[path]
        if axis not in spec:
            return leaf
        d = spec.index(axis)
        idx = index(path) if index is not None else None
        with torch.no_grad():
            if idx is not None:
                return leaf.index_select(d, idx.to(leaf.device))
            n = leaf.shape[d]
            if n % size:
                raise ValueError(f"{path}: dim {d} of {tuple(leaf.shape)} does not split "
                                 f"into {size}")
            return leaf.narrow(d, rank * (n // size), n // size).clone()

    return map_with_path(cut, tree)


# ---- replica placement (core/router.py) ------------------------------------

def replica_devices(n: int, devices: Optional[Sequence[Any]] = None, *,
                    group_size: int = 1) -> list:
    """Device pin per replica: round-robin over ``devices`` (default: every
    CUDA card), wrapping when replicas outnumber them — replicas that share
    a device time-share it. With ``group_size > 1`` (DP x TP) the pool is
    carved into disjoint contiguous groups of that size and whole GROUPS
    round-robin instead: wrapped replicas reuse an identical group, never a
    partially overlapping one. Returns one device per replica when
    ``group_size`` is 1, else one tuple of devices per replica."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = list(devices)
    if not devs:
        raise ValueError("no devices to place replicas on")
    if group_size <= 1:
        return [devs[i % len(devs)] for i in range(n)]
    n_groups = len(devs) // group_size
    if n_groups < 1:
        raise ValueError(f"group_size={group_size} needs at least that many devices, "
                         f"have {len(devs)}")
    groups = [tuple(devs[g * group_size:(g + 1) * group_size]) for g in range(n_groups)]
    return [groups[i % n_groups] for i in range(n)]
