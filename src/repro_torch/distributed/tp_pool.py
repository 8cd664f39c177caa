"""Tensor-parallel serving pool: one scheduler per rank of a
``torch.distributed`` group, each holding its shard of the params and the
KV pool — the counterpart of ``repro/distributed/tp_pool.py``.

The reference is one controller over a ``("model",)`` mesh whose
collectives GSPMD inserts. The port runs SPMD: ``tp`` processes, started by
:func:`spawn`, each with a :class:`TPGroup` (its rank, its device and the
two collectives the model uses) and a :class:`TPContext`:

- the rank's param shard, cut by ``sharding.tp_param_specs`` (megatron
  column / row splits, the vocab-split embedding and LM head, the q/k/v
  biases with their columns, MoE experts on their axis, MLA's ``q_up`` /
  ``kv_up`` columns, an AutoQuant'd leaf's ``w_scale`` with its columns)
  through ``sharding.shard_tree``. AutoQuant'd trees are quantized whole
  and then cut: a row-parallel leaf's per-column scale is the max over the
  whole K, so cutting first would give other codes;
- a rank-local model (:func:`local_config`: the rank's heads and FFN
  columns, all ``n_experts`` kept), whose forward reduces after each
  row-parallel linear (``attn/wo``, ``ffn/w2``; a MoE layer's routed and
  shared partials in one reduce) and after the vocab-parallel embedding
  lookup, so its pools (``SlotPool``, ``BlockPool``) hold the rank's KV
  heads, the head split of ``sharding.cache_specs_tp``, or MLA's whole
  latent (the reference replicates it), with block tables and lengths whole
  on every rank;
- :meth:`TPContext.executables`, the TP step family (``engine.tp_prefill``,
  ``tp_decode_step``, ``tp_mixed_step``, ``tp_verify_step`` and
  ``layerskip.tp_draft_window``) with the single-device call signatures:
  the seam ``Scheduler(tp=...)`` routes every step through.

Collectives are ``all_reduce`` (sum, and max for an AutoQuant'd ``dyn``
row-parallel linear's activation scale) and ``broadcast``, which gloo
offers on CUDA tensors, and expert parallelism's ``all_to_all``;
``TPGroup`` counts the reduces and the exchanges. The backend
follows one rule: ``gloo`` when the ranks run on the CPU or share a card
(NCCL refuses two ranks on one device), ``nccl`` when each rank has a card
of its own. Gloo ranks that meet through a file store share a host, and
their collectives of up to ``SLOT_BYTES`` go through a file they all map
(:class:`SharedSlots`), bit for bit gloo's results without its socket
round trips. Every rank's host state stays the same by construction: rank 0
broadcasts every token the scheduler commits and every clock reading it
acts on, so admissions, preemptions, block tables and the prefix cache
agree and the ranks enter the same collectives in the same order.

A DP x TP fleet (``core/router.py``, ``ReplicaRouter(tp=...)``) runs on
the same ``tp`` processes: process r is rank r of every replica, and every
process runs the one router loop on rank 0's clock, so all of them place
alike and enter the same collectives in the same order. Each replica's
collectives are its own (:func:`replica_group`: a process group and shared
slots a replica), and replicas on one device group share the rank's shard
(:meth:`TPContext.on_group`).

Expert parallelism (the reference's ``moe_ffn_ep``, ``models/moe.py``)
runs on the same spawned processes: :func:`ep_group` gives each rank its
group in a ``(data, ep)`` layout of them, whose tiled
:meth:`TPGroup.all_to_all` exchanges a MoE layer's tokens (staged through
host memory: gloo has no all-to-all for CUDA tensors). :func:`all_to_all`
and :func:`group_mean` (the aux loss's mean over the whole layout) are the
port's first collectives that autograd passes through; the TP pool's run
under no gradient.

A collective waits on the host (through the slots or gloo), so a TP step
syncs: the no-sync contract of ``Scheduler.step_begin`` holds for
single-device steps only, and a TP step is not captured as a CUDA graph.

Served: the ``dense``, ``vlm``, ``moe``, ``mla_moe``, ``ssm``, ``encdec``,
``seamless`` and ``hybrid`` families, bf16 or AutoQuant'd (``wo`` /
``dyn``). A
Mamba-2 rank holds its heads (``local_config``: ``ssm.shards``; the
head-aligned ``in_proj`` / conv layout of ``sharding.tp_rank_index``), its
state and its conv tail's ``x`` channels; its gate norm, over all of
``d_inner``, reduces its partial sums of squares
(``ops.mul_silu_rmsnorm_split``). An encoder-decoder rank runs the encoder
and both attentions at its heads and holds its self and cross K/V heads.
A hybrid (recurrentgemma) rank runs its
``lru_width / tp`` channels of each recurrent block (the post-conv input
gathered whole for the gates, one reduce) and its q heads of each local
attention over the one KV head, whose ``wk`` / ``wv`` every rank holds
whole; its ring follows ``sharding.cache_specs_tp``'s sequence fallback:
split along its rows when ``S = min(max_len, window)`` divides ``tp``
(the rank's rows ``[rank * S / tp, (rank + 1) * S / tp)``, decoded by
``attention.sp_decode``), else whole on every rank. A vocabulary that does
not split stays whole on every rank, as the reference's specs leave it (no
lookup reduce, no logits gather). Refused, by name (ROADMAP, Queue 1,
step 6): the ``hstu`` family; a width that does not divide ``tp`` (heads,
FFN columns, experts, the shared experts' width, ``d_ff_dense``, Mamba-2's
heads, the hybrid's ``lru_width``) and Mamba-2's B / C groups beyond one,
where the reference falls back to the sequence axis or replicates.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
import os
import platform
import re
import tempfile
import time
import types
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core import kv_cache
from repro_torch.distributed import sharding
from repro_torch.models.registry import Model

#: where the refused parts of TP serving are queued
ROADMAP_ITEM = "ROADMAP Queue 1, step 6 (distributed/: what tensor parallelism still refuses)"

#: a collective of at most this many bytes between gloo ranks goes through
#: their shared slots (``SharedSlots``), which skip gloo's socket round
#: trips; a larger one through gloo, where the copies, the same either way,
#: set the time (a decode step's reduces and its logits' gather fit)
SLOT_BYTES = 8 << 20
#: how long a rank waits for the others to reach a collective
SLOT_TIMEOUT_S = 600.0


class SharedSlots:
    """The collectives of ranks on one host through a file every rank maps
    (``torch.from_file``): a sequence number a rank (each on a cache line of
    its own) and, for each of two parities, a slot of SLOT_BYTES a rank. A
    collective writes the rank's slot of its parity, publishes its sequence
    number, waits until every rank has published it, and reads. A rank
    writes a parity's slot again only two collectives later, after every
    rank published the next one and so finished reading this one. Every rank
    combines the slots in rank order, so each gets the same result, as
    gloo's (a sum of two bf16 tensors rounds once). The data must be visible
    before the sequence number: stores become visible in program order on
    x86-64, the only host ``make_tp_group`` uses them on."""

    def __init__(self, path: str, rank: int, size: int):
        self.rank, self.size = rank, size
        self.header = 64 * size
        self.buf = torch.from_file(path, shared=True, dtype=torch.uint8,
                                   size=self.header + 2 * size * SLOT_BYTES)
        self.published = self.buf[:self.header].numpy().view("int64")[::8]
        self.seq = 0

    def _slot(self, parity: int, rank: int, like: torch.Tensor) -> torch.Tensor:
        at = self.header + (parity * self.size + rank) * SLOT_BYTES
        n = like.numel() * like.element_size()
        return self.buf[at:at + n].view(like.dtype).view(like.shape)

    def _meet(self) -> None:
        self.published[self.rank] = self.seq
        deadline = time.monotonic() + SLOT_TIMEOUT_S
        while int(self.published.min()) < self.seq:
            if time.monotonic() > deadline:
                raise RuntimeError(f"rank {self.rank}: the other ranks did not reach "
                                   f"collective {self.seq} within {SLOT_TIMEOUT_S} s")
            os.sched_yield()

    def all_reduce(self, x: torch.Tensor, op) -> None:
        self.seq += 1
        parity = self.seq % 2
        self._slot(parity, self.rank, x).copy_(x)
        self._meet()
        acc = self._slot(parity, 0, x).clone()
        for r in range(1, self.size):
            if op == dist.ReduceOp.MAX:
                torch.maximum(acc, self._slot(parity, r, x), out=acc)
            else:
                acc += self._slot(parity, r, x)
        x.copy_(acc)

    def broadcast(self, x: torch.Tensor, src: int) -> None:
        self.seq += 1
        parity = self.seq % 2
        if self.rank == src:
            self._slot(parity, src, x).copy_(x)
        self._meet()
        if self.rank != src:
            x.copy_(self._slot(parity, src, x))

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """The tiled exchange of ``x`` [size, rows, width] (row block r for
        rank r): a host tensor of x's shape whose block r is rank r's block
        ``self.rank``. In rounds of at most SLOT_BYTES a rank, each round a
        run of rows of every block (at least one row: the caller checks that
        a row of every block fits)."""
        size, rows, width = x.shape
        per_round = SLOT_BYTES // (size * width * x.element_size())
        out = torch.empty(x.shape, dtype=x.dtype)
        for a in range(0, rows, per_round):
            part = x[:, a:a + per_round]
            self.seq += 1
            parity = self.seq % 2
            self._slot(parity, self.rank, part).copy_(part)
            self._meet()
            for r in range(size):
                out[r, a:a + part.shape[1]] = self._slot(parity, r, part)[self.rank]
        return out


class TPGroup:
    """One rank's handle on its tensor-parallel group: ``rank`` of ``size``
    on ``device``, and the group's collectives, through ``slots`` (a
    ``SharedSlots``) when the ranks have them and the tensor fits, else
    through the process group ``pg`` (None: the default one). A group of one
    rank (``size == 1``) needs no process group: its collectives return
    their input. Counts each ``all_reduce`` and its host seconds
    (``n_reduces``, ``reduce_s``), each ``broadcast`` (``n_broadcasts``) and
    each ``all_to_all``, the bytes it sent and its host seconds
    (``n_exchanges``, ``exchange_bytes``, ``exchange_s``). ``store`` is the
    path of the file store the ranks met through, beside which a replica's
    or an expert-parallel group keeps its own slots (``replica_group``,
    ``ep_group``). ``whole``: the group of every rank of an expert-parallel
    layout, over which a MoE layer averages its aux loss (``ep_group``;
    None: this group)."""

    def __init__(self, rank: int, size: int, device, backend: Optional[str] = None,
                 slots: Optional[SharedSlots] = None, pg=None, store: Optional[str] = None,
                 whole: Optional["TPGroup"] = None):
        self.rank, self.size = rank, size
        self.device = torch.device(device)
        self.backend = backend
        self.slots = slots
        self.pg = pg
        self.store = store
        self.whole = self if whole is None else whole
        self.n_reduces = 0
        self.reduce_s = 0.0
        self.n_broadcasts = 0
        self.n_exchanges = 0
        self.exchange_bytes = 0
        self.exchange_s = 0.0

    def __repr__(self) -> str:
        return f"TPGroup(rank={self.rank}, size={self.size}, device={self.device})"

    def _in_slots(self, x: torch.Tensor) -> bool:
        return self.slots is not None and x.numel() * x.element_size() <= SLOT_BYTES

    def _reduce(self, x: torch.Tensor, op) -> None:
        if self._in_slots(x):
            self.slots.all_reduce(x, op)
        else:
            dist.all_reduce(x, op=op, group=self.pg)

    def _broadcast(self, x: torch.Tensor, src: int) -> None:
        if self._in_slots(x):
            self.slots.broadcast(x, src)
        else:  # a replica's group holds every rank in order: its ranks are global
            dist.broadcast(x, src, group=self.pg)

    def all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``x`` reduced over the ranks by ``op`` (a sum), in place; returns
        ``x``."""
        if self.size == 1:
            return x
        t = time.perf_counter()
        self._reduce(x, op)
        self.reduce_s += time.perf_counter() - t
        self.n_reduces += 1
        return x

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        """``x``'s elementwise max over the ranks, in place (an AutoQuant'd
        ``dyn`` row-parallel linear's whole-row activation scale)."""
        return self.all_reduce(x, dist.ReduceOp.MAX)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank, in place; returns ``x``."""
        if self.size == 1:
            return x
        self._broadcast(x, src)
        self.n_broadcasts += 1
        return x

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """The tiled all-to-all along dim 0 (``jax.lax.all_to_all(x, axis,
        0, 0, tiled=True)``): chunk j of this rank's ``x`` (``x.shape[0] /
        size`` rows) goes to rank j, and the result, a new tensor of x's
        shape on x's device, holds the chunks the ranks sent this one, in
        rank order. Gloo has no all-to-all for CUDA tensors, so the exchange
        is staged through host memory either way: through the shared slots
        where the ranks have them, in rounds of at most SLOT_BYTES a rank
        when it is larger (each round a run of rows of every chunk: the
        same copies, no socket round trips); else through gloo's
        ``all_to_all_single`` on a host copy."""
        if self.size == 1:
            return x
        if x.shape[0] % self.size:
            raise ValueError(f"all_to_all: dim 0 of {tuple(x.shape)} does not split into "
                             f"{self.size} chunks")
        t = time.perf_counter()
        chunks = x.reshape(self.size, x.shape[0] // self.size, -1)
        row_bytes = chunks.shape[2] * chunks.element_size()
        if self.slots is not None and self.size * row_bytes <= SLOT_BYTES:
            out = self.slots.all_to_all(chunks)
        else:
            host = chunks.cpu().contiguous()
            out = torch.empty_like(host)
            dist.all_to_all_single(out, host, group=self.pg)
        out = out.to(x.device).reshape(x.shape)
        self.exchange_s += time.perf_counter() - t
        self.n_exchanges += 1
        self.exchange_bytes += x.numel() * x.element_size()
        return out

    def _host_scalar(self, value, dtype) -> torch.Tensor:
        # gloo takes host tensors; nccl only device ones
        dev = self.device if self.backend == "nccl" else torch.device("cpu")
        return torch.tensor([value], dtype=dtype, device=dev)

    def max(self, value: int) -> int:
        """The largest of every rank's ``value``."""
        if self.size == 1:
            return int(value)
        t = self._host_scalar(value, torch.int64)
        self._reduce(t, dist.ReduceOp.MAX)
        return int(t[0])

    def shared_clock(self, clock: Callable[[], float]) -> Callable[[], float]:
        """``clock`` as rank 0 reads it, on every rank: each call is one
        broadcast, so every rank's scheduler sees the same times and makes
        the same admissions."""
        if self.size == 1:
            return clock

        def read() -> float:
            t = self._host_scalar(clock() if self.rank == 0 else 0.0, torch.float64)
            self._broadcast(t, 0)
            return float(t[0])

        return read


def backend_for(devices: Sequence[torch.device]) -> str:
    """``nccl`` when every rank has a card of its own, else ``gloo`` (the
    CPU, or ranks that share a card)."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len({d.index for d in devs}) == len(devs):
        return "nccl"
    return "gloo"


def tp_devices(tp: int, devices: Optional[Sequence[Any]] = None) -> List[torch.device]:
    """The ``tp`` ranks' devices: ``devices`` as given (``["cuda:0"] * 2``
    puts two ranks on one card), or by default the first ``tp`` cards,
    raising when the host has fewer — never the CPU or a shared card by
    default."""
    if devices is None:
        n = torch.cuda.device_count()
        devs = [torch.device("cuda", i) for i in range(min(tp, n))]
    else:
        devs = [torch.device(d) for d in devices]
    if len(devs) != tp:
        raise ValueError(f"a tensor-parallel group needs exactly tp={tp} devices, got "
                         f"{len(devs)}" + (" (CUDA cards)" if devices is None else ""))
    return devs


def make_tp_group(tp: int, devices: Optional[Sequence[Any]] = None, *, rank: int = 0,
                  init_method: Optional[str] = None) -> TPGroup:
    """Rank ``rank``'s :class:`TPGroup` over ``tp_devices(tp, devices)``
    (the counterpart of ``make_tp_mesh``). With ``tp > 1`` it joins the
    default process group (``init_method``, e.g. ``file://<path>``, unless
    one is up), under :func:`backend_for`'s backend."""
    devs = tp_devices(tp, devices)
    backend = backend_for(devs)
    if tp > 1 and not dist.is_initialized():
        if init_method is None:
            raise ValueError("a group of more than one rank needs an init_method")
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=tp)
    store = None
    if tp > 1 and init_method is not None and init_method.startswith("file://"):
        store = init_method[len("file://"):]
    slots = _slots(store, ".slots", rank, tp, backend)
    return TPGroup(rank, tp, devs[rank], backend, slots, store=store)


def _slots(store: Optional[str], suffix: str, rank: int, size: int, backend: str,
           pg=None) -> Optional[SharedSlots]:
    """The ranks' shared slots at ``<store><suffix>``, every rank's count
    zeroed before any uses them; None unless gloo ranks met through a file
    store on an x86-64 host (they share it)."""
    if store is None or backend != "gloo" or platform.machine() != "x86_64":
        return None
    slots = SharedSlots(store + suffix, rank, size)
    if rank == 0:
        slots.published[:] = 0
    dist.barrier(group=pg)
    return slots


def replica_group(group: TPGroup, devices: Sequence[Any], replica: int) -> TPGroup:
    """This rank's handle on replica ``replica``'s group in a DP x TP fleet
    (``core/router.py``): rank ``group.rank`` of ``group.size`` on
    ``devices[group.rank]`` (``devices``: the replica's ``tp``-sized tuple
    from ``sharding.replica_devices``), with collectives of its own: a
    process group of every rank (``dist.new_group``, under
    :func:`backend_for` ``devices``' backend) and, for gloo ranks of a file
    store, slots beside the store (``<store>.slots.r<replica>``). So its
    ``n_reduces`` and ``reduce_s`` are the replica's, and its collectives
    never meet another replica's. Every rank calls it for every replica, in
    the same order."""
    devs = [torch.device(d) for d in devices]
    if len(devs) != group.size:
        raise ValueError(f"replica {replica}: a group of tp={group.size} ranks needs "
                         f"{group.size} devices, got {len(devs)}")
    backend = backend_for(devs)
    if group.size == 1:
        return TPGroup(0, 1, devs[0], backend)
    pg = dist.new_group(list(range(group.size)), backend=backend)
    slots = _slots(group.store, f".slots.r{replica}", group.rank, group.size, backend, pg)
    return TPGroup(group.rank, group.size, devs[group.rank], backend, slots, pg=pg,
                   store=group.store)


def ep_group(group: TPGroup, ep: int) -> TPGroup:
    """This rank's handle on its expert-parallel group in a ``(data, ep)``
    layout of ``group``'s ranks (the reference's ``("data", "model")`` mesh
    under ``EP_MESH``, ``data = group.size / ep``): rank r sits in data row
    ``r // ep`` at expert index ``r % ep``, and its group is the row's
    ``ep`` ranks, with a process group (``dist.new_group``, ``group``'s
    backend) and, for gloo ranks of a file store, slots of its own beside
    the store (``<store>.slots.ep<ep>.<row>``). Its ``whole`` is ``group``,
    over which a MoE layer averages its aux loss. Every rank calls it for a
    layout once, in the same order. Raises for a layout that does not tile
    ``group`` and for a group on ``cuda`` on a host without a card: the
    CPU runs only when asked for."""
    if ep < 1 or group.size % ep:
        raise ValueError(f"ep = {ep} does not divide the group's {group.size} ranks")
    if group.device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"an expert-parallel group on {group.device}, but CUDA is not "
                           "available (ask for the CPU with devices=['cpu', ...])")
    if ep == 1:
        return TPGroup(0, 1, group.device, group.backend, whole=group)
    row = group.rank // ep
    pg = None
    for r in range(group.size // ep):  # every rank makes every row's group
        made = dist.new_group(list(range(r * ep, (r + 1) * ep)), backend=group.backend)
        if r == row:
            pg = made
    slots = _slots(group.store, f".slots.ep{ep}.{row}", group.rank % ep, ep, group.backend, pg)
    return TPGroup(group.rank % ep, ep, group.device, group.backend, slots, pg=pg,
                   store=group.store, whole=group)


class _AllToAll(torch.autograd.Function):
    """``TPGroup.all_to_all`` under autograd. The tiled exchange is its own
    inverse permutation (chunk j of rank i lands as chunk i of rank j), so
    its backward is the same exchange of the incoming gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_to_all(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_to_all(grad.contiguous()), None


class _Mean(torch.autograd.Function):
    """The mean of a scalar over a group's ranks (``jax.lax.pmean``), every
    rank holding the result. Its adjoint is the mean of the ranks'
    incoming gradients: each rank's copy of the mean feeds its own loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_reduce(x.detach().reshape(1).clone())[0] / group.size

    @staticmethod
    def backward(ctx, grad):
        g = ctx.group.all_reduce(grad.detach().reshape(1).clone())[0] / ctx.group.size
        return g, None


def all_to_all(x: torch.Tensor, group: TPGroup) -> torch.Tensor:
    """``group.all_to_all(x)``, differentiable (``_AllToAll``)."""
    return x if group.size == 1 else _AllToAll.apply(x, group)


def group_mean(x: torch.Tensor, group: TPGroup) -> torch.Tensor:
    """A scalar ``x``'s mean over ``group``'s ranks, differentiable
    (``_Mean``)."""
    return x if group.size == 1 else _Mean.apply(x, group)


def _rank_main(rank: int, fn, tp: int, devices, init_method: str, results, args) -> None:
    torch.set_num_threads(1)
    group = make_tp_group(tp, devices, rank=rank, init_method=init_method)
    if group.device.type == "cuda":
        torch.cuda.set_device(group.device)
    try:
        results.put((rank, fn(group, *args)))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable[..., Any], tp: int, *args, devices: Optional[Sequence[Any]] = None,
          init_file: Optional[str] = None) -> list:
    """Run ``fn(group, *args)`` on ``tp`` ranks, each a process started by
    ``torch.multiprocessing.spawn`` (never fork: CUDA may be up), and
    return each rank's result (picklable) in rank order. The ranks meet
    through a ``FileStore`` at ``init_file`` (default: a fresh file in a
    new temporary directory): no TCP port. Each rank runs one intra-op
    thread."""
    import torch.multiprocessing as mp

    devs = tp_devices(tp, devices)
    tmp = None
    if init_file is None:
        tmp = tempfile.mkdtemp(prefix="tp_store_")
        init_file = os.path.join(tmp, "store")
    results = mp.get_context("spawn").SimpleQueue()
    try:
        ranks = mp.spawn(_rank_main, args=(fn, tp, [str(d) for d in devs],
                                           f"file://{init_file}", results, args),
                         nprocs=tp, join=False)
        # read while the ranks run: a result larger than the pipe's buffer
        # holds its rank until it is read
        out: dict = {}
        while len(out) < tp:
            if not results.empty():
                rank, value = results.get()
                out[rank] = value
            elif ranks.join(timeout=0.05):  # raises when a rank failed
                break
        while not ranks.join():
            pass
        if len(out) < tp:
            raise RuntimeError(f"{tp - len(out)} of {tp} ranks returned no result")
    finally:
        if tmp is not None:
            for name in os.listdir(tmp):
                os.remove(os.path.join(tmp, name))
            os.rmdir(tmp)
    return [out[r] for r in range(tp)]


# ---- the rank's shard and model --------------------------------------------

#: the families TP serves (``models/transformer.py``'s stack, Mamba-2, the
#: encoder-decoders and the hybrid)
FAMILIES = ("dense", "vlm", "moe", "mla_moe", "ssm", "encdec", "seamless", "hybrid")


def _split_widths(cfg: ModelConfig) -> list:
    """(name, width) of every width TP splits over the ranks (the
    vocabulary splits where it can, else stays whole)."""
    if cfg.family == "ssm":
        return [("the SSM heads", cfg.ssm.n_heads(cfg.d_model))]
    if cfg.family == "hybrid":  # its one KV head is whole on every rank
        return [("n_heads", cfg.n_heads), ("hybrid.lru_width", cfg.hybrid.lru_width),
                ("d_ff", cfg.d_ff)]
    widths = [("n_heads", cfg.n_heads)]
    if cfg.mla is None:  # MLA's one latent is whole on every rank
        widths.append(("n_kv_heads", cfg.n_kv_heads))
    m = cfg.moe
    if m is None:
        return widths + [("d_ff", cfg.d_ff)]
    widths.append(("moe.n_experts", m.n_experts))
    if m.n_shared_experts:
        widths.append(("the shared experts' width", m.n_shared_experts * m.d_ff_expert))
    if m.first_dense_layers:
        widths.append(("moe.d_ff_dense", m.d_ff_dense or cfg.d_ff))
    return widths


def check_supported(cfg: ModelConfig, tp: int) -> None:
    """Raise for what TP serving refuses, naming its ROADMAP item."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"tensor parallelism serves the {', '.join(FAMILIES)} families, not "
            f"{cfg.family!r}: {ROADMAP_ITEM}")
    for what, n in _split_widths(cfg):
        if n % tp:
            raise NotImplementedError(
                f"{what} = {n} does not split over tp = {tp} (the reference falls back to "
                f"the sequence axis or replicates): {ROADMAP_ITEM}")
    if cfg.ssm is not None and cfg.ssm.n_groups != 1:
        raise NotImplementedError(
            f"ssm.n_groups = {cfg.ssm.n_groups}: a rank's heads would read other groups' B "
            f"and C: {ROADMAP_ITEM}")
    if cfg.scan_layers:
        raise NotImplementedError("scan_layers: the port runs unrolled layers")


def local_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """One rank's widths: its q and KV heads and its FFN columns (a MoE
    model's dense layers at ``d_ff_dense / tp``). ``moe.n_experts`` stays
    whole: the router, the top-k and the capacity are the whole model's,
    and a rank holds experts ``[rank * E / tp, (rank + 1) * E / tp)``
    (halving it would double the capacity and change which assignments
    drop). A Mamba-2 rank's mixer widths come from ``d_model`` through
    ``ssm.shards`` (``n_heads`` alone would leave them whole). A hybrid rank
    holds ``lru_width / tp`` channels and keeps its one KV head."""
    if cfg.hybrid is not None:
        return cfg.replace(n_heads=cfg.n_heads // tp, d_head=cfg.head_dim, d_ff=cfg.d_ff // tp,
                           hybrid=dataclasses.replace(
                               cfg.hybrid, lru_width=cfg.hybrid.lru_width // tp))
    local = cfg.replace(n_heads=cfg.n_heads // tp, n_kv_heads=cfg.n_kv_heads // tp,
                        d_head=cfg.head_dim, d_ff=cfg.d_ff // tp)
    if cfg.ssm is not None:
        local = local.replace(ssm=dataclasses.replace(cfg.ssm, shards=tp))
    if cfg.moe is not None and cfg.moe.first_dense_layers:
        local = local.replace(moe=dataclasses.replace(
            cfg.moe, d_ff_dense=(cfg.moe.d_ff_dense or cfg.d_ff) // tp))
    return local


#: pool leaves a rank holds its heads of (``TPContext.whole_bytes``)
_HEAD_SPLIT = re.compile(r"layers/\d+/((self/)?(k|v)|cross_(k|v)|state)$")
_CONV_TAIL = re.compile(r"layers/\d+/conv$")
#: a hybrid rank's share: its channels of the RG-LRU state and the conv
#: tail, its rows of a ring split along the sequence (a whole ring: once)
_HYBRID_SPLIT = re.compile(r"layers/\d+/(state|conv|seq_shard/(k|v))$")


class TPContext:
    """One rank's tensor-parallel pool: its param shard (``params``), its
    rank-local model (``model``: the widths of :func:`local_config`, the
    group attached, so its caches hold the rank's KV heads) and the TP step
    family (:meth:`executables`). ``config`` is the whole model's."""

    def __init__(self, model: Model, params, group: TPGroup):
        cfg = model.config
        check_supported(cfg, group.size)
        self.config, self.group = cfg, group
        self.size, self.rank, self.device = group.size, group.rank, group.device
        self.model = Model(config=local_config(cfg, group.size), module=model.module,
                           tp=group)
        specs = sharding.tp_param_specs(cfg, params, group.size)
        index = functools.partial(sharding.tp_rank_index, cfg, rank=group.rank, size=group.size)
        shard = sharding.shard_tree(params, specs, group.rank, group.size, index=index)
        self.params = kv_cache._map(lambda t: t.to(self.device), shard)

    def on_group(self, group: TPGroup) -> "TPContext":
        """This rank's shard served through ``group`` instead (another
        replica's group on the same device): the params are shared, not cut
        again."""
        if (group.rank, group.size, group.device) != (self.rank, self.size, self.device):
            raise ValueError(f"{group} is not this shard's rank and device ({self.group})")
        other = copy.copy(self)
        other.group = group
        other.model = dataclasses.replace(self.model, tp=group)
        return other

    def executables(self) -> types.SimpleNamespace:
        """The TP step family with the single-device call signatures."""
        from repro_torch.core import engine, layerskip

        return types.SimpleNamespace(
            prefill=engine.tp_prefill, decode_step=engine.tp_decode_step,
            mixed_step=engine.tp_mixed_step, verify_step=engine.tp_verify_step,
            draft_window=layerskip.tp_draft_window)

    def whole_bytes(self, cache) -> int:
        """The bytes of the pool this rank holds a shard of, counted once:
        leaves split by heads (K/V, an encoder-decoder's self and cross
        K/V, the SSM state) ``size`` times; the SSM conv tail at the whole
        model's channels (its ``x`` channels split, ``B`` and ``C`` whole);
        MLA's latent (whole on every rank), the replicated lengths and block
        tables once; a hybrid's RG-LRU state, conv tail and sequence-split
        ring rows ``size`` times, a whole ring once."""
        total = 0
        hybrid = self.config.family == "hybrid"
        conv_whole = conv_local = 1
        if self.config.ssm is not None:
            gn = 2 * self.config.ssm.n_groups * self.config.ssm.d_state
            d_in = self.config.ssm.d_inner(self.config.d_model)
            conv_whole, conv_local = d_in + gn, d_in // self.size + gn

        def add(path, leaf):
            nonlocal total
            if isinstance(leaf, torch.Tensor):
                n = leaf.numel() * leaf.element_size()
                if hybrid:
                    n *= self.size if _HYBRID_SPLIT.search(path) else 1
                elif _HEAD_SPLIT.search(path):
                    n *= self.size
                elif _CONV_TAIL.search(path):
                    n = n // conv_local * conv_whole
                total += n

        sharding.map_with_path(add, cache)
        return total


def max_per_device_bytes(tree, group: TPGroup) -> int:
    """The bytes of ``tree``'s tensors this rank holds, the largest over the
    group's ranks: the per-device footprint the ``<= 0.6x`` gate reads."""
    return group.max(kv_cache.cache_bytes(tree))
