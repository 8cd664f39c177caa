"""Tensor-parallel serving pool: one scheduler per rank of a
``torch.distributed`` group, each holding its shard of the params and the
KV pool — the counterpart of ``repro/distributed/tp_pool.py``.

The reference is one controller over a ``("model",)`` mesh whose
collectives GSPMD inserts. The port runs SPMD: ``tp`` processes, started by
:func:`spawn`, each with a :class:`TPGroup` (its rank, its device and the
two collectives the model uses) and a :class:`TPContext`:

- the rank's param shard, cut by ``sharding.tp_param_specs`` (megatron
  column / row splits, the vocab-split embedding and LM head, the q/k/v
  biases with their columns) through ``sharding.shard_tree``;
- a rank-local model: the config at ``n_heads / tp``, ``n_kv_heads / tp``
  and ``d_ff / tp``, whose forward reduces after each row-parallel linear
  (``attn/wo``, ``ffn/w2``) and after the vocab-parallel embedding lookup,
  so its pools (``SlotPool``, ``BlockPool``) hold the rank's KV heads: the
  head split of ``sharding.cache_specs_tp``, with block tables and lengths
  whole on every rank;
- :meth:`TPContext.executables`, the TP step family (``engine.tp_prefill``,
  ``tp_decode_step``, ``tp_mixed_step``, ``tp_verify_step`` and
  ``layerskip.tp_draft_window``) with the single-device call signatures:
  the seam ``Scheduler(tp=...)`` routes every step through.

Collectives are ``all_reduce`` and ``broadcast`` only, the two that gloo
offers on CUDA tensors. The backend follows one rule: ``gloo`` when the
ranks run on the CPU or share a card (NCCL refuses two ranks on one
device), ``nccl`` when each rank has a card of its own. Every rank's host
state stays the same by construction: rank 0 broadcasts every token the
scheduler commits and every clock reading it acts on, so admissions,
preemptions, block tables and the prefix cache agree and the ranks enter
the same collectives in the same order.

A collective waits on the host under gloo, so a TP step syncs: the
no-sync contract of ``Scheduler.step_begin`` holds for single-device steps
only, and a TP step is not captured as a CUDA graph.

Refused, by name (ROADMAP, Queue 1, step 6): families other than ``dense``;
``n_kv_heads``, ``n_heads``, ``d_ff`` or the vocabulary not divisible by
``tp`` (the reference falls back to the sequence axis or replicates);
AutoQuant'd leaves.
"""
from __future__ import annotations

import os
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


class TPGroup:
    """One rank's handle on its tensor-parallel group: ``rank`` of ``size``
    on ``device``, and the group's two collectives. A group of one rank
    (``size == 1``) needs no process group: its collectives return their
    input. Counts each ``all_reduce`` and its host seconds (``n_reduces``,
    ``reduce_s``) and each ``broadcast`` (``n_broadcasts``)."""

    def __init__(self, rank: int, size: int, device, backend: Optional[str] = None):
        self.rank, self.size = rank, size
        self.device = torch.device(device)
        self.backend = backend
        self.n_reduces = 0
        self.reduce_s = 0.0
        self.n_broadcasts = 0

    def __repr__(self) -> str:
        return f"TPGroup(rank={self.rank}, size={self.size}, device={self.device})"

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks, in place; returns ``x``."""
        if self.size == 1:
            return x
        t = time.perf_counter()
        dist.all_reduce(x)
        self.reduce_s += time.perf_counter() - t
        self.n_reduces += 1
        return x

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank, in place; returns ``x``."""
        if self.size == 1:
            return x
        dist.broadcast(x, src)
        self.n_broadcasts += 1
        return x

    def _host_scalar(self, value, dtype) -> torch.Tensor:
        # gloo takes host tensors; nccl only device ones
        dev = self.device if self.backend == "nccl" else torch.device("cpu")
        return torch.tensor([value], dtype=dtype, device=dev)

    def max(self, value: int) -> int:
        """The largest of every rank's ``value``."""
        if self.size == 1:
            return int(value)
        t = self._host_scalar(value, torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return int(t[0])

    def shared_clock(self, clock: Callable[[], float]) -> Callable[[], float]:
        """``clock`` as rank 0 reads it, on every rank: each call is one
        broadcast, so every rank's scheduler sees the same times and makes
        the same admissions."""
        if self.size == 1:
            return clock

        def read() -> float:
            t = self._host_scalar(clock() if self.rank == 0 else 0.0, torch.float64)
            dist.broadcast(t, 0)
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
    return TPGroup(rank, tp, devs[rank], backend)


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

def check_supported(cfg: ModelConfig, tp: int) -> None:
    """Raise for what TP serving refuses, naming its ROADMAP item."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"tensor parallelism serves the dense family only, not {cfg.family!r}: "
            f"{ROADMAP_ITEM}")
    for what, n in (("n_kv_heads", cfg.n_kv_heads), ("n_heads", cfg.n_heads),
                    ("d_ff", cfg.d_ff), ("vocab_size", cfg.vocab_size)):
        if n % tp:
            raise NotImplementedError(
                f"{what} = {n} does not split over tp = {tp} (the reference falls back to "
                f"the sequence axis or replicates): {ROADMAP_ITEM}")
    if cfg.scan_layers:
        raise NotImplementedError("scan_layers: the port runs unrolled layers")


def local_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """One rank's widths: its q and KV heads and its FFN columns."""
    return cfg.replace(n_heads=cfg.n_heads // tp, n_kv_heads=cfg.n_kv_heads // tp,
                       d_head=cfg.head_dim, d_ff=cfg.d_ff // tp)


def _leaf_paths(tree) -> List[str]:
    paths: List[str] = []
    sharding.map_with_path(lambda p, leaf: paths.append(p), tree)
    return paths


class TPContext:
    """One rank's tensor-parallel pool: its param shard (``params``), its
    rank-local model (``model``: the widths of :func:`local_config`, the
    group attached, so its caches hold the rank's KV heads) and the TP step
    family (:meth:`executables`). ``config`` is the whole model's."""

    def __init__(self, model: Model, params, group: TPGroup):
        cfg = model.config
        check_supported(cfg, group.size)
        if any(re.search(r"/w_q_(wo|dyn)$", p) for p in _leaf_paths(params)):
            raise NotImplementedError(f"AutoQuant'd leaves under tensor parallelism: "
                                      f"{ROADMAP_ITEM}")
        self.config, self.group = cfg, group
        self.size, self.rank, self.device = group.size, group.rank, group.device
        self.model = Model(config=local_config(cfg, group.size), module=model.module,
                           tp=group)
        specs = sharding.tp_param_specs(cfg, params, group.size)
        shard = sharding.shard_tree(params, specs, group.rank, group.size)
        self.params = kv_cache._map(lambda t: t.to(self.device), shard)

    def executables(self) -> types.SimpleNamespace:
        """The TP step family with the single-device call signatures."""
        from repro_torch.core import engine, layerskip

        return types.SimpleNamespace(
            prefill=engine.tp_prefill, decode_step=engine.tp_decode_step,
            mixed_step=engine.tp_mixed_step, verify_step=engine.tp_verify_step,
            draft_window=layerskip.tp_draft_window)

    def whole_bytes(self, cache) -> int:
        """The bytes of the pool this rank holds a shard of, counted once:
        K/V leaves (split by heads) ``size`` times, the replicated lengths and
        block tables once."""
        total = 0

        def add(path, leaf):
            nonlocal total
            if isinstance(leaf, torch.Tensor):
                n = leaf.numel() * leaf.element_size()
                total += n * self.size if re.search(r"layers/\d+/(k|v)$", path) else n

        sharding.map_with_path(add, cache)
        return total


def max_per_device_bytes(tree, group: TPGroup) -> int:
    """The bytes of ``tree``'s tensors this rank holds, the largest over the
    group's ranks: the per-device footprint the ``<= 0.6x`` gate reads."""
    return group.max(kv_cache.cache_bytes(tree))
