"""Hot-path marking for the HS001 host-sync and TB001 device-branch lint
rules (``analysis/astlint.py``).

A *hot-path* function is one that runs per decode step while requests are
resident: the code where a stray host sync (``.item()``, ``.cpu()``, a
``bool()`` cast on a device value) re-opens the idle bubbles the paper's
Obs #2 measures, and where a data-dependent shape or a branch on a device
value keeps the step from being captured and replayed as one CUDA graph.
Two ways to mark one:

- decorate it with :func:`hot_path` (a runtime no-op; the lint reads the
  decorator statically), or
- list its dotted name in :data:`HOT_PATHS`.

Admission and finish bookkeeping (``_admit_one`` and the like) is not hot:
it runs once a request and already holds a prefill.

This module stays dependency-free: core serving modules import the
decorator, and they must never pull the analysis machinery (ast, json) into
the serving process.
"""
from __future__ import annotations

from typing import Callable, TypeVar

F = TypeVar("F", bound=Callable)

#: Dotted names (``module.qualname``) treated as hot without a decorator.
HOT_PATHS = frozenset({
    # the pool-wide per-token device programs: each is one step the audit
    # (analysis/trace_audit.py) captures as a CUDA graph
    "repro_torch.core.engine.decode_step",
    "repro_torch.core.engine.mixed_step",
    # the speculative step pair: drafts + multi-token verification run once
    # per pool step while a SpeculativeProfile request is resident
    "repro_torch.core.engine.verify_step",
    "repro_torch.core.layerskip.draft_window",
    # the tensor-parallel step family (distributed/tp_pool.py): the same
    # per-token programs on one rank's shard, with the group's reduces
    "repro_torch.core.engine.tp_prefill",
    "repro_torch.core.engine.tp_decode_step",
    "repro_torch.core.engine.tp_mixed_step",
    "repro_torch.core.engine.tp_verify_step",
    "repro_torch.core.layerskip.tp_draft_window",
    # the cross-request prefix cache's trie walks run once per admission
    # (match / insert) and inside the out-of-blocks back-pressure path
    # (reclaim): host code on the admission hot path, guarded against host
    # syncs and casts of device values. The scheduler-side hooks
    # (_prefix_admit, _ensure_or_reclaim) carry @hot_path directly.
    "repro_torch.core.prefix_cache.PrefixCache.match",
    "repro_torch.core.prefix_cache.PrefixCache.insert",
    "repro_torch.core.prefix_cache.PrefixCache.reclaim",
    # replica routing (core/router.py) adds no device program: every replica
    # runs the steps above. Its per-round host code is hot and decorated
    # directly: ReplicaRouter._round and the scheduler's two-phase
    # step_begin / step_finish split it drives.
})


def hot_path(fn: F) -> F:
    """Mark ``fn`` as serving hot path for the AST lint. Runtime no-op:
    returns ``fn`` itself (no wrapper)."""
    fn.__repro_hot_path__ = True  # introspectable, e.g. for tests
    return fn
