"""repro_torch.analysis — the checks that lock down the port's serving hot
path, the counterpart of ``repro.analysis``.

The paper's central characterization is that auto-regressive decode is
dominated by accelerator *idle* time, not FLOPs (Obs #2), and that capturing
a static-shape step as a graph is the lever (§4.1.2). The serving stack
holds that idle time down with three disciplines that no functional test
sees breaking:

1. **one program, replayed forever**: every hot step is a static program
   that can be captured once as a CUDA graph and replayed (the reference's
   "every decode step hits the jit cache");
2. **caches written in place**: a step that copies a cache-sized buffer
   doubles its bytes and shrinks how many requests the pool holds (the
   reference's donated KV buffers; Fig 1: KV capacity bounds the batch);
3. **no stray host syncs in the per-token loop**: every ``.item()`` /
   ``.cpu()`` / ``bool()`` on a device value inside the step loop blocks the
   host on the card and re-opens the idle bubbles continuous batching
   exists to close.

Two layers, both run by ``python -m repro_torch.analysis``:

**Layer 1, AST lint** (:mod:`repro_torch.analysis.astlint`): a rule-based
walker over ``src/repro_torch``; each rule keyed by an ID that a
``# repro-lint: disable=<ID>`` comment (same line, or a standalone comment
on the line above) suppresses, with its reason:

- ``HS001``: host sync inside a hot-path function (``@hot_path`` or the
  :data:`repro_torch.analysis.hotpath.HOT_PATHS` registry): ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``np.asarray`` / ``np.array``,
  ``torch.cuda.synchronize``, the data-shaped ``nonzero`` /
  ``masked_select`` / ``unique``, ``torch.tensor(..., device=)`` and
  ``bool()`` / ``int()`` / ``float()`` casts. The scheduler's staged wait
  (``self._staging.wait``) is the one sanctioned sync;
- ``TB001``: an ``if`` / ``while`` on a device value (a tensor method or a
  ``torch`` function in its test) inside a hot-path function.

The reference's ``DN001`` (undonated jit cache arguments) has no AST
counterpart: PyTorch has no donation, and its rule moves into the step
audit's in-place check. Findings are matched against a checked-in baseline
(``src/repro_torch/analysis/baseline.json``), whose goal is empty.

**Layer 2, step audit** (:mod:`repro_torch.analysis.trace_audit`): builds
the serving steps (``prefill``, ``decode_step`` contiguous and paged, the
paged ``mixed_step``, ``draft_window`` and ``verify_step`` on both pools) at
the reference's audit geometry, on the pool states two different serving
traces leave, and checks each step's recorded ops:

- **static program**: the same list of (op, output shapes, dtypes) on both
  traces' states (the reference's stable jit cache keys);
- **in place**: every cache leaf keeps its storage across the step, and no
  op outside a kernel allocates a copy as large as a cache leaf;
- **no growth**: no intermediate above 1.25 x the largest signature tensor,
  and no full gathered per-slot K/V transient in the paged decode step;
- **dtypes**: no f64, no bf16 -> f32 widening of 32 KB or more but the
  named allowances;
- **capture** (CUDA only): each step captured as one CUDA graph and
  replayed on both traces' states, its outputs and cache writes equal to an
  eager run's bit for bit.

Run it before sending a serving-path change::

    PYTHONPATH=src python -m repro_torch.analysis --device cpu
    PYTHONPATH=src python -m repro_torch.analysis --ast-only
    PYTHONPATH=src python -m repro_torch.analysis --write-baseline

(``--device cuda``, the default, audits full-width llama3.2-1b on the card.)
"""
from __future__ import annotations

__all__ = ["astlint", "hotpath", "trace_audit"]
