"""One step captured as a CUDA graph: the port's counterpart of a jitted
program replayed forever (paper §4.1.2).

:func:`capture` warms a step up once on a side stream (cuBLAS handles,
kernel attributes and the allocator's blocks set up outside the capture),
lets the caller undo what that call did to its state, and records one call
into a ``torch.cuda.CUDAGraph``. The step must be a function of tensors it
writes in place (static inputs and state); the captured call's outputs are
static too, rewritten by every replay. A step that cannot be captured (a
host sync, a data-dependent shape) raises here: nothing falls back to an
eager loop.

Replays run no Python, so the kernel wrappers' launch counters do not move:
the warm-up and the capture are taken out of the counters again, and
:func:`capture` returns the captured call's counts for the caller to add
once a replay (``kernels.counts.add``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels import counts


def capture(step: Callable[[], Any], restore: Optional[Callable[[], None]] = None
            ) -> Tuple["torch.cuda.CUDAGraph", Any, Dict[str, int]]:
    """Warm ``step`` up once on a side stream, call ``restore`` (undo the
    warm-up's writes), and capture one call of ``step``. Returns (graph, the
    captured call's outputs, its launches by kernel). The launch counters
    are left as they were before the warm-up."""
    before = counts.snapshot()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    if restore is not None:
        restore()
    mid = counts.snapshot()
    try:
        graph, out = _capture_one(step)
        per_call = counts.since(mid)
    finally:
        counts.restore(before)
    return graph, out, per_call


def _capture_one(step: Callable[[], Any]):
    """One call of ``step`` captured on a side stream into a new graph and
    its private memory pool. A call that cannot be captured raises, and the
    capture is ended first: the stream leaves capture mode, the allocator
    stops routing into the graph's pool and the pool is released, so the
    program goes on on its own stream. (``torch.cuda.graph``'s exit skips
    all three when ``capture_end`` raises, as it does after a failed
    capture.)"""
    graph = torch.cuda.CUDAGraph()
    pool = torch.cuda.graph_pool_handle()
    stream = torch.cuda.Stream()
    torch.cuda.synchronize()  # as torch.cuda.graph: nothing pending crosses into the capture
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool)
        try:
            out = step()
        except BaseException:
            try:
                graph.capture_end()  # ends the stream's capture; raises once it was invalidated
            except RuntimeError:
                dev = torch.cuda.current_device()
                torch._C._cuda_endAllocateToPool(dev, pool)
                torch._C._cuda_releasePool(dev, pool)
            raise
        graph.capture_end()
    return graph, out
