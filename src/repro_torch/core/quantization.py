"""AutoQuant (paper §4.2): per-layer int8 quantization with automatic
mode selection — the counterpart of ``repro/core/quantization.py``.

Two modes, mirroring torchao AutoQuant's menu:
- ``wo``  (weight-only): weights stored int8 + per-channel scale, applied
          in the GEMM's epilogue. Wins when the GEMM is bound by bytes
          (decode: tokens/step << ridge point): half the weight traffic.
- ``dyn`` (dynamic): activations quantized per row on the fly, int8×int8
          GEMM accumulated in int32. Wins when bound by operations
          (prefill/train).

The selector is the paper's tuning flow: shape calibration (the token
count each linear layer sees per step), then either (a) the analytic
roofline choice, the layer's arithmetic intensity against the card's
ridge point, or (b) measured timing of both kernels
(``calibrate="measure"``), picking the faster.

A quantized linear is the dict ``{"w_q_<mode>": int8 [K,N],
"w_scale": f32 [N], ("b")}``: the mode is structural, in the key, as in
the reference. ``models.layers.dense`` sends a dict without ``"w"`` here.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.kernels import ops

# H100 SXM roofline: dense bf16 tensor-core peak and HBM3 bandwidth.
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12
# ≈147.6 rows: the bf16 GEMM ridge. The reference's TPU v5e constants give
# ≈120.3, so the two choose different modes only for tokens_per_step in
# 121–147 (the reference "dyn", the port "wo").
RIDGE_TOKENS = PEAK_FLOPS_BF16 / HBM_BW / 2


def quantize_linear(p: Dict[str, torch.Tensor], mode: str) -> Dict[str, torch.Tensor]:
    """{"w": [K,N] or stacked [L,K,N], ...} -> quantized-linear dict.
    Quantizes along the contraction dim (-2), so a stack keeps per-layer
    per-channel scales."""
    assert mode in ("wo", "dyn")
    w_q, w_scale = ops.quantize_int8(p["w"], axis=p["w"].ndim - 2)
    out = {f"w_q_{mode}": w_q, "w_scale": w_scale}
    if "b" in p:
        out["b"] = p["b"]
    return out


def qdense(p: Dict[str, torch.Tensor], x: torch.Tensor, impl: str = "auto",
           row_group=None) -> torch.Tensor:
    """Forward through a (possibly) quantized linear param dict; ``impl``
    picks the int8 kernels or their plain versions (``kernels/ops.py``).
    ``row_group`` (a tensor-parallel group) marks a row-parallel linear,
    whose ``x`` holds the rank's slice of K: a dynamic linear takes each
    row's activation scale over the whole row (one ``all_reduce_max``), so
    its codes are the single device's and the ranks' partial outputs sum to
    its output as a bf16 linear's do. A weight-only linear needs nothing:
    its scale is per output column."""
    if "w_q_dyn" in p:
        amax = row_group.all_reduce_max if row_group is not None else None
        y = ops.int8_matmul_dynamic(x, p["w_q_dyn"], p["w_scale"], impl=impl,
                                    amax_reduce=amax).to(x.dtype)
    elif "w_q_wo" in p:
        y = ops.int8_matmul_weight_only(x, p["w_q_wo"], p["w_scale"], impl=impl).to(x.dtype)
    else:
        y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def _is_linear(p: Any) -> bool:
    return (
        isinstance(p, dict)
        and "w" in p
        and hasattr(p["w"], "ndim")
        and p["w"].ndim in (2, 3)  # plain [K,N] or scanned stack [L,K,N]
    )


_SKIP_KEYS = ("embed", "router", "norm", "rel_bias")  # paper: linears only


def _walk(tree: Any, fn: Callable[[Tuple[str, ...], dict], dict], path=()):
    if _is_linear(tree) and not any(s in k for k in path for s in _SKIP_KEYS):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, fn, path + (str(i),)) for i, v in enumerate(tree)]
    return tree


def quantize_params(params: Any, mode: str = "wo") -> Any:
    """Quantize every eligible linear layer with a single mode."""
    return _walk(params, lambda path, p: quantize_linear(p, mode))


def roofline_mode(tokens_per_step: int) -> str:
    """Analytic AutoQuant decision: below the GEMM ridge point the layer is
    bound by weight bytes (weight-only wins); above it by operations
    (dynamic int8 doubles the tensor-core rate)."""
    return "wo" if tokens_per_step < RIDGE_TOKENS else "dyn"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_mode(w: torch.Tensor, tokens_per_step: int, n_iter: int = 20) -> str:
    """Measured AutoQuant decision (the paper's timing calibration step):
    both modes on ``w``'s device, host clock around synchronized calls. On
    a CUDA tensor it times the kernels, on a CPU tensor the plain
    versions."""
    k, n = w.shape
    x = torch.ones((tokens_per_step, k), dtype=torch.bfloat16, device=w.device)
    cands = {}
    with torch.inference_mode():
        for mode in ("wo", "dyn"):
            qp = quantize_linear({"w": w}, mode)
            qdense(qp, x)
            _sync(w.device)
            t0 = time.perf_counter()
            for _ in range(n_iter):
                qdense(qp, x)
            _sync(w.device)
            cands[mode] = time.perf_counter() - t0
    return min(cands, key=cands.get)


def autoquant(
    params: Any,
    *,
    tokens_per_step: int,
    calibrate: str = "roofline",
) -> Tuple[Any, Dict[str, int]]:
    """AutoQuant a param tree. Returns (new_params, {'wo': n, 'dyn': n}).

    ``tokens_per_step`` is the calibrated activation row count (batch for
    decode; batch*seq for prefill) — the paper's "shape calibration"."""
    counts = {"wo": 0, "dyn": 0}

    def decide(path, p):
        if calibrate == "measure":
            mode = measure_mode(p["w"], tokens_per_step)
        else:
            mode = roofline_mode(tokens_per_step)
        counts[mode] += 1
        return quantize_linear(p, mode)

    return _walk(params, decide), counts


def quantization_error(params: Any, qparams: Any, x: torch.Tensor) -> float:
    """Max relative logit error of a single quantized linear (test hook)."""
    y = (x @ params["w"]).float()
    yq = qdense(qparams, x).float()
    return float((yq - y).abs().max() / torch.clamp(y.abs().max(), min=1e-9))
