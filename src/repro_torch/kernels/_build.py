"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (all sources at
once, one process each), linked into ONE shared library with a plain C
interface, and loaded with ``ctypes``. Nothing includes PyTorch's headers,
so a build takes seconds. The library lands in ``build/repro_torch_kernels/``
at the repository root, named by a hash of the sources and flags: an
edited ``.cu`` rebuilds, an unchanged tree reuses the library. A failed
build raises; nothing falls back to the plain versions.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()`` right after the launch; :func:`check` turns a
non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
#: argtypes of every C entry point (pointers and the stream as c_void_p,
#: or ctypes would pass a 32-bit int and cut them).
SIGNATURES: Dict[str, List] = {
    # dtype, prologue, warps, per_lane, x, r, r_stride, weight, s, y, n_rows, d, eps,
    # stream
    "rmsnorm_launch": [_I, _I, _I, _I, _P, _P, ctypes.c_longlong, _P, _P, _P,
                       ctypes.c_longlong, _I, ctypes.c_float, _P],
    # dtype, prologue, x, r, r_stride, p, sumsq, n_rows, d, stream
    "rmsnorm_partial_launch": [_I, _I, _P, _P, ctypes.c_longlong, _P, _P, ctypes.c_longlong,
                               _I, _P],
    # dtype, p, sumsq, weight, y, n_rows, d, d_total, eps, stream
    "rmsnorm_scale_launch": [_I, _P, _P, _P, _P, ctypes.c_longlong, _I, ctypes.c_float,
                             ctypes.c_float, _P],
    # dtype, q, k, v, q_pos, k_pos, k_valid, out, B, Tq, Tk, Hq, Hkv, D, Dv,
    # causal, window, scale, stream
    "flash_attention_launch": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _I, _I, _I, ctypes.c_float, _P],
    # dtype, q, kv, q_pos, k_pos, k_valid, out, B, Tq, Tk, Hq, D, Dv, causal, window,
    # scale, stream
    "flash_attention_latent_launch": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                      _I, _I, ctypes.c_float, _P],
    # dtype, q, k, v, lengths, out, partial, B, S, Hq, Hkv, D, splits, split_len,
    # scale, stream
    "decode_attention_launch": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                ctypes.c_float, _P],
    # dtype, q, k, v, n_valid, out (the f32 triple), partial, B, S, Hq, Hkv, D, splits,
    # split_len, scale, stream
    "decode_attention_partial_launch": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                        _I, ctypes.c_float, _P],
    # acc, m, l, out, P, B, H, D, the strides of acc, m and l over (part, row, head),
    # stream
    "decode_attention_merge_launch": [_P, _P, _P, _P, _I, _I, _I, _I,
                                      *[ctypes.c_longlong] * 9, _P],
    # dtype, q, kbuf, vbuf, bt, n_valid, out, partial, B, NB, bs, MB, Hq, Hkv, D,
    # splits, split_len, scale, stream
    "paged_decode_attention_launch": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                      _I, _I, _I, _I, ctypes.c_float, _P],
    # dtype, q, kv, lengths, bt, NB, bs, out, partial, B, S, Hq, D, Dv, splits,
    # split_len, scale, stream
    "decode_attention_latent_launch": [_I, _P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _I,
                                       _I, _I, _I, ctypes.c_float, _P],
    # dtype, x, w_q, w_scale, out, partial, M, N, K, splits, k_chunk, stream
    "int8_matmul_wo_launch": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x_q, w_q, w_scale, x_scale, out, partial, M, N, K, splits, k_chunk, stream
    "int8_matmul_dyn_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # dtype, q, k, v, rel_bias, lengths, out, B, T, H, D, n_bias, max_attn_len,
    # scale, stream
    "hstu_attention_launch": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              ctypes.c_float, _P],
    # dtype, x, dt, A, B, C, D, h0, y, hT, cum_ws, states, B, T, H, P, G, N,
    # chunk, stream
    "ssd_scan_launch": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _I, _I, _I, _P],
}

def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    return BUILD_DIR / f"libreprotorch_{_digest()}.so"


def build() -> Path:
    """Compile every source in parallel and link the shared library (or
    reuse it when the sources are unchanged). Raises on any failure; the
    compiler's resource report (registers, spills) is kept in
    ``build.log`` beside the library."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        objs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC), "-c",
                   str(src), "-o", str(obj)]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        log = []
        failed = []
        for src, p in procs:
            text, _ = p.communicate()
            log.append(f"== {src.name} (rc {p.returncode})\n{text}")
            if p.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        log.append(f"== link (rc {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("linking the kernel library failed:\n" + "\n".join(log))
        (BUILD_DIR / "build.log").write_text("\n".join(log))
        os.replace(tmp_lib, out)  # atomic: a reader never sees half a file
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use), with every entry
    point's ``argtypes``/``restype`` declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


#: the C interface's element-type codes (common.cuh)
F32, BF16 = 0, 1
_CODES = {torch.float32: F32, torch.bfloat16: BF16}


def dtype_code(t) -> int:
    """The C interface's element-type code of tensor ``t``; raises for a
    type no kernel is instantiated for."""
    code = _CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return code


def stream_of(t) -> int:
    """Raw handle of PyTorch's current stream on ``t``'s device (the raw
    query: no Stream object is built on every launch)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


@functools.lru_cache(maxsize=None)
def n_sms(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (the kernels'
    grid plans fill them)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def require_cuda(name: str, *tensors) -> None:
    """A kernel wrapper's device/contiguity gate: every tensor must be a
    contiguous CUDA tensor on one device, else raise (never fall back)."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors, got {t.device}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors only")


def leading_slice(v, k) -> bool:
    """True when ``v`` is the view ``k[..., :Dv]`` of a contiguous ``k``:
    MLA's latent, whose V is the cached K's leading ``kv_lora_rank``
    columns (a kernel reads it from K, never from a copy)."""
    return (k.is_contiguous() and v.data_ptr() == k.data_ptr() and v.dim() == k.dim()
            and v.shape[:-1] == k.shape[:-1] and v.stride() == k.stride()
            and v.shape[-1] <= k.shape[-1])


def require_rows(name: str, t, like):
    """The row-strided gate, for a kernel's second operand only: ``t`` must
    be a CUDA tensor of ``like``'s shape, type and device whose rows share
    one stride with a unit last stride (a slice of a wider tensor's last
    axis passes, a transpose does not). Returns ``t`` viewed as
    ``[rows, d]`` (None when it is empty); raises otherwise (never copies)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors, got {t.device}")
    if t.device != like.device:
        raise ValueError(f"{name}: tensors on {like.device} and {t.device}")
    if t.shape != like.shape:
        raise ValueError(f"{name}: operands of shapes {tuple(like.shape)} and {tuple(t.shape)}")
    if t.dtype != like.dtype:
        raise TypeError(f"{name}: operands of types {like.dtype} and {t.dtype}")
    if t.numel() == 0:
        return None
    d = t.shape[-1]
    try:
        rows = t.view(-1, d)
    except RuntimeError:
        rows = None
    if rows is None or (d > 1 and rows.stride(1) != 1):
        raise ValueError(f"{name}: the second operand must be rows of one stride with a unit "
                         f"last stride, got strides {t.stride()}")
    return rows


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {code}")
