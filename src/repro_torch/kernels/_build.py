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
    # dtype, x, weight, out, n_rows, d, eps, stream
    "rmsnorm_launch": [_I, _P, _P, _P, ctypes.c_longlong, _I, ctypes.c_float, _P],
    # dtype, q, k, v, q_pos, k_pos, k_valid, out, B, Tq, Tk, Hq, Hkv, D,
    # causal, window, scale, stream
    "flash_attention_launch": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _I, _I, ctypes.c_float, _P],
    # dtype, q, k, v, lengths, out, B, S, Hq, Hkv, D, scale, stream
    "decode_attention_launch": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                ctypes.c_float, _P],
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


def dtype_code(t) -> int:
    """The C interface's element-type code of tensor ``t`` (common.cuh);
    raises for a type no kernel is instantiated for."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if t.dtype not in codes:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return codes[t.dtype]


def stream_of(t) -> int:
    """Raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


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


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {code}")
