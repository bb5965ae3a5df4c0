"""Build and load the hand-written CUDA kernels (chord_tpu_torch/csrc/).

The kernels have a plain C interface and are compiled with nvcc for
sm_90a into one shared library under the ignored `build/` directory at
first use, then loaded with ctypes (no PyTorch headers: the build takes
seconds). The library name carries a hash of the sources and flags, so an
edited kernel is rebuilt and a stale library is never loaded.

`-fmad=false` keeps every multiply and add separately rounded, so each
kernel is bit-comparable to its plain PyTorch version; a later change that
tunes a kernel may revisit it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

_ROOT = Path(__file__).resolve().parents[2]
CSRC = _ROOT / "chord_tpu_torch" / "csrc"
BUILD_DIR = _ROOT / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libchord_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into the build directory (if not already there)."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), *map(str, sources())]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose and res.stderr:
        print(res.stderr)
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def cint(v) -> ctypes.c_int:
    return ctypes.c_int(int(v))


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def launch(name: str, *args) -> None:
    """Call C entry point `name`; every pointer and the stream go as
    c_void_p, every int as c_int. Raises on a non-zero launch error."""
    fn = getattr(lib(), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [type(a) for a in args]
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> None:
    """Wrapper-side argument check for a kernel input."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor (got {t.device})")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} (got {t.dtype})")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)} "
                         f"(got {tuple(t.shape)})")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
