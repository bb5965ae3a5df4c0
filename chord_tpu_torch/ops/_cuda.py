"""Build and load the hand-written CUDA kernels (chord_tpu_torch/csrc/).

The kernels have a plain C interface and are compiled with nvcc for
sm_90a — one nvcc per source, all started together, then one link — into
one shared library under the ignored `build/` directory at first use, and
loaded with ctypes (no PyTorch headers: the build takes seconds). The
library name carries a hash of the sources and flags, so an edited kernel
is rebuilt and a stale library is never loaded.

`-fmad=false` keeps every multiply and add separately rounded, so each
kernel is bit-comparable to its plain PyTorch version; a later change that
tunes a kernel may revisit it.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

import torch

_ROOT = Path(__file__).resolve().parents[2]
CSRC = _ROOT / "chord_tpu_torch" / "csrc"
BUILD_DIR = _ROOT / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def sources(csrc: Path = CSRC):
    return sorted(csrc.glob("*.cu"))


def library_path(csrc: Path = CSRC) -> Path:
    h = hashlib.sha256()
    for src in sources(csrc) + sorted(csrc.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libchord_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands at once; -> [(returncode, stderr)] in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    return [(p.wait(), p.stderr.read()) for p in procs]


def build(verbose: bool = False, csrc: Path = CSRC) -> Path:
    """Compile csrc/*.cu (or another source directory's, for comparing
    designs) into the build directory (if not already there): one nvcc per
    source in parallel, then one link. ptxas's report of each source
    (-Xptxas -v) is kept beside the library (ptxas_report) and printed
    when `verbose`."""
    out = library_path(csrc)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    srcs = sources(csrc)
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in srcs]
    results = _run_all([[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                         str(o), str(src)] for src, o in zip(srcs, objs)])
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if all(rc == 0 for rc, _ in results):
        results += _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                              *map(str, objs)]])
    for o in objs:
        o.unlink(missing_ok=True)
    for (rc, err), name in zip(results, [s.name for s in srcs] + ["link"]):
        if rc != 0:
            raise RuntimeError(f"nvcc failed on {name} ({rc}):\n{err}")
        if verbose and err:
            print(f"{name}:\n{err}")
    _report_path(out).write_text(json.dumps(
        {src.name: err for src, (_, err) in zip(srcs, results)}))
    os.replace(tmp, out)
    return out


def _report_path(library: Path) -> Path:
    return library.with_suffix(".ptxas.json")


def ptxas_report(csrc: Path = CSRC) -> Dict[str, str]:
    """{source file name: its -Xptxas -v report} of the library built from
    `csrc` ({} if it was built without one)."""
    path = _report_path(library_path(csrc))
    return json.loads(path.read_text()) if path.exists() else {}


def ptxas_usage(report: str) -> List[dict]:
    """Per kernel function of a -Xptxas -v report: its (mangled) name,
    registers, shared memory bytes and spill store / load bytes."""
    out: List[dict] = []
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            out.append(dict(function=m.group(1)))
            continue
        if not out:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[-1].update(spill_stores=int(m.group(1)),
                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[-1]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[-1]["smem"] = int(m.group(1)) if m else 0
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
