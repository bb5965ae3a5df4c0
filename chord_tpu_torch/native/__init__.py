"""ctypes binding to the shared native C++ library (native/ at the repo
root: nanite.cpp + jobsys.cpp), the same library chord_tpu binds
(chord_tpu/native/__init__.py). Only the entry points the host scene path
needs are bound: the Nanite cluster-LOD build and vertex normals.

The tracked `native/libchordnative.so` is loaded in place. If it does not
load on this machine, `native/*.cpp` are compiled with g++ into the
ignored `build/native/` directory; nothing is ever written into native/.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_NATIVE_DIR = _ROOT / "native"
_TRACKED_LIB = _NATIVE_DIR / "libchordnative.so"
_BUILD_LIB = _ROOT / "build" / "native" / "libchordnative.so"
_lib: Optional[ctypes.CDLL] = None


def _build() -> Path:
    _BUILD_LIB.parent.mkdir(parents=True, exist_ok=True)
    srcs = [str(_NATIVE_DIR / "nanite.cpp"), str(_NATIVE_DIR / "jobsys.cpp")]
    subprocess.run(["g++", "-O2", "-fPIC", "-std=c++17", "-shared", "-o",
                    str(_BUILD_LIB), *srcs, "-lpthread"],
                   check=True, capture_output=True)
    return _BUILD_LIB


def load() -> ctypes.CDLL:
    """Load the tracked library, or build it into build/native/."""
    global _lib
    if _lib is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(_TRACKED_LIB))
    except OSError:
        path = _BUILD_LIB if _BUILD_LIB.exists() else _build()
        lib = ctypes.CDLL(str(path))
    lib.chord_nanite_build.restype = ctypes.c_int
    lib.chord_nanite_build_batch.restype = ctypes.c_int
    lib.chord_vertex_normals.restype = None
    _lib = lib
    return lib


def available() -> bool:
    """True when the library loads (or builds). A missing toolchain or
    library is the one failure this answers False for."""
    try:
        load()
        return True
    except (OSError, subprocess.CalledProcessError, FileNotFoundError):
        return False


def _ptr(a: np.ndarray, ty):
    return a.ctypes.data_as(ctypes.POINTER(ty))


_TABLE_KEYS = ("tri_offset", "tri_count", "lod_level", "sphere", "cone",
               "lod_error", "parent_error", "lod_sphere", "parent_sphere")


def _empty_tables(idx_cap: int, mcap: int) -> dict:
    return {
        "indices": np.zeros((idx_cap, 3), np.int32),
        "tri_offset": np.zeros(mcap, np.int32),
        "tri_count": np.zeros(mcap, np.int32),
        "lod_level": np.zeros(mcap, np.int32),
        "sphere": np.zeros((mcap, 4), np.float32),
        "cone": np.zeros((mcap, 4), np.float32),
        "lod_error": np.zeros(mcap, np.float32),
        "parent_error": np.zeros(mcap, np.float32),
        "lod_sphere": np.zeros((mcap, 4), np.float32),
        "parent_sphere": np.zeros((mcap, 4), np.float32),
    }


def _caps(n_tris: int):
    # the LOD chain sums to < 2x the base triangles (each level halves)
    idx_cap = max(n_tris * 3, 1024)
    return idx_cap, max(idx_cap // 32, 256)


def nanite_build(positions: np.ndarray, indices: np.ndarray,
                 build_lods: bool = True) -> dict:
    """C++ cluster-LOD build -> dict of meshlet tables + index stream
    (keys: indices (T',3), tri_offset, tri_count, lod_level, sphere, cone,
    lod_error, parent_error, lod_sphere, parent_sphere)."""
    lib = load()
    positions = np.ascontiguousarray(positions, np.float32)
    indices = np.ascontiguousarray(indices, np.int32).reshape(-1, 3)
    idx_cap, mcap = _caps(len(indices))
    o = _empty_tables(idx_cap, mcap)
    n_meshlets = ctypes.c_int(0)
    n_tris_total = ctypes.c_int(0)
    f, i = ctypes.c_float, ctypes.c_int
    rc = lib.chord_nanite_build(
        _ptr(positions, f), len(positions), _ptr(indices, i), len(indices),
        1 if build_lods else 0, _ptr(o["indices"], i), idx_cap,
        _ptr(o["tri_offset"], i), _ptr(o["tri_count"], i),
        _ptr(o["lod_level"], i), _ptr(o["sphere"], f), _ptr(o["cone"], f),
        _ptr(o["lod_error"], f), _ptr(o["parent_error"], f),
        _ptr(o["lod_sphere"], f), _ptr(o["parent_sphere"], f),
        mcap, ctypes.byref(n_meshlets), ctypes.byref(n_tris_total))
    if rc != 0:
        raise RuntimeError("chord_nanite_build: capacity exceeded")
    m, t = n_meshlets.value, n_tris_total.value
    return {k: (v[:t] if k == "indices" else v[:m]).copy()
            for k, v in o.items()}


def nanite_build_batch(meshes, build_lods: bool = True) -> list:
    """Parallel C++ LOD builds, one pool task per (positions, indices)
    mesh; returns a list of nanite_build-style dicts."""
    lib = load()
    n = len(meshes)
    if n == 0:
        return []
    pos_l = [np.ascontiguousarray(p, np.float32) for p, _ in meshes]
    idx_l = [np.ascontiguousarray(ix, np.int32).reshape(-1, 3)
             for _, ix in meshes]
    n_verts = np.asarray([len(p) for p in pos_l], np.int32)
    n_tris = np.asarray([len(ix) for ix in idx_l], np.int32)
    caps = [_caps(int(t)) for t in n_tris]
    idx_caps = np.asarray([c[0] for c in caps], np.int32)
    mcaps = np.asarray([c[1] for c in caps], np.int32)
    out = [_empty_tables(ic, mc) for ic, mc in caps]
    n_meshlets = np.zeros(n, np.int32)
    n_tris_total = np.zeros(n, np.int32)

    def arr_ptrs(arrs, ty):
        return (ctypes.POINTER(ty) * n)(*[_ptr(a, ty) for a in arrs])

    f, i = ctypes.c_float, ctypes.c_int
    rc = lib.chord_nanite_build_batch(
        n, arr_ptrs(pos_l, f), _ptr(n_verts, i), arr_ptrs(idx_l, i),
        _ptr(n_tris, i), 1 if build_lods else 0,
        arr_ptrs([o["indices"] for o in out], i), _ptr(idx_caps, i),
        *[arr_ptrs([o[k] for o in out],
                   i if out[0][k].dtype == np.int32 else f)
          for k in _TABLE_KEYS],
        _ptr(mcaps, i), _ptr(n_meshlets, i), _ptr(n_tris_total, i))
    if rc != 0:
        raise RuntimeError("chord_nanite_build_batch: capacity exceeded")
    res = []
    for k_mesh, o in enumerate(out):
        m, t = int(n_meshlets[k_mesh]), int(n_tris_total[k_mesh])
        res.append({k: (v[:t] if k == "indices" else v[:m]).copy()
                    for k, v in o.items()})
    return res


def vertex_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (C++)."""
    lib = load()
    positions = np.ascontiguousarray(positions, np.float32)
    indices = np.ascontiguousarray(indices, np.int32)
    out = np.zeros_like(positions)
    lib.chord_vertex_normals(
        _ptr(positions, ctypes.c_float), len(positions),
        _ptr(indices, ctypes.c_int), len(indices.reshape(-1, 3)),
        _ptr(out, ctypes.c_float))
    return out
