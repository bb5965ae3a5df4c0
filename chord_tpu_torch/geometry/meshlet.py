"""Meshlet building (host-side, offline).

Port of chord_tpu/geometry/meshlet.py, the reference's meshlet pipeline front half
(reference: asset/nanite_builder.cpp — meshopt_buildMeshlets with <=255
verts / <=128 tris per meshlet, cone weight; shader/base.h:429-430
kNaniteMeshletMaxVertices/Triangles). The Nanite LOD hierarchy (GMSS loop)
lives in geometry/nanite.py + the C++ builder; this module produces the
LOD0 clusters and their culling data.

Kernel sizing: every meshlet holds exactly <=128 triangles, matching the
raster kernel's chunk width — one visible meshlet becomes one dense
(128, 16) coefficient block, so meshlet granularity and kernel granularity
coincide (no repacking between cull and raster).

Clustering strategy: triangles sorted by Morton code of their centroid,
split into runs of <=128 with a locality-bounded vertex budget. This is a
spatial clusterizer in the spirit of meshopt's (bounding-sphere + cone
quality within a few % for typical meshes) without vendoring it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

MESHLET_MAX_TRIS = 128      # reference: shader/base.h:430
MESHLET_MAX_VERTS = 255     # reference: shader/base.h:429


@dataclass
class MeshletData:
    """Per-mesh meshlet tables (all arrays static after build).

    tri_offset/tri_count index into the mesh's triangle list, which is
    REORDERED so each meshlet's triangles are contiguous (offset aligned
    is not required; counts <= 128).
    """

    # (M,) int32 — first triangle (in the reordered index buffer)
    tri_offset: np.ndarray
    tri_count: np.ndarray          # (M,) int32 <= 128
    sphere: np.ndarray             # (M,4) f32 local-space bounding sphere
    cone_axis: np.ndarray          # (M,3) f32 average normal (normalized)
    cone_cutoff: np.ndarray        # (M,) f32; cull if dot(view, axis) >= cutoff
    # LOD fields (filled by the Nanite builder; LOD0 defaults here)
    lod_error: np.ndarray          # (M,) f32 this cluster's error (LOD0: 0)
    parent_error: np.ndarray       # (M,) f32 parent error (root: +inf)
    lod_sphere: np.ndarray         # (M,4) f32 group merge sphere for projection

    @property
    def count(self) -> int:
        return len(self.tri_offset)


def morton_codes(centroids: np.ndarray, bits: int = 10) -> np.ndarray:
    """(T,3) centroids -> (T,) uint64 Morton codes."""
    lo = centroids.min(0)
    extent = np.maximum(centroids.max(0) - lo, 1e-12)
    q = np.clip(((centroids - lo) / extent) * (2 ** bits - 1), 0,
                2 ** bits - 1).astype(np.uint64)

    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0xF00F00F00F00F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x30C30C30C30C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x9249249249249249)
        return v

    return (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) |
            (spread(q[:, 2]) << np.uint64(2)))


def _bounding_sphere(points: np.ndarray) -> np.ndarray:
    """Ritter-ish bounding sphere (center, radius)."""
    c = (points.min(0) + points.max(0)) * 0.5
    r = np.sqrt(((points - c) ** 2).sum(1).max())
    return np.concatenate([c, [r]]).astype(np.float32)


def build_meshlets(
    positions: np.ndarray,     # (V,3) f32
    indices: np.ndarray,       # (T,3) i32
    max_tris: int = MESHLET_MAX_TRIS,
    max_verts: int = MESHLET_MAX_VERTS,
) -> Tuple[MeshletData, np.ndarray]:
    """-> (MeshletData, reordered_indices (T,3)).

    Triangles are Morton-sorted by centroid then packed greedily into
    meshlets of <= max_tris triangles / <= max_verts distinct vertices.
    """
    tris = np.asarray(indices, np.int64).reshape(-1, 3)
    t = len(tris)
    if t == 0:
        empty = MeshletData(
            tri_offset=np.zeros(0, np.int32), tri_count=np.zeros(0, np.int32),
            sphere=np.zeros((0, 4), np.float32),
            cone_axis=np.zeros((0, 3), np.float32),
            cone_cutoff=np.zeros(0, np.float32),
            lod_error=np.zeros(0, np.float32),
            parent_error=np.zeros(0, np.float32),
            lod_sphere=np.zeros((0, 4), np.float32))
        return empty, indices.copy()

    centroids = positions[tris].mean(axis=1)
    order = np.argsort(morton_codes(centroids), kind="stable")
    tris_sorted = tris[order]

    # Greedy packing with vertex budget.
    offsets = [0]
    counts = []
    seen: set = set()
    count = 0
    for i in range(t):
        tv = tris_sorted[i]
        new = {int(v) for v in tv} - seen
        if count >= max_tris or (count > 0 and len(seen) + len(new) > max_verts):
            counts.append(count)
            offsets.append(i)
            seen = set()
            count = 0
            new = {int(v) for v in tv}
        seen |= new
        count += 1
    counts.append(count)

    m = len(counts)
    tri_offset = np.asarray(offsets, np.int32)
    tri_count = np.asarray(counts, np.int32)

    # Per-meshlet bounds + normal cone.
    p = positions.astype(np.float64)
    fn = np.cross(p[tris_sorted[:, 1]] - p[tris_sorted[:, 0]],
                  p[tris_sorted[:, 2]] - p[tris_sorted[:, 0]])
    fn_len = np.linalg.norm(fn, axis=1, keepdims=True)
    fn = np.where(fn_len > 1e-20, fn / np.maximum(fn_len, 1e-20), 0.0)

    sphere = np.zeros((m, 4), np.float32)
    cone_axis = np.zeros((m, 3), np.float32)
    cone_cutoff = np.ones(m, np.float32)
    for k in range(m):
        sl = slice(tri_offset[k], tri_offset[k] + tri_count[k])
        verts = positions[np.unique(tris_sorted[sl])]
        sphere[k] = _bounding_sphere(verts)
        axis = fn[sl].sum(0)
        n = np.linalg.norm(axis)
        if n > 1e-12:
            axis = axis / n
            # cutoff: cos of the max deviation of any face normal from axis
            min_dot = float((fn[sl] @ axis).min())
            cone_axis[k] = axis
            # cull when dot(cone_axis, -view_dir) < -sin(angle): use the
            # meshopt-style cutoff = sqrt(1 - min_dot^2) sign-safe form.
            cone_cutoff[k] = (np.sqrt(max(0.0, 1.0 - min_dot * min_dot))
                              if min_dot > 0.0 else 1.0)
        else:
            cone_cutoff[k] = 1.0   # degenerate: never cone-cull

    data = MeshletData(
        tri_offset=tri_offset, tri_count=tri_count, sphere=sphere,
        cone_axis=cone_axis, cone_cutoff=cone_cutoff,
        lod_error=np.zeros(m, np.float32),
        parent_error=np.full(m, np.float32(3e38)),   # LOD0-only: always drawn
        lod_sphere=sphere.copy())
    return data, tris_sorted.astype(np.int32)
