"""Scene builder, flat pools and per-frame instance table (port of
chord_tpu/rhi/scene_arrays.py).

The host side is numpy, as in chord_tpu: MeshData, MaterialData and the
SceneBuilder are copies. ScenePools (the flat frame's geometry, flattened
per instance) and FrameInstances are dataclasses of torch tensors on the
device the caller names (reference: GPUScene pools and object uploads,
renderer/gpu_scene.h:21-171 and renderer.cpp:224-263).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.allocator import Span, SpanAllocator
from ..utils.log import get_logger

log = get_logger("rhi")


def _pad_rows(a: np.ndarray, multiple: int, fill=0) -> np.ndarray:
    pad = (-a.shape[0]) % multiple
    if pad == 0:
        return a
    return np.concatenate(
        [a, np.full((pad,) + a.shape[1:], fill, dtype=a.dtype)], axis=0)


@dataclass
class MeshData:
    """CPU-side mesh: the unit registered into the pools (the analog of one
    GLTF primitive, reference: asset/gltf/asset_gltf.h:260-287)."""

    positions: np.ndarray          # (V,3) f32 local space
    indices: np.ndarray            # (T,3) i32 local vertex indices
    normals: Optional[np.ndarray] = None   # (V,3) f32
    uv0: Optional[np.ndarray] = None       # (V,2) f32
    tangents: Optional[np.ndarray] = None  # (V,4) f32
    uv1: Optional[np.ndarray] = None       # (V,2) f32
    color0: Optional[np.ndarray] = None    # (V,4) f32
    name: str = ""

    def __post_init__(self) -> None:
        self.positions = np.ascontiguousarray(self.positions, np.float32)
        self.indices = np.ascontiguousarray(self.indices, np.int32).reshape(-1, 3)
        if self.normals is None:
            self.normals = compute_vertex_normals(self.positions, self.indices)
        self.normals = np.ascontiguousarray(self.normals, np.float32)
        if self.uv0 is None:
            self.uv0 = np.zeros((len(self.positions), 2), np.float32)
        self.uv0 = np.ascontiguousarray(self.uv0, np.float32)
        for f in ("tangents", "uv1", "color0"):
            v = getattr(self, f)
            if v is not None:
                setattr(self, f, np.ascontiguousarray(v, np.float32))

    @property
    def num_vertices(self) -> int:
        return len(self.positions)

    @property
    def num_triangles(self) -> int:
        return len(self.indices)

    def local_aabb(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.positions.min(0), self.positions.max(0)


def compute_vertex_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals."""
    p = positions.astype(np.float64)
    i0, i1, i2 = indices[:, 0], indices[:, 1], indices[:, 2]
    fn = np.cross(p[i1] - p[i0], p[i2] - p[i0])
    n = np.zeros_like(p)
    for idx in (i0, i1, i2):
        np.add.at(n, idx, fn)
    length = np.linalg.norm(n, axis=1, keepdims=True)
    n = np.where(length > 1e-20, n / np.maximum(length, 1e-20), [0.0, 1.0, 0.0])
    return n.astype(np.float32)


@dataclass
class MaterialData:
    """GLTF metallic-roughness material constants (reference:
    shader/gltf.h GLTFMaterialGPUData)."""

    base_color: Tuple[float, float, float, float] = (0.8, 0.8, 0.8, 1.0)
    metallic: float = 0.0
    roughness: float = 0.8
    emissive: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    base_color_texture: int = -1
    normal_texture: int = -1
    normal_scale: float = 1.0
    metal_rough_texture: int = -1
    emissive_texture: int = -1
    two_sided: bool = False
    alpha_mode: str = "opaque"     # "opaque" | "mask" | "blend"
    alpha_cutoff: float = 0.5
    name: str = ""


@dataclass
class ScenePools:
    """Flat geometry + material pools (the flat frame's scene): every
    instance's mesh copied into one pool, rows padded to 128."""

    positions: torch.Tensor      # (V,3) f32 object-local
    normals: torch.Tensor        # (V,3) f32
    uv0: torch.Tensor            # (V,2) f32
    vertex_object: torch.Tensor  # (V,) i32 object slot per vertex
    indices: torch.Tensor        # (T,3) i32 pool-space
    tri_object: torch.Tensor     # (T,) i32 object slot per triangle
    tri_valid: torch.Tensor      # (T,) bool, False on the padding
    mat_base_color: torch.Tensor   # (M,4) f32
    mat_metal_rough: torch.Tensor  # (M,2) f32
    mat_emissive: torch.Tensor     # (M,3) f32

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[0]

    @property
    def num_vertices(self) -> int:
        return self.positions.shape[0]


@dataclass
class FrameInstances:
    """Per-frame object table in translated world (row-vector matrices)."""

    object_to_tw: torch.Tensor        # (O,4,4) f32
    object_prev_to_tw: torch.Tensor   # (O,4,4) f32
    object_normal_mat: torch.Tensor   # (O,3,3) f32  n' = n @ NM
    object_material: torch.Tensor     # (O,) i32
    object_two_sided: torch.Tensor    # (O,) f32 0/1
    object_masked: torch.Tensor       # (O,) f32 0/1
    object_blend: torch.Tensor        # (O,) f32 0/1
    object_sphere_tw: torch.Tensor    # (O,4) f32 center + radius
    object_obb_tw: torch.Tensor       # (O,12) f32 center + 3 half-axes
    object_valid: torch.Tensor        # (O,) bool


class SceneBuilder:
    """Assembles MeshData + materials + instances (host, numpy)."""

    def __init__(self) -> None:
        self.meshes: List[MeshData] = []
        self.materials: List[MaterialData] = [MaterialData(name="default")]
        # instances: (mesh_id, material_id, local_to_world f64 4x4)
        self.instances: List[Tuple[int, int, np.ndarray]] = []
        self._vspans: List[Span] = []
        self._valloc = SpanAllocator()
        self._talloc = SpanAllocator()

    def add_mesh(self, mesh: MeshData) -> int:
        self.meshes.append(mesh)
        self._vspans.append(self._valloc.allocate(mesh.num_vertices))
        self._talloc.allocate(mesh.num_triangles)
        return len(self.meshes) - 1

    def add_material(self, mat: MaterialData) -> int:
        self.materials.append(mat)
        return len(self.materials) - 1

    def add_instance(self, mesh_id: int, material_id: int = 0,
                     local_to_world: Optional[np.ndarray] = None) -> int:
        if local_to_world is None:
            local_to_world = np.eye(4, dtype=np.float64)
        self.instances.append((mesh_id, material_id,
                               np.asarray(local_to_world, np.float64)))
        return len(self.instances) - 1

    def build_pools(self, pad_multiple: int = 128,
                    device=None) -> ScenePools:
        """Concatenate per-instance geometry into flat pools on `device`
        (None = the card). Shared meshes are copied per instance, so
        tri_object is a plain array (chord_tpu rhi/scene_arrays.py:216)."""
        from ..utils.device import resolve

        device = resolve(device)
        pos, nrm, uv, idx, tobj, vobj = [], [], [], [], [], []
        vbase = 0
        for oid, (mesh_id, _mat, _m) in enumerate(self.instances):
            mesh = self.meshes[mesh_id]
            pos.append(mesh.positions)
            nrm.append(mesh.normals)
            uv.append(mesh.uv0)
            idx.append(mesh.indices + vbase)
            tobj.append(np.full(mesh.num_triangles, oid, np.int32))
            vobj.append(np.full(mesh.num_vertices, oid, np.int32))
            vbase += mesh.num_vertices
        indices = np.concatenate(idx)
        n_tris = len(indices)
        indices = _pad_rows(indices, pad_multiple)
        tri_valid = np.zeros(len(indices), bool)
        tri_valid[:n_tris] = True
        mats = self.materials
        log.info("ScenePools: %d instances, %d verts, %d tris (%d padded), "
                 "%d materials", len(self.instances), vbase, n_tris,
                 len(indices), len(mats))
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        padded = lambda parts: t(_pad_rows(np.concatenate(parts),
                                           pad_multiple))
        return ScenePools(
            positions=padded(pos), normals=padded(nrm), uv0=padded(uv),
            vertex_object=padded(vobj), indices=t(indices),
            tri_object=padded(tobj), tri_valid=t(tri_valid),
            mat_base_color=t(np.array([m.base_color for m in mats],
                                      np.float32)),
            mat_metal_rough=t(np.array([[m.metallic, m.roughness]
                                        for m in mats], np.float32)),
            mat_emissive=t(np.array([m.emissive for m in mats],
                                    np.float32)))

    def frame_instances(self, camera,
                        prev_matrices: Optional[Dict[int, np.ndarray]] = None,
                        device=None) -> FrameInstances:
        """Rebase instance transforms to the camera (translated world) —
        the per-frame host loop (reference: scene/scene.cpp:107-137).
        Tensors land on `device` (None = the card)."""
        from ..utils import math as cmath
        from ..utils.device import resolve

        device = resolve(device)
        n = len(self.instances)
        m_tw = np.zeros((n, 4, 4), np.float32)
        m_prev = np.zeros((n, 4, 4), np.float32)
        nmat = np.zeros((n, 3, 3), np.float32)
        mat_ids = np.zeros(n, np.int32)
        two_sided = np.zeros(n, np.float32)
        masked = np.zeros(n, np.float32)
        blend = np.zeros(n, np.float32)
        spheres = np.zeros((n, 4), np.float32)
        obbs = np.zeros((n, 12), np.float32)

        for oid, (mesh_id, mat_id, l2w) in enumerate(self.instances):
            m = camera.rebase_matrix(l2w)
            m_tw[oid] = m
            pm = prev_matrices.get(oid) if prev_matrices else None
            m_prev[oid] = pm if pm is not None else m
            nmat[oid] = cmath.normal_matrix(l2w).astype(np.float32)
            mat_ids[oid] = mat_id
            two_sided[oid] = 1.0 if self.materials[mat_id].two_sided else 0.0
            mode = self.materials[mat_id].alpha_mode
            masked[oid] = 1.0 if mode == "mask" else 0.0
            blend[oid] = 1.0 if mode == "blend" else 0.0
            amin, amax = self.meshes[mesh_id].local_aabb()
            center_l = (amin + amax) * 0.5
            radius_l = float(np.linalg.norm(amax - amin) * 0.5)
            c = np.append(center_l, 1.0).astype(np.float64) @ l2w
            c_tw = (c[:3] / c[3]) - camera.position
            scale = float(np.max(np.linalg.norm(l2w[:3, :3], axis=1)))
            spheres[oid] = np.append(c_tw.astype(np.float32), radius_l * scale)
            half_l = (amax - amin) * 0.5
            axes = (half_l[:, None] * l2w[:3, :3]).astype(np.float32)
            obbs[oid, 0:3] = c_tw.astype(np.float32)
            obbs[oid, 3:12] = axes.reshape(9)

        t = lambda a: torch.from_numpy(a).to(device)
        return FrameInstances(
            object_to_tw=t(m_tw), object_prev_to_tw=t(m_prev),
            object_normal_mat=t(nmat), object_material=t(mat_ids),
            object_two_sided=t(two_sided), object_masked=t(masked),
            object_blend=t(blend), object_sphere_tw=t(spheres),
            object_obb_tw=t(obbs),
            object_valid=torch.ones(n, dtype=torch.bool, device=device))
