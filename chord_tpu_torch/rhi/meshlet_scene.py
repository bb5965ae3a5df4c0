"""Meshlet-based scene pools: shared geometry + instance-meshlet draw pairs
(port of chord_tpu/rhi/meshlet_scene.py).

The tables are built on the host with numpy exactly as chord_tpu builds
them, then moved to the device the caller names (the card by default).
Each mesh's geometry is stored once; the pair table expands instances x
their mesh's meshlets (reference: instance_culling.hlsl:48-208 draw
stream). The texture pool rides along twice: the raw u8 flat-mip stack
(`tex_pool`, the sampling oracle's input and the source of `tex_size`)
and its paged form (`tex_pages` + `tex_meta`, kernel K5's input).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..geometry.meshlet import build_meshlets
from ..ops.paged_texture import pack_paged_pool
from ..utils.device import resolve
from ..utils.log import get_logger
from .scene_arrays import SceneBuilder

log = get_logger("rhi.meshlet")

MESHLET_TRIS = 128   # raster window width == meshlet max tris


def _empty_tex_pool() -> np.ndarray:
    """1-layer 1x1 placeholder (total texels for size=1 is 1)."""
    return np.full((1, 1, 4), 255, np.uint8)


@dataclass
class MeshletScenePools:
    """Device pools for the meshlet path (torch tensors)."""

    positions: torch.Tensor       # (V,3) f32 local space
    normals: torch.Tensor         # (V,3) f32
    uv0: torch.Tensor             # (V,2) f32
    tri_indices: torch.Tensor     # (M*128,3) i32 dense meshlet windows
    meshlet_sphere: torch.Tensor  # (M,4) f32
    meshlet_cone: torch.Tensor    # (M,4) f32 axis.xyz + cutoff
    meshlet_tri_count: torch.Tensor   # (M,) i32
    meshlet_error: torch.Tensor       # (M,) f32
    meshlet_parent_error: torch.Tensor  # (M,) f32
    meshlet_lod_sphere: torch.Tensor    # (M,4) f32
    meshlet_parent_sphere: torch.Tensor  # (M,4) f32
    meshlet_lod: torch.Tensor           # (M,) i32
    # corner-major per-meshlet geometry for the mesh-shader kernel:
    # rows [x0,y0,z0,pad, x1,y1,z1,pad, x2,y2,z2,pad] per 128-tri window,
    # plus one poison window at the end
    mv_posT: torch.Tensor         # (12, (M+1)*128) f32
    # rows [n0x,n0y,n0z,u0,v0, n1..., n2..., pad] per corner
    mv_attrT: torch.Tensor        # (16, (M+1)*128) f32
    pair_object: torch.Tensor     # (P,) i32
    pair_meshlet: torch.Tensor    # (P,) i32
    pair_valid: torch.Tensor      # (P,) bool
    # [sphere xyzr | cone xyzw | lod_sphere | parent_sphere | err, perr]
    pair_cull: torch.Tensor       # (P,18) f32
    mat_base_color: torch.Tensor  # (Mt,4) f32
    mat_metal_rough: torch.Tensor  # (Mt,2) f32
    mat_emissive: torch.Tensor    # (Mt,3) f32
    mat_base_tex: torch.Tensor    # (Mt,) i32 texture layer, -1 = none
    mat_normal_tex: torch.Tensor  # (Mt,) i32
    mat_normal_scale: torch.Tensor  # (Mt,) f32
    mat_mr_tex: torch.Tensor      # (Mt,) i32
    mat_emissive_tex: torch.Tensor  # (Mt,) i32
    mat_alpha_cutoff: torch.Tensor  # (Mt,) f32
    tex_pool: torch.Tensor        # (L, total_texels, 4) u8 flat-mip stack
    # paged pool (ops/paged_texture.py): apron-tiled pages + entry table
    tex_pages: torch.Tensor       # (n_pages*8 | n_pages*2, 128) i32
    tex_meta: torch.Tensor        # (2|3, E_pad) i32 [page base | avg | fmt]

    @property
    def tex_size(self) -> int:
        # total = sum_k (size/2^k)^2 = (4*size^2 - 1) / 3
        import math
        return int(math.isqrt((3 * self.tex_pool.shape[1] + 1) // 4))

    @property
    def num_meshlets(self) -> int:
        return self.meshlet_sphere.shape[0]

    @property
    def num_pairs(self) -> int:
        return self.pair_object.shape[0]


def _mesh_tables(builder: SceneBuilder, cache: Dict[int, dict],
                 nanite: bool) -> None:
    """Fill `cache` with one meshlet table per mesh (C++ Nanite DAG when
    `nanite`, else the Morton clusterizer)."""
    todo = [i for i in range(len(builder.meshes)) if i not in cache]
    if nanite:
        from ..native import nanite_build_batch
        tbls = nanite_build_batch(
            [(builder.meshes[i].positions, builder.meshes[i].indices)
             for i in todo], build_lods=True)
        cache.update(zip(todo, tbls))
        return
    for mesh_id in todo:
        mesh = builder.meshes[mesh_id]
        md, reordered = build_meshlets(mesh.positions, mesh.indices)
        cache[mesh_id] = {
            "indices": reordered,
            "tri_offset": md.tri_offset, "tri_count": md.tri_count,
            "sphere": md.sphere,
            "cone": np.concatenate([md.cone_axis, md.cone_cutoff[:, None]], 1),
            "lod_error": md.lod_error,
            "parent_error": md.parent_error,
            "lod_sphere": md.lod_sphere,
            "parent_sphere": md.lod_sphere,
            "lod_level": np.zeros(md.count, np.int32),
        }


def _texture_arrays(texture_pool, compress: Optional[bool]
                    ) -> Dict[str, np.ndarray]:
    """The raw and the paged texture pool (chord_tpu
    meshlet_scene.py:240-255, 293-296); no pool -> a 1x1 white
    placeholder."""
    if compress is None:
        from ..utils.cvar import cvars
        compress = bool(cvars.get("r.texture.compress"))
    if texture_pool is not None and texture_pool.textures:
        raw = texture_pool.u8()
        pages, meta, _ = pack_paged_pool(raw, texture_pool.mip_sizes,
                                         texture_pool.mip_offsets,
                                         compress=compress)
    else:
        pages, meta, _ = pack_paged_pool(_empty_tex_pool(), (1,), (0,),
                                         compress=compress)
        raw = (texture_pool.u8() if texture_pool is not None
               else _empty_tex_pool())
    return dict(tex_pool=raw, tex_pages=pages, tex_meta=meta)


def _pool_arrays(builder: SceneBuilder, meshlet_cache: Optional[Dict[int, dict]],
                 nanite: bool) -> Dict[str, np.ndarray]:
    """SceneBuilder -> dict of numpy pool arrays (MeshletScenePools field
    names, textures aside). Meshlets are built per MESH and shared across
    instances."""
    cache = meshlet_cache if meshlet_cache is not None else {}
    _mesh_tables(builder, cache, nanite)

    v_base = 0
    m_base = 0
    mesh_meshlets: List[Tuple[int, int]] = []
    pos_l, nrm_l, uv_l, tri_l = [], [], [], []
    tabs = {k: [] for k in ("sphere", "cone", "tri_count", "lod_error",
                            "parent_error", "lod_sphere", "parent_sphere",
                            "lod_level")}
    for mesh_id, mesh in enumerate(builder.meshes):
        tbl = cache[mesh_id]
        count = len(tbl["tri_offset"])
        reordered = tbl["indices"]
        mesh_meshlets.append((m_base, count))
        pos_l.append(mesh.positions)
        nrm_l.append(mesh.normals)
        uv_l.append(mesh.uv0)

        # dense per-meshlet 128-triangle windows, degenerate padding rows
        win = np.zeros((count, MESHLET_TRIS, 3), np.int64)
        for k in range(count):
            o, c = int(tbl["tri_offset"][k]), int(tbl["tri_count"][k])
            tris = reordered[o:o + c]
            win[k, :c] = tris
            if c < MESHLET_TRIS:
                win[k, c:] = tris[0, 0]
        tri_l.append((win + v_base).reshape(-1, 3).astype(np.int32))
        for k, lst in tabs.items():
            dt = np.int32 if k in ("tri_count", "lod_level") else np.float32
            lst.append(np.asarray(tbl[k], dt))
        v_base += mesh.num_vertices
        m_base += count

    pair_obj, pair_mesh = [], []
    for oid, (mesh_id, _mat, _m) in enumerate(builder.instances):
        mb, mc = mesh_meshlets[mesh_id]
        pair_obj.append(np.full(mc, oid, np.int32))
        pair_mesh.append(np.arange(mb, mb + mc, dtype=np.int32))
    pair_object = np.concatenate(pair_obj) if pair_obj else np.zeros(0, np.int32)
    pair_meshlet = np.concatenate(pair_mesh) if pair_mesh else np.zeros(0, np.int32)
    n_pairs = len(pair_object)
    pad = (-n_pairs) % 128
    if pad:
        pair_object = np.concatenate([pair_object, np.zeros(pad, np.int32)])
        pair_meshlet = np.concatenate([pair_meshlet, np.zeros(pad, np.int32)])
    pair_valid = np.zeros(len(pair_object), bool)
    pair_valid[:n_pairs] = True

    tri_all = np.concatenate(tri_l)
    pos_all = np.concatenate(pos_l)
    nrm_all = np.concatenate(nrm_l)
    uv_all = np.concatenate(uv_l)
    c0, c1, c2 = tri_all[:, 0], tri_all[:, 1], tri_all[:, 2]
    pad_col = np.zeros(len(tri_all), np.float32)
    mv_posT = np.stack([
        pos_all[c0, 0], pos_all[c0, 1], pos_all[c0, 2], pad_col,
        pos_all[c1, 0], pos_all[c1, 1], pos_all[c1, 2], pad_col,
        pos_all[c2, 0], pos_all[c2, 1], pos_all[c2, 2], pad_col], 0)
    mv_attrT = np.stack(
        [nrm_all[c0, 0], nrm_all[c0, 1], nrm_all[c0, 2],
         uv_all[c0, 0], uv_all[c0, 1],
         nrm_all[c1, 0], nrm_all[c1, 1], nrm_all[c1, 2],
         uv_all[c1, 0], uv_all[c1, 1],
         nrm_all[c2, 0], nrm_all[c2, 1], nrm_all[c2, 2],
         uv_all[c2, 0], uv_all[c2, 1], pad_col], 0)
    mv_posT = np.concatenate([mv_posT, np.zeros((12, 128), np.float32)], 1)
    mv_attrT = np.concatenate([mv_attrT, np.zeros((16, 128), np.float32)], 1)

    t = {k: np.concatenate(v) for k, v in tabs.items()}
    pair_cull = np.concatenate(
        [t["sphere"][pair_meshlet], t["cone"][pair_meshlet],
         t["lod_sphere"][pair_meshlet], t["parent_sphere"][pair_meshlet],
         t["lod_error"][pair_meshlet, None],
         t["parent_error"][pair_meshlet, None]], axis=1).astype(np.float32)

    mats = builder.materials
    col = lambda f, dt: np.array([f(m) for m in mats], dt)
    log.info("MeshletScenePools: %d meshes, %d meshlets, %d pairs, %d verts",
             len(builder.meshes), m_base, n_pairs, v_base)
    return dict(
        positions=pos_all, normals=nrm_all, uv0=uv_all,
        tri_indices=tri_all, mv_posT=mv_posT, mv_attrT=mv_attrT,
        meshlet_sphere=t["sphere"], meshlet_cone=t["cone"],
        meshlet_tri_count=t["tri_count"], meshlet_error=t["lod_error"],
        meshlet_parent_error=t["parent_error"],
        meshlet_lod_sphere=t["lod_sphere"],
        meshlet_parent_sphere=t["parent_sphere"], meshlet_lod=t["lod_level"],
        pair_object=pair_object, pair_meshlet=pair_meshlet,
        pair_valid=pair_valid, pair_cull=pair_cull,
        mat_base_color=col(lambda m: m.base_color, np.float32),
        mat_metal_rough=col(lambda m: [m.metallic, m.roughness], np.float32),
        mat_emissive=col(lambda m: m.emissive, np.float32),
        mat_base_tex=col(lambda m: m.base_color_texture, np.int32),
        mat_normal_tex=col(lambda m: m.normal_texture, np.int32),
        mat_normal_scale=col(lambda m: m.normal_scale, np.float32),
        mat_mr_tex=col(lambda m: m.metal_rough_texture, np.int32),
        mat_emissive_tex=col(lambda m: m.emissive_texture, np.int32),
        mat_alpha_cutoff=col(lambda m: m.alpha_cutoff, np.float32))


def build_meshlet_pools(builder: SceneBuilder,
                        meshlet_cache: Optional[Dict[int, dict]] = None,
                        nanite: bool = False,
                        texture_pool=None,
                        texture_compress: Optional[bool] = None,
                        device=None) -> MeshletScenePools:
    """SceneBuilder (meshes + instances) -> meshlet pools on `device`
    (None = the card).

    With nanite=True the shared C++ builder (native/nanite.cpp) produces
    the full cluster-LOD DAG — meshlets of every LOD level in one flat
    table; the runtime cut (ops/cull.py lod_cut_visible) picks one level
    per screen size (reference: asset/nanite_builder.cpp GMSS).
    `texture_pool` (an asset.texture.TexturePool, e.g. the SceneBuilder's
    `texture_pool`) is packed into pages, block-compressed unless
    `texture_compress` (default: the r.texture.compress cvar) says no."""
    device = resolve(device)
    arrays = _pool_arrays(builder, meshlet_cache, nanite)
    arrays.update(_texture_arrays(texture_pool, texture_compress))
    return MeshletScenePools(**{k: torch.from_numpy(v).to(device)
                                for k, v in arrays.items()})
