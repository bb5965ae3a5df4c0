"""PMX (MikuMikuDance) model importer — geometry + materials (port of
chord_tpu/asset/pmx.py).

The port of the reference's PMX importer (reference:
source/asset/pmx/ — geometry-only path into the same mesh pipeline,
SURVEY §2.4 "PMX importer ... geometry only path"). Parses PMX 2.0/2.1:
vertices (position/normal/uv), faces, and the material table (diffuse
color + per-material face ranges -> one MeshData per material span, like
the reference's per-primitive split). Bones/morphs/physics are skipped —
the reference imports geometry only too.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..rhi.scene_arrays import MaterialData, MeshData
from ..utils.log import get_logger

log = get_logger("asset.pmx")


class _Reader:
    def __init__(self, data: bytes):
        self.d = data
        self.o = 0

    def u8(self):
        v = self.d[self.o]
        self.o += 1
        return v

    def i32(self):
        (v,) = struct.unpack_from("<i", self.d, self.o)
        self.o += 4
        return v

    def f32(self):
        (v,) = struct.unpack_from("<f", self.d, self.o)
        self.o += 4
        return v

    def fvec(self, n):
        v = struct.unpack_from(f"<{n}f", self.d, self.o)
        self.o += 4 * n
        return v

    def idx(self, size, signed=True):
        fmt = {1: "b", 2: "h", 4: "i"}[size] if signed else \
            {1: "B", 2: "H", 4: "i"}[size]
        (v,) = struct.unpack_from("<" + fmt, self.d, self.o)
        self.o += size
        return v

    def text(self, enc):
        n = self.i32()
        raw = self.d[self.o:self.o + n]
        self.o += n
        return raw.decode("utf-16-le" if enc == 0 else "utf-8",
                          errors="replace")

    def skip(self, n):
        self.o += n


@dataclass
class PMXModel:
    name: str
    meshes: List[MeshData] = field(default_factory=list)
    materials: List[MaterialData] = field(default_factory=list)
    texture_paths: List[str] = field(default_factory=list)


def load_pmx(path) -> PMXModel:
    """Parse a .pmx file -> per-material MeshData + MaterialData lists."""
    path = Path(path)
    r = _Reader(path.read_bytes())
    magic = r.d[:4]
    assert magic in (b"PMX ", b"PMX\x20"), f"not a PMX file: {magic!r}"
    r.skip(4)
    version = r.f32()
    n_globals = r.u8()
    g = [r.u8() for _ in range(n_globals)]
    enc, add_uv = g[0], g[1]
    vtx_isz, tex_isz, mat_isz, bone_isz, morph_isz, rb_isz = g[2:8]

    name_l = r.text(enc)
    _name_e = r.text(enc)
    _comment_l = r.text(enc)
    _comment_e = r.text(enc)

    nv = r.i32()
    pos = np.zeros((nv, 3), np.float32)
    nrm = np.zeros((nv, 3), np.float32)
    uv = np.zeros((nv, 2), np.float32)
    for i in range(nv):
        pos[i] = r.fvec(3)
        nrm[i] = r.fvec(3)
        uv[i] = r.fvec(2)
        r.skip(16 * add_uv)
        wt = r.u8()
        if wt == 0:      # BDEF1
            r.skip(bone_isz)
        elif wt == 1:    # BDEF2
            r.skip(bone_isz * 2 + 4)
        elif wt == 2:    # BDEF4
            r.skip(bone_isz * 4 + 16)
        elif wt == 3:    # SDEF
            r.skip(bone_isz * 2 + 4 + 36)
        elif wt == 4:    # QDEF (2.1)
            r.skip(bone_isz * 4 + 16)
        else:
            raise ValueError(f"bad weight type {wt} at vertex {i}")
        r.skip(4)        # edge scale

    n_idx = r.i32()
    indices = np.zeros(n_idx, np.int32)
    for i in range(n_idx):
        indices[i] = r.idx(vtx_isz, signed=False)
    indices = indices.reshape(-1, 3)
    # PMX winding is clockwise in a left-handed system; flip to our CCW
    indices = indices[:, ::-1].copy()
    # left-handed (+Z forward) -> our right-handed: negate z
    pos[:, 2] *= -1.0
    nrm[:, 2] *= -1.0

    n_tex = r.i32()
    tex_paths = [r.text(enc) for _ in range(n_tex)]

    n_mat = r.i32()
    model = PMXModel(name=name_l or path.stem, texture_paths=tex_paths)
    face_base = 0
    for _ in range(n_mat):
        mname = r.text(enc)
        _mname_e = r.text(enc)
        diffuse = r.fvec(4)
        _spec = r.fvec(3)
        spec_pow = r.f32()
        _ambient = r.fvec(3)
        _flags = r.u8()
        _edge_color = r.fvec(4)
        _edge_size = r.f32()
        tex_i = r.idx(tex_isz)
        _sphere_i = r.idx(tex_isz)
        _sphere_mode = r.u8()
        shared_toon = r.u8()
        if shared_toon:
            r.skip(1)
        else:
            r.skip(tex_isz)
        _memo = r.text(enc)
        n_faces_idx = r.i32()            # index count (3x faces)
        n_faces = n_faces_idx // 3

        span = indices[face_base:face_base + n_faces]
        face_base += n_faces
        used = np.unique(span)
        remap = np.zeros(nv, np.int32)
        remap[used] = np.arange(len(used), dtype=np.int32)
        model.meshes.append(MeshData(
            positions=pos[used], indices=remap[span],
            normals=nrm[used], uv0=uv[used], name=mname))
        rough = float(np.clip(1.0 - np.log2(max(spec_pow, 1.0)) / 10.0,
                              0.05, 1.0))
        model.materials.append(MaterialData(
            base_color=tuple(diffuse), roughness=rough, metallic=0.0,
            base_color_texture=-1, name=mname))

    log.info("PMX '%s': %d verts, %d tris, %d materials (v%.1f)",
             model.name, nv, len(indices), n_mat, version)
    return model


def into_builder(model: PMXModel, builder, transform=None):
    """Register a PMXModel into a rhi.SceneBuilder (one instance per
    material span)."""
    m = np.eye(4) if transform is None else transform
    for mesh, mat in zip(model.meshes, model.materials):
        mid = builder.add_mesh(mesh)
        matid = builder.add_material(mat)
        builder.add_instance(mid, matid, m)
    return builder
