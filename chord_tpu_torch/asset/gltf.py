"""glTF 2.0 / GLB importer (port of chord_tpu/asset/gltf.py).

The port of the reference's tinygltf-based importer
(reference: source/asset/gltf/asset_gltf_helper.cpp:48-290 — parse, per-
primitive vertex soup extraction, node-hierarchy flattening). Output is the
same logical product: per-primitive {positions, normals, uv0, indices} +
material table + flattened instance transforms, feeding the SceneBuilder
(the GLTFBinary::PrimitiveDatas analog, asset/gltf/asset_gltf.h:260-287).

Pure-Python/NumPy parser (glTF JSON + binary buffers): no external gltf
dependency, which also means no non-baked pip packages. Handles .gltf
(+ external .bin / data URIs) and .glb containers.
"""

from __future__ import annotations

import base64
import json
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..rhi.scene_arrays import MaterialData, MeshData
from ..utils import math as cmath
from ..utils.log import get_logger

log = get_logger("asset.gltf")

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
                "MAT2": 4, "MAT3": 9, "MAT4": 16}


@dataclass
class GLTFScene:
    """Importer output: meshes + materials + flattened world instances."""

    meshes: List[MeshData] = field(default_factory=list)
    materials: List[MaterialData] = field(default_factory=list)
    mesh_material: List[int] = field(default_factory=list)   # per mesh entry
    # (mesh_index, local_to_world f64 4x4) flattened over the node tree
    instances: List[Tuple[int, np.ndarray]] = field(default_factory=list)

    @property
    def total_triangles(self) -> int:
        return sum(self.meshes[m].num_triangles for m, _ in self.instances)


def _load_buffers(doc: dict, base_dir: Path, glb_bin: Optional[bytes]
                  ) -> List[bytes]:
    out = []
    for buf in doc.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            out.append(glb_bin or b"")
        elif uri.startswith("data:"):
            out.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            out.append((base_dir / uri).read_bytes())
    return out


def _read_accessor(doc: dict, buffers: List[bytes], idx: int) -> np.ndarray:
    acc = doc["accessors"][idx]
    n_comp = _TYPE_COUNTS[acc["type"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    count = acc["count"]
    if "bufferView" not in acc:
        arr = np.zeros((count, n_comp), dtype)
    else:
        bv = doc["bufferViews"][acc["bufferView"]]
        data = buffers[bv["buffer"]]
        start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = bv.get("byteStride") or (np.dtype(dtype).itemsize * n_comp)
        item = np.dtype(dtype).itemsize * n_comp
        if stride == item:
            arr = np.frombuffer(data, dtype, count * n_comp, start)
            arr = arr.reshape(count, n_comp)
        else:  # interleaved
            raw = np.frombuffer(data, np.uint8)
            rows = np.stack([
                raw[start + i * stride: start + i * stride + item]
                for i in range(count)])
            arr = rows.view(dtype).reshape(count, n_comp)
    if acc.get("normalized") and dtype != np.float32:
        info = np.iinfo(dtype)
        arr = arr.astype(np.float32) / info.max
    return arr


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        # glTF stores column-major for column vectors; our row-vector
        # convention uses its transpose-free reinterpretation: reading the
        # 16 floats column-major into a (4,4) C-order array directly yields
        # the row-vector matrix (p_row @ M).
        return np.array(node["matrix"], np.float64).reshape(4, 4)
    return cmath.compose_trs(
        node.get("translation", (0.0, 0.0, 0.0)),
        np.asarray(node.get("rotation", (0.0, 0.0, 0.0, 1.0)), np.float64),
        node.get("scale", (1.0, 1.0, 1.0)))


def _image_fobj(doc: dict, buffers: List[bytes], base_dir: Path,
                image_idx: int):
    """glTF image -> file-like object for PIL (uri file / data URI /
    GLB bufferView)."""
    import io

    img = doc["images"][image_idx]
    uri = img.get("uri")
    if uri is not None:
        if uri.startswith("data:"):
            return io.BytesIO(base64.b64decode(uri.split(",", 1)[1]))
        return io.BytesIO((base_dir / uri).read_bytes())
    bv = doc["bufferViews"][img["bufferView"]]
    start = bv.get("byteOffset", 0)
    return io.BytesIO(buffers[bv["buffer"]][start:start + bv["byteLength"]])


def load_gltf(path: str | Path, texture_pool=None) -> GLTFScene:
    """Load a .gltf/.glb file into a GLTFScene.

    With `texture_pool` (asset.texture.TexturePool), material baseColor and
    normal textures are imported into the pool (reference imports textures
    alongside the mesh, asset_gltf_helper.cpp — baseColor as sRGB, normal
    maps linear) and materials carry the resulting layer ids."""
    path = Path(path)
    raw = path.read_bytes()
    glb_bin = None
    if raw[:4] == b"glTF":                     # GLB container
        _, _version, _length = struct.unpack_from("<III", raw, 0)
        off = 12
        doc = None
        while off < len(raw):
            clen, ctype = struct.unpack_from("<II", raw, off)
            chunk = raw[off + 8: off + 8 + clen]
            if ctype == 0x4E4F534A:            # 'JSON'
                doc = json.loads(chunk)
            elif ctype == 0x004E4942:          # 'BIN'
                glb_bin = chunk
            off += 8 + clen + (-clen % 4 if ctype == 0x4E4F534A else 0)
        assert doc is not None, "GLB missing JSON chunk"
    else:
        doc = json.loads(raw)

    buffers = _load_buffers(doc, path.parent, glb_bin)
    scene = GLTFScene()

    def tex_layer(tex_info: Optional[dict], srgb: bool) -> int:
        """textureInfo -> pool layer id (-1 when absent / no pool)."""
        if texture_pool is None or not tex_info:
            return -1
        src = doc["textures"][tex_info["index"]].get("source", -1)
        if src < 0:
            return -1
        key = f"{path.name}:img{src}:{'srgb' if srgb else 'lin'}"
        if key in texture_pool.descs:
            return texture_pool.descs[key].layer
        from .texture import load_image
        try:
            img = load_image(_image_fobj(doc, buffers, path.parent, src),
                             srgb=srgb)
        except Exception as e:             # missing file / bad codec
            log.warning("texture image %d failed to load: %s", src, e)
            return -1
        return texture_pool.add(key, img)

    for mat in doc.get("materials", []):
        pbr = mat.get("pbrMetallicRoughness", {})
        nrm_info = mat.get("normalTexture")
        scene.materials.append(MaterialData(
            base_color=tuple(pbr.get("baseColorFactor", (1, 1, 1, 1))),
            metallic=pbr.get("metallicFactor", 1.0),
            roughness=pbr.get("roughnessFactor", 1.0),
            emissive=tuple(mat.get("emissiveFactor", (0, 0, 0))),
            base_color_texture=tex_layer(pbr.get("baseColorTexture"), True),
            normal_texture=tex_layer(nrm_info, False),
            normal_scale=(nrm_info or {}).get("scale", 1.0),
            metal_rough_texture=tex_layer(
                pbr.get("metallicRoughnessTexture"), False),
            emissive_texture=tex_layer(mat.get("emissiveTexture"), True),
            two_sided=mat.get("doubleSided", False),
            alpha_mode={"OPAQUE": "opaque", "MASK": "mask",
                        "BLEND": "blend"}.get(
                            mat.get("alphaMode", "OPAQUE"), "opaque"),
            alpha_cutoff=mat.get("alphaCutoff", 0.5),
            name=mat.get("name", ""),
        ))
    if not scene.materials:
        scene.materials.append(MaterialData(name="default"))

    # Per-primitive meshes (one MeshData per glTF primitive, like the
    # reference's per-primitive GLTFPrimitiveDatas).
    mesh_prims: List[List[int]] = []
    for mesh in doc.get("meshes", []):
        prim_ids = []
        for prim in mesh.get("primitives", []):
            if prim.get("mode", 4) != 4:       # TRIANGLES only
                continue
            attrs = prim["attributes"]
            pos = _read_accessor(doc, buffers, attrs["POSITION"]).astype(
                np.float32)
            nrm = None
            if "NORMAL" in attrs:
                nrm = _read_accessor(doc, buffers, attrs["NORMAL"]).astype(
                    np.float32)
            uv = None
            if "TEXCOORD_0" in attrs:
                uv = _read_accessor(doc, buffers, attrs["TEXCOORD_0"]).astype(
                    np.float32)
            # stream parity with the reference importer
            # (asset/gltf/asset_gltf.h:260-287): TANGENT / TEXCOORD_1 /
            # COLOR_0 were previously dropped silently on import
            tan = None
            if "TANGENT" in attrs:
                tan = _read_accessor(doc, buffers,
                                     attrs["TANGENT"]).astype(np.float32)
            uv1 = None
            if "TEXCOORD_1" in attrs:
                uv1 = _read_accessor(doc, buffers,
                                     attrs["TEXCOORD_1"]).astype(np.float32)
            col0 = None
            if "COLOR_0" in attrs:
                col0 = _read_accessor(doc, buffers, attrs["COLOR_0"])
                # u8/u16 colors are normalized per spec; VEC3 pads alpha
                if col0.dtype == np.uint8:
                    col0 = col0.astype(np.float32) / 255.0
                elif col0.dtype == np.uint16:
                    col0 = col0.astype(np.float32) / 65535.0
                else:
                    col0 = col0.astype(np.float32)
                if col0.shape[-1] == 3:
                    col0 = np.concatenate(
                        [col0, np.ones((len(col0), 1), np.float32)], -1)
            if "indices" in prim:
                idx = _read_accessor(doc, buffers, prim["indices"])
                idx = idx.astype(np.int64).reshape(-1, 3).astype(np.int32)
            else:
                idx = np.arange(len(pos), dtype=np.int32).reshape(-1, 3)
            scene.meshes.append(MeshData(
                positions=pos, indices=idx, normals=nrm, uv0=uv,
                tangents=tan, uv1=uv1, color0=col0,
                name=mesh.get("name", f"mesh{len(scene.meshes)}")))
            scene.mesh_material.append(prim.get("material", 0))
            prim_ids.append(len(scene.meshes) - 1)
        mesh_prims.append(prim_ids)

    # Flatten node hierarchy.
    nodes = doc.get("nodes", [])

    def visit(node_id: int, parent: np.ndarray) -> None:
        node = nodes[node_id]
        world = _node_matrix(node) @ parent
        if "mesh" in node:
            for mid in mesh_prims[node["mesh"]]:
                scene.instances.append((mid, world))
        for child in node.get("children", []):
            visit(child, world)

    scene_id = doc.get("scene", 0)
    roots = doc.get("scenes", [{}])[scene_id].get("nodes", [])
    for r in roots:
        visit(r, np.eye(4))
    if not roots and mesh_prims:               # mesh-only files
        for prim_ids in mesh_prims:
            for mid in prim_ids:
                scene.instances.append((mid, np.eye(4)))

    log.info("loaded %s: %d prims, %d materials, %d instances, %d tris",
             path.name, len(scene.meshes), len(scene.materials),
             len(scene.instances), scene.total_triangles)
    return scene


def into_builder(scene: GLTFScene, builder, transform: Optional[np.ndarray] = None):
    """Register a GLTFScene into a rhi.SceneBuilder."""
    mat_remap = [builder.add_material(m) for m in scene.materials]
    mesh_remap = [builder.add_mesh(m) for m in scene.meshes]
    for mesh_id, l2w in scene.instances:
        m = l2w if transform is None else l2w @ transform
        builder.add_instance(mesh_remap[mesh_id],
                             mat_remap[scene.mesh_material[mesh_id]], m)
    return builder
