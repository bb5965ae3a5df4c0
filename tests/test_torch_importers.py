"""The port's importers and the two BASELINE scenes against chord_tpu.

Both packages parse the same files with their own host code (numpy, PIL
for the texture images), so everything must be equal exactly: every mesh
array, material field, instance matrix and texture layer of
assets/demo_street.glb (the repo's textured street: brick, asphalt,
plaster, alpha-masked leaf cards, a metallic-roughness map, an emissive
sign); the meshlet pools into_builder gives (with the paged texture pool
it imports into); the minimal PMX file of tests/test_importers.py; and
the pools of build_nanite_stress (BASELINE #3) and build_bistro_interior
(BASELINE #4), through the shared native Nanite builder.
"""

import dataclasses
import struct
from pathlib import Path

import numpy as np
import pytest

import chord_tpu.asset.gltf as jgltf
import chord_tpu.asset.pmx as jpmx
import chord_tpu.asset.procedural as jproc
import chord_tpu.rhi.scene_arrays as jsa
from chord_tpu.asset.texture import TexturePool as JTexturePool
from chord_tpu.rhi.meshlet_scene import build_meshlet_pools as jax_pools

import chord_tpu_torch.asset.gltf as gltf
import chord_tpu_torch.asset.pmx as pmx
import chord_tpu_torch.asset.procedural as proc
import chord_tpu_torch.rhi.scene_arrays as sa
from chord_tpu_torch.asset.texture import TexturePool
from chord_tpu_torch.native import available as native_available
from chord_tpu_torch.rhi.meshlet_scene import (MeshletScenePools,
                                               build_meshlet_pools)

GLB = Path(__file__).resolve().parent.parent / "assets" / "demo_street.glb"
MESH_FIELDS = ("positions", "indices", "normals", "uv0", "tangents", "uv1",
               "color0")


def _assert_meshes_equal(got, ref):
    assert len(got) == len(ref)
    for m, jm in zip(got, ref):
        assert m.name == jm.name
        for f in MESH_FIELDS:
            a, b = getattr(m, f), getattr(jm, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert a.dtype == b.dtype, f
                np.testing.assert_array_equal(a, b, err_msg=f)


def _assert_materials_equal(got, ref):
    assert [dataclasses.asdict(m) for m in got] == \
        [dataclasses.asdict(m) for m in ref]


def _assert_pools_equal(pools, ref_pools):
    for f in dataclasses.fields(MeshletScenePools):
        a, b = getattr(pools, f.name), getattr(ref_pools, f.name)
        assert (a is None) == (b is None), f.name
        if a is None:
            continue
        if not hasattr(a, "numpy"):
            assert a == b, f.name
            continue
        b = np.asarray(b)
        a = a.numpy()
        if b.dtype == np.uint32:
            b = b.view(np.int32)
        assert a.shape == b.shape, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.fixture(scope="module")
def glb():
    tp, jtp = TexturePool(512), JTexturePool(512)
    return (gltf.load_gltf(GLB, texture_pool=tp), tp,
            jgltf.load_gltf(GLB, texture_pool=jtp), jtp)


def test_glb_meshes_materials_instances_match(glb):
    scene, _, ref, _ = glb
    _assert_meshes_equal(scene.meshes, ref.meshes)
    _assert_materials_equal(scene.materials, ref.materials)
    assert scene.mesh_material == ref.mesh_material
    assert len(scene.instances) == len(ref.instances) == 15
    for (m, l2w), (jm, jl2w) in zip(scene.instances, ref.instances):
        assert m == jm
        np.testing.assert_array_equal(l2w, jl2w)
    assert scene.total_triangles == ref.total_triangles
    # the street has masked foliage and textured materials
    assert any(m.alpha_mode == "mask" for m in scene.materials)
    assert sum(m.base_color_texture >= 0 for m in scene.materials) == 4


def test_glb_texture_layers_and_mips_match(glb):
    _, tp, _, jtp = glb
    assert len(tp.textures) == len(jtp.textures) == 5
    assert tp.mip_sizes == jtp.mip_sizes
    assert tp.mip_offsets == jtp.mip_offsets
    assert {k: (d.layer, d.src_size) for k, d in tp.descs.items()} == \
        {k: (d.layer, d.src_size) for k, d in jtp.descs.items()}
    for a, b in zip(tp.textures, jtp.textures):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("nanite", [False, True])
def test_glb_into_builder_pools_match(glb, nanite):
    """into_builder -> build_meshlet_pools with the imported texture pool
    (packed into compressed pages) equal chord_tpu's."""
    if nanite:
        assert native_available(), "the shared native library must load"
    scene, tp, ref, jtp = glb
    b = gltf.into_builder(scene, sa.SceneBuilder())
    jb = jgltf.into_builder(ref, jsa.SceneBuilder())
    assert [(m, t) for m, t, _ in b.instances] == \
        [(m, t) for m, t, _ in jb.instances]
    _assert_pools_equal(
        build_meshlet_pools(b, nanite=nanite, texture_pool=tp, device="cpu"),
        jax_pools(jb, nanite=nanite, texture_pool=jtp))


def _write_minimal_pmx(path):
    """A tiny PMX 2.0: 3 verts, 1 triangle, 1 material (the writer of
    tests/test_importers.py:27-67)."""
    out = bytearray()
    out += b"PMX "
    out += struct.pack("<f", 2.0)
    out += struct.pack("<B", 8)
    # globals: enc=1(utf8), addUV=0, vtx=1, tex=1, mat=1, bone=1, morph=1, rb=1
    out += bytes([1, 0, 1, 1, 1, 1, 1, 1])
    for s in (b"tri", b"tri", b"", b""):     # names/comments
        out += struct.pack("<i", len(s)) + s
    out += struct.pack("<i", 3)              # vertex count
    for p, n, uv in [((0, 0, 0), (0, 0, -1), (0, 0)),
                     ((1, 0, 0), (0, 0, -1), (1, 0)),
                     ((0, 1, 0), (0, 0, -1), (0, 1))]:
        out += struct.pack("<3f", *p) + struct.pack("<3f", *n)
        out += struct.pack("<2f", *uv)
        out += struct.pack("<B", 0)          # BDEF1
        out += struct.pack("<b", 0)          # bone index
        out += struct.pack("<f", 1.0)        # edge scale
    out += struct.pack("<i", 3)              # index count
    out += struct.pack("<BBB", 0, 1, 2)      # u8 vertex indices
    out += struct.pack("<i", 0)              # no textures
    out += struct.pack("<i", 1)              # one material
    for s in (b"mat", b""):
        out += struct.pack("<i", len(s)) + s
    out += struct.pack("<4f", 0.8, 0.2, 0.2, 1.0)    # diffuse
    out += struct.pack("<3f", 1, 1, 1) + struct.pack("<f", 32.0)
    out += struct.pack("<3f", 0.1, 0.1, 0.1)
    out += struct.pack("<B", 0)
    out += struct.pack("<4f", 0, 0, 0, 1) + struct.pack("<f", 1.0)
    out += struct.pack("<b", -1)             # texture
    out += struct.pack("<b", -1)             # sphere
    out += struct.pack("<B", 0)              # sphere mode
    out += struct.pack("<B", 0)              # shared toon = 0
    out += struct.pack("<b", -1)             # toon texture
    out += struct.pack("<i", 0)              # memo
    out += struct.pack("<i", 3)              # face index count
    path.write_bytes(bytes(out))


def test_pmx_minimal_matches(tmp_path):
    p = tmp_path / "tri.pmx"
    _write_minimal_pmx(p)
    model, ref = pmx.load_pmx(p), jpmx.load_pmx(p)
    assert model.name == ref.name == "tri"
    assert model.texture_paths == ref.texture_paths
    _assert_meshes_equal(model.meshes, ref.meshes)
    _assert_materials_equal(model.materials, ref.materials)
    assert model.meshes[0].indices.tolist() == [[2, 1, 0]]
    b = pmx.into_builder(model, sa.SceneBuilder())
    jb = jpmx.into_builder(ref, jsa.SceneBuilder())
    _assert_pools_equal(build_meshlet_pools(b, device="cpu"), jax_pools(jb))


@pytest.mark.parametrize("scene", ["nanite", "interior"])
def test_baseline_scene_pools_match(scene):
    """BASELINE #3 and #4 at a small size: the builders draw the same
    rng values, and the Nanite DAG of every mesh is the shared native
    builder's."""
    assert native_available(), "the shared native library must load"
    if scene == "nanite":
        b = proc.build_nanite_stress(spheres=9, rings=16)
        jb = jproc.build_nanite_stress(spheres=9, rings=16)
    else:
        b = proc.build_bistro_interior(detail=1)
        jb = jproc.build_bistro_interior(detail=1)
    _assert_meshes_equal(b.meshes, jb.meshes)
    _assert_materials_equal(b.materials, jb.materials)
    for (m, t, l2w), (jm, jt, jl2w) in zip(b.instances, jb.instances):
        assert (m, t) == (jm, jt)
        np.testing.assert_array_equal(l2w, jl2w)
    _assert_pools_equal(build_meshlet_pools(b, nanite=True, device="cpu"),
                        jax_pools(jb, nanite=True))
