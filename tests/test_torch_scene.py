"""The port's host scene path against chord_tpu's, array for array.

Both packages build the same procedural scenes from the same seeds; the
port's pools, instance table and device view must equal chord_tpu's
exactly (same numpy arithmetic, same native Nanite builder). Also: the
port imports neither jax nor chex.
"""

import dataclasses
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from chord_tpu.asset.procedural import build_bistro_like as jax_bistro
from chord_tpu.asset.procedural import build_sponza_like as jax_sponza
from chord_tpu.renderer.deferred import DeviceView as JView
from chord_tpu.rhi.meshlet_scene import build_meshlet_pools as jax_pools
from chord_tpu.utils.camera import Camera as JCamera

from chord_tpu_torch import interop
from chord_tpu_torch.asset.procedural import build_bistro_like, \
    build_sponza_like
from chord_tpu_torch.native import available as native_available
from chord_tpu_torch.renderer import DeviceView
from chord_tpu_torch.rhi.meshlet_scene import (MeshletScenePools,
                                               build_meshlet_pools)
from chord_tpu_torch.utils.camera import Camera


def _np(obj):
    return {k: np.asarray(v) for k, v in vars(obj).items() if v is not None}


def _assert_same(port, ref: dict, names):
    for name in names:
        a = getattr(port, name).numpy()
        b = ref[name]
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _pool_fields():
    return [f.name for f in dataclasses.fields(MeshletScenePools)]


def test_sponza_pools_match():
    ref = _np(jax_pools(jax_sponza(detail=1)))
    _assert_same(build_meshlet_pools(build_sponza_like(detail=1),
                                     device="cpu"), ref,
                 _pool_fields())


@pytest.mark.parametrize("nanite", [False, True])
def test_small_bistro_pools_match(nanite):
    if nanite:
        assert native_available(), "the shared native library must load"
    ref = _np(jax_pools(jax_bistro(detail=1), nanite=nanite))
    _assert_same(build_meshlet_pools(build_bistro_like(detail=1),
                                     nanite=nanite, device="cpu"), ref,
                 _pool_fields())


def test_bistro_textures_raise():
    """The textured bistro (bench texture pool, masked leaves) builds
    the same meshlet pools as chord_tpu's, the paged texture pool
    (compressed, the r.texture.compress default) included."""
    jb = jax_bistro(detail=1, textures=True)
    ref = _np(jax_pools(jb, texture_pool=jb.texture_pool))
    b = build_bistro_like(detail=1, textures=True)
    pools = build_meshlet_pools(b, texture_pool=b.texture_pool, device="cpu")
    _assert_same(pools, ref, _pool_fields())
    assert pools.tex_size == 256 and tuple(pools.tex_meta.shape) == (3, 128)
    assert pools.tex_pages.shape[0] == 2 * 12 * 124
    _assert_same(interop.pools_from_numpy(ref, device="cpu"), ref,
                 ["tex_pool", "tex_pages", "tex_meta"])


def _cams():
    out = []
    for cls in (JCamera, Camera):
        cam = cls(width=128, height=64)
        cam.position = np.array([-15.0, 4.0, 2.0])
        cam.look_at(np.array([10.0, 2.0, -1.0]))
        out.append(cam)
    return out


def test_frame_instances_match():
    jcam, cam = _cams()
    ref = _np(jax_bistro(detail=1).frame_instances(jcam))
    inst = build_bistro_like(detail=1).frame_instances(cam, device="cpu")
    _assert_same(inst, ref, [f.name for f in dataclasses.fields(inst)])


@pytest.mark.parametrize("jitter", [False, True])
def test_device_view_matches(jitter):
    jcam, cam = _cams()
    ref = _np(JView.from_uniform(jcam.view_uniform(3, jitter=jitter)))
    view = DeviceView.from_uniform(cam.view_uniform(3, jitter=jitter),
                                  device="cpu")
    # the fields a view without shadows or atmosphere carries
    names = [f.name for f in dataclasses.fields(view)
             if getattr(view, f.name) is not None]
    assert set(names) == set(ref)
    _assert_same(view, ref, names)
    # interop carries chord_tpu's view across unchanged
    _assert_same(interop.view_from_numpy(ref, device="cpu"), ref, names)


def test_port_imports_no_jax():
    """Every module of the port imports with jax, chex and chord_tpu
    unavailable, the host layers (scene/, asset/, utils/names), the apps
    and the strip-parallel frame among them."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["chex"] = None
        sys.modules["chord_tpu"] = None
        import chord_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            chord_tpu_torch.__path__, "chord_tpu_torch.")]
        for n in names:
            importlib.import_module(n)
        assert not any(k == "jax" or k.startswith(("jax.", "chord_tpu."))
                       for k, v in sys.modules.items() if v is not None)
        for n in ("scene.scene", "scene.components", "scene.subsystem",
                  "asset.gltf", "asset.pmx", "asset.serialize",
                  "asset.manager", "utils.events", "utils.timer",
                  "apps.viewer", "apps.editor", "utils.names",
                  "utils.collectives", "parallel.sharded"):
            assert "chord_tpu_torch." + n in names, n
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_visibility_packing_matches():
    import jax.numpy as jnp
    import torch
    from chord_tpu.rhi import framebuffer as jfb
    from chord_tpu_torch.rhi import framebuffer as fb

    rng = np.random.default_rng(2)
    inst = rng.integers(-1, 1 << 24, 4096).astype(np.int32)
    tri = rng.integers(0, 128, 4096).astype(np.int32)
    ref = np.asarray(jfb.pack_visibility(jnp.asarray(inst), jnp.asarray(tri)))
    got = fb.pack_visibility(torch.from_numpy(inst), torch.from_numpy(tri))
    np.testing.assert_array_equal(fb.vis_to_uint32(got), ref)
    for a, b in zip(fb.unpack_visibility(got),
                    jfb.unpack_visibility(jnp.asarray(ref))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_empty_history_matches():
    from chord_tpu.rhi.framebuffer import FrameHistory as JHistory
    from chord_tpu_torch.rhi.framebuffer import FrameHistory

    jh = JHistory.empty(64, 128, post_h=96, post_w=192)
    got = FrameHistory.empty(64, 128, 96, 192, device="cpu")
    # the array fields; the `ddgi` leaf (a DDGIState) by its own fields
    names = [f.name for f in dataclasses.fields(got) if f.name != "ddgi"]
    ref = {n: np.asarray(getattr(jh, n)) for n in names}
    _assert_same(got, ref, names)
    carried = interop.history_from_numpy(dict(ref, ddgi=jh.ddgi),
                                         device="cpu")
    _assert_same(carried, ref, names)
    ddgi_ref = {k: np.asarray(v) for k, v in jh.ddgi._asdict().items()}
    for h in (got, carried):
        _assert_same(h.ddgi, ddgi_ref, list(ddgi_ref))


def test_entry_points_default_to_the_card():
    """Without device=..., the entry points put their tensors on the
    card; with no CUDA device that raises instead of running on the CPU."""
    import torch
    from chord_tpu_torch.asset.texture import TexturePool
    from chord_tpu_torch.rhi.framebuffer import FrameHistory

    if torch.cuda.is_available():
        assert FrameHistory.empty(8, 8).depth.is_cuda
        return
    b = build_sponza_like(detail=1)
    _, cam = _cams()
    for call in (lambda: FrameHistory.empty(8, 8),
                 lambda: build_meshlet_pools(b),
                 lambda: b.frame_instances(cam),
                 lambda: DeviceView.from_uniform(cam.view_uniform(0)),
                 lambda: interop.history_from_numpy(
                     {f.name: np.zeros(2, np.float32) for f in
                      dataclasses.fields(FrameHistory)}),
                 lambda: TexturePool(8).device_array()):
        with pytest.raises((RuntimeError, AssertionError)):
            call()
