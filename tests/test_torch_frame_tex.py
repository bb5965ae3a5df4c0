"""The ported `geo_tex` frame against chord_tpu, end to end.

The bench's `geo_tex` rung (bench.py:45-47, 204-219): textures with
normal and metal-rough maps, the alpha-masked bucket (one layer) and the
blend bucket (untextured glass, so blend_textured=False), with the `off`
rung's post chain. Three frames of render_sequence_meshlet(with_stats=True)
at render 128x64 -> post 192x96 along a jittered moving camera.

The scene is a small hand-built one with every material kind of the
bench's bistro: textured opaque surfaces (base, normal, metal-rough and
emissive maps), an untextured opaque sphere, alpha-masked leaf cards and a
translucent pane. Its texture pool is 16² (every mip one page), so
chord_tpu's per-block page palette covers every pixel at a palette size
its interpret-mode compile can afford; the bistro's 256² pool needs ~100
pages per block. Each package builds the scene with its own host code from
the same seed.

chord_tpu's `paged_sample` is wrapped here to report its palette coverage,
which is complete: so the masked alpha test's palette of 5 pages (the
frame's is 10; the port samples with 10) serves the same texels, and both
packages compute the same function. Where the palette misses, K5 is held
to chord_tpu by test_torch_paged_texture.py and the bench-size frames by
chip_smoke.py's phase 13 (tests/goldens/bench/). Nothing in chord_tpu
changes.

Tolerances: stats are integers and must match exactly. Images are u8
after the ACES tonemap; f32 rounding differences (XLA's FMA contraction in
the raster's attribute planes, log2 ulps in the mip pick) move a few
pixels — a mip or an alpha-test flip can move one pixel a lot — so
>= 99.9% of channel values must lie within 2 levels. History depth as in
test_torch_frame.py.
"""

import jax
import numpy as np
import pytest

import chord_tpu.asset.procedural as jproc
import chord_tpu.asset.texture as jtex
import chord_tpu.ops.paged_texture as jpt
import chord_tpu.rhi.scene_arrays as jsa
import chord_tpu.utils.math as jmath
from chord_tpu.renderer.deferred import DeviceView as JView
from chord_tpu.renderer.deferred import RendererConfig as JConfig
from chord_tpu.renderer.meshlet_frame import MeshletFrameConfig as JMcfg
from chord_tpu.renderer.meshlet_frame import \
    render_sequence_meshlet as jax_sequence
from chord_tpu.rhi.framebuffer import FrameHistory as JHistory
from chord_tpu.rhi.meshlet_scene import build_meshlet_pools as jax_pools
from chord_tpu.utils.camera import Camera as JCamera

import chord_tpu_torch.asset.procedural as proc
import chord_tpu_torch.asset.texture as tex
import chord_tpu_torch.rhi.scene_arrays as sa
from chord_tpu_torch.renderer import (DeviceView, MeshletFrameConfig,
                                      MeshletRenderer, RendererConfig,
                                      render_sequence_meshlet)
from chord_tpu_torch.rhi.framebuffer import FrameHistory
from chord_tpu_torch.rhi.meshlet_scene import build_meshlet_pools
from chord_tpu_torch.utils import math as tmath
from chord_tpu_torch.utils.camera import Camera

N_FRAMES = 3
W, H, PW, PH = 128, 64, 192, 96
CFG = dict(width=W, height=H, post_width=PW, post_height=PH,
           pair_capacity=1024, big_capacity=64, enable_bloom=True,
           enable_tsr=True, tsr_mode="tile")
# bench.py's geo_tex MeshletFrameConfig (capacities cap at the scene's
# 128 pairs)
MCFG = dict(draw_capacity=2048, masked_draw_capacity=256, occlusion=True,
            textured=True, normal_mapped=True, pbr_textures=True,
            alpha_masked=True, alpha_blend=True, blend_textured=False)


def build_textured_scene(procedural, scene_arrays, texture, cmath, seed=3):
    """The small textured scene, built with one package's host modules."""
    rng = np.random.default_rng(seed)
    size = 16
    pool = texture.TexturePool(size)
    n = procedural._noise2d(rng, size, octaves=3)

    def rgba(rgb, a=None):
        out = np.ones((size, size, 4), np.float32)
        out[..., :3] = rgb
        if a is not None:
            out[..., 3] = a
        return out

    mr = np.ones((size, size, 3), np.float32)
    mr[..., 1] = 0.3 + 0.6 * n
    mr[..., 2] = 0.5 * n
    lay = dict(
        base=pool.add("base", rgba(np.stack(
            [0.4 + 0.5 * n, 0.3 + 0.3 * n, 0.2 + 0.2 * n], -1))),
        normal=pool.add("normal", procedural._height_to_normal(n, 2.0)),
        mr=pool.add("mr", rgba(mr)),
        leaf=pool.add("leaf", rgba(np.stack(
            [0.2 + 0.2 * n, 0.5 + 0.3 * n, 0.1 + 0.1 * n], -1),
            (n > 0.45).astype(np.float32))))
    b = scene_arrays.SceneBuilder()
    b.texture_pool = pool
    plane = b.add_mesh(procedural.make_plane(1.0, segments=4))
    box = b.add_mesh(procedural.make_box())
    sphere = b.add_mesh(procedural.make_uv_sphere(1.0, rings=8, sectors=12))
    mat = scene_arrays.MaterialData
    maps = dict(base_color_texture=lay["base"], normal_texture=lay["normal"],
                metal_rough_texture=lay["mr"])
    ground = b.add_material(mat(base_color=(0.8, 0.8, 0.8, 1.0),
                                roughness=0.9, **maps))
    wall = b.add_material(mat(base_color=(0.9, 0.7, 0.6, 1.0), roughness=0.7,
                              emissive=(0.4, 0.3, 0.1),
                              emissive_texture=lay["base"], normal_scale=0.8,
                              **maps))
    plain = b.add_material(mat(base_color=(0.3, 0.5, 0.7, 1.0),
                               roughness=0.4, metallic=1.0))
    leaf = b.add_material(mat(base_color=(0.6, 0.9, 0.5, 1.0), roughness=0.8,
                              base_color_texture=lay["leaf"],
                              alpha_mode="mask", alpha_cutoff=0.5,
                              two_sided=True))
    glass = b.add_material(mat(base_color=(0.45, 0.62, 0.78, 0.35),
                               roughness=0.08, two_sided=True,
                               alpha_mode="blend"))

    def place(mesh, material, t, s=(1, 1, 1), pitch=0.0, yaw=0.0):
        m = cmath.compose_trs(t, rotation_quat=(0, np.sin(yaw / 2), 0,
                                                np.cos(yaw / 2)), scale=s)
        if pitch:
            m = cmath.compose_trs((0, 0, 0), rotation_quat=(
                np.sin(pitch / 2), 0, 0, np.cos(pitch / 2))) @ m
        b.add_instance(mesh, material, m)

    place(plane, ground, (0, 0, 0), (20, 1, 20))
    place(box, wall, (0, 2, -6), (12, 4, 1))
    place(box, wall, (-6, 2, -2), (1, 4, 8), yaw=0.2)
    place(sphere, plain, (2, 1, -2))
    for i in range(3):
        place(plane, leaf, (-2 + 2.0 * i, 1.5, -3 + 0.5 * i), (1.5, 1, 1.5),
              pitch=np.pi / 2)
    place(plane, glass, (1, 1.2, 0), (2, 1, 1.6), pitch=np.pi / 2)
    return b


def camera_path(cam, n=N_FRAMES):
    for i in range(n):
        cam.position = np.array([0.5 * i, 2.0, 6.0 - 0.3 * i])
        cam.look_at(np.array([0.0, 1.0, -3.0]))
        yield cam.view_uniform(i, jitter=True)


@pytest.fixture(scope="module")
def runs():
    coverage = []
    orig = jpt.paged_sample

    def covered_sample(*args, **kwargs):
        c = args[4].shape[0]
        # palette sizes the scene needs: 15 pages per block for the
        # 4-map resolve, 4 for the masked alpha test
        kwargs.update(with_coverage=True, k_pages=16 if c > 1 else 5)
        rgba, cov = orig(*args, **kwargs)
        jax.debug.callback(lambda m: coverage.append(float(m)), cov.min())
        return rgba

    jb = build_textured_scene(jproc, jsa, jtex, jmath)
    jcam = JCamera(width=W, height=H)
    jviews = [JView.from_uniform(u) for u in camera_path(jcam)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpt, "paged_sample", covered_sample)
        j_imgs, j_hist, j_stats = jax_sequence(
            jax_pools(jb, texture_pool=jb.texture_pool),
            jb.frame_instances(jcam),
            jax.tree.map(lambda *xs: jax.numpy.stack(xs), *jviews),
            JHistory.empty(H, W, post_h=PH, post_w=PW),
            config=JConfig(**CFG, interpret=True), mcfg=JMcfg(**MCFG),
            with_stats=True)
        j_imgs = np.asarray(j_imgs)

    b = build_textured_scene(proc, sa, tex, tmath)
    cam = Camera(width=W, height=H)
    views = DeviceView.stack([DeviceView.from_uniform(u, device="cpu")
                              for u in camera_path(cam)])
    inst = b.frame_instances(cam, device="cpu")
    pools = build_meshlet_pools(b, texture_pool=b.texture_pool, device="cpu")
    imgs, hist, stats = render_sequence_meshlet(
        pools, inst, views, FrameHistory.empty(H, W, PH, PW, device="cpu"),
        RendererConfig(**CFG), MeshletFrameConfig(**MCFG), with_stats=True)
    return dict(jax=(j_imgs, j_hist, j_stats), torch=(imgs.numpy(), hist,
                                                      stats),
                coverage=coverage, scene=(pools, inst))


def test_reference_palette_covers_every_pixel(runs):
    cov = runs["coverage"]
    assert len(cov) == 2 * N_FRAMES and min(cov) == 1.0, cov


def test_tex_frame_stats_match_exactly(runs):
    _, _, j_stats = runs["jax"]
    _, _, stats = runs["torch"]
    assert set(stats) == set(j_stats)
    for k, v in stats.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(j_stats[k]),
                                      err_msg=k)
    assert int(stats["draws_masked"].min()) > 0
    assert int(stats["drawn_tris"].min()) > 100
    for k in ("bin_overflow", "draw_overflow", "active_overflow"):
        assert int(stats[k].max()) == 0, k


def test_tex_frame_images_match(runs):
    j_imgs, _, _ = runs["jax"]
    imgs, _, _ = runs["torch"]
    assert imgs.shape == j_imgs.shape == (N_FRAMES, PH, PW, 3)
    diff = np.abs(imgs.astype(np.int32) - j_imgs.astype(np.int32))
    assert (diff <= 2).mean() >= 0.999, (diff.max(), (diff > 2).mean())
    assert imgs[-1].std() > 5.0


def test_tex_frame_history_matches(runs):
    _, j_hist, _ = runs["jax"]
    _, hist, _ = runs["torch"]
    assert int(hist.frame_count) == int(j_hist.frame_count) == N_FRAMES
    dd = np.abs(hist.depth.numpy() - np.asarray(j_hist.depth))
    assert (dd <= 1e-6).mean() >= 0.999, dd.max()
    np.testing.assert_allclose(hist.exposure.numpy(),
                               np.asarray(j_hist.exposure), rtol=1e-4)
    hz = np.abs(hist.hzb_flat.numpy() - np.asarray(j_hist.hzb_flat))
    assert (hz <= 1e-6).mean() >= 0.999


def test_tex_renderer_matches_sequence_and_draws_blend(runs):
    """MeshletRenderer, frame by frame, equals the sequence run; the glass
    pane is drawn by the blend bucket and changes the image."""
    pools, inst = runs["scene"]
    imgs, _, _ = runs["torch"]
    r = MeshletRenderer(RendererConfig(**CFG), MeshletFrameConfig(**MCFG))
    no_blend = MeshletRenderer(RendererConfig(**CFG), MeshletFrameConfig(
        **{**MCFG, "alpha_blend": False}))
    cam = Camera(width=W, height=H)
    for i, u in enumerate(camera_path(cam)):
        img, stats = r.render(pools, inst, u)
        np.testing.assert_array_equal(img.numpy(), imgs[i])
        assert int(stats["draws_blend"]) > 0
        assert int(stats["draws_masked"]) > 0
        img_nb, _ = no_blend.render(pools, inst, u)
    assert (img_nb.numpy() != imgs[-1]).any()
