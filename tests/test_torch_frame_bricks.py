"""The meshlet frame with the brick raster (r.raster.bricks=1, kernel K7 in
place of K1 for both occlusion phases) against chord_tpu, and the meshlet
frame's indifference to RendererConfig.subtiles.

Three frames of render_sequence_meshlet(with_stats=True) of the `off`
feature set at render 128x64, post 192x96, on the tiny atrium, as in
test_torch_frame.py, with the cvars set in both packages: r.raster.bricks
and r.raster.subS=4 (the raster tile becomes 208 rows, a multiple of
4*sub_s; sub_s=4 keeps chord_tpu's unrolled interpret-mode brick kernel
small enough to compile in about a minute). chord_tpu runs its Pallas
kernels in interpret mode, the port its plain kernel versions. Tolerances
as in test_torch_frame.py: stats exact, >= 99.9% of u8 values within 2
levels, history depth within 1e-6 on >= 99.9% of pixels.

chord_tpu's meshlet frame never reads `subtiles` (only its flat
rasterize() does), so the port's meshlet frame must render the same
frames with and without it.
"""

import jax
import numpy as np
import pytest

from chord_tpu.asset.procedural import build_sponza_like as jax_sponza
from chord_tpu.renderer.deferred import DeviceView as JView
from chord_tpu.renderer.deferred import RendererConfig as JConfig
from chord_tpu.renderer.meshlet_frame import MeshletFrameConfig as JMcfg
from chord_tpu.renderer.meshlet_frame import \
    render_sequence_meshlet as jax_sequence
from chord_tpu.rhi.framebuffer import FrameHistory as JHistory
from chord_tpu.rhi.meshlet_scene import build_meshlet_pools as jax_pools
from chord_tpu.utils.camera import Camera as JCamera
from chord_tpu.utils.cvar import cvars as jcvars

from chord_tpu_torch.asset.procedural import build_sponza_like
from chord_tpu_torch.ops import kernels
from chord_tpu_torch.renderer import (DeviceView, MeshletFrameConfig,
                                      RendererConfig,
                                      render_sequence_meshlet)
from chord_tpu_torch.rhi.framebuffer import FrameHistory
from chord_tpu_torch.rhi.meshlet_scene import build_meshlet_pools
from chord_tpu_torch.utils.camera import Camera
from chord_tpu_torch.utils.cvar import cvars

N_FRAMES = 3
W, H, PW, PH = 128, 64, 192, 96
CFG = dict(width=W, height=H, post_width=PW, post_height=PH,
           pair_capacity=4096, big_capacity=128, enable_bloom=True,
           enable_tsr=True, tsr_mode="tile")


def _path(cam):
    for i in range(N_FRAMES):
        cam.position = np.array([-15.0 + 0.5 * i, 4.0, 0.3 * i])
        cam.look_at(np.array([10.0, 2.0, 0.0]))
        yield cam.view_uniform(i, jitter=True)


def _port_inputs():
    b = build_sponza_like(detail=1)
    cam = Camera(width=W, height=H)
    views = DeviceView.stack([DeviceView.from_uniform(u, device="cpu")
                              for u in _path(cam)])
    return (build_meshlet_pools(b, device="cpu"),
            b.frame_instances(cam, device="cpu"), views,
            FrameHistory.empty(H, W, PH, PW, device="cpu"))


@pytest.fixture(scope="module")
def runs():
    keep = [(c, n, c.get(n)) for c in (jcvars, cvars)
            for n in ("r.raster.bricks", "r.raster.subS")]
    for c in (jcvars, cvars):
        c.set("r.raster.bricks", True)
        c.set("r.raster.subS", 4)
    try:
        jb = jax_sponza(detail=1)
        jcam = JCamera(width=W, height=H)
        jviews = [JView.from_uniform(u) for u in _path(jcam)]
        j_imgs, j_hist, j_stats = jax_sequence(
            jax_pools(jb), jb.frame_instances(jcam),
            jax.tree.map(lambda *xs: jax.numpy.stack(xs), *jviews),
            JHistory.empty(H, W, post_h=PH, post_w=PW),
            config=JConfig(**CFG, interpret=True),
            mcfg=JMcfg(draw_capacity=1024, occlusion=True), with_stats=True)
        kernels.reset_launch_counts()
        with kernels.capture_inputs() as captured:
            imgs, hist, stats = render_sequence_meshlet(
                *_port_inputs(), RendererConfig(**CFG),
                MeshletFrameConfig(draw_capacity=1024), with_stats=True)
        calls = {k: len(v) for k, v in captured.items()}
        rc = RendererConfig(**CFG).raster_config()
        assert (rc.bricks, rc.sub_s, rc.tile_h) == (True, 4, 208)
    finally:
        for c, n, v in keep:
            c.set(n, v)
    return dict(jax=(np.asarray(j_imgs), j_hist, j_stats),
                torch=(imgs.numpy(), hist, stats), calls=calls)


def test_brick_frame_runs_k7_only(runs):
    """Both occlusion phases of every frame went through K7's wrapper."""
    assert runs["calls"]["raster_bricks"] == 2 * N_FRAMES
    assert runs["calls"]["raster"] == 0


def test_brick_frame_stats_match_exactly(runs):
    _, _, j_stats = runs["jax"]
    _, _, stats = runs["torch"]
    for k, v in stats.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(j_stats[k]),
                                      err_msg=k)
    assert int(stats["drawn_tris"].min()) > 100
    for k in ("bin_overflow", "draw_overflow", "active_overflow"):
        assert int(stats[k].max()) == 0, k


def test_brick_frame_images_match(runs):
    j_imgs, j_hist, _ = runs["jax"]
    imgs, hist, _ = runs["torch"]
    assert imgs.shape == j_imgs.shape == (N_FRAMES, PH, PW, 3)
    diff = np.abs(imgs.astype(np.int32) - j_imgs.astype(np.int32))
    assert (diff <= 2).mean() >= 0.999, (diff.max(), (diff > 2).mean())
    assert imgs[-1].std() > 5.0
    dd = np.abs(hist.depth.numpy() - np.asarray(j_hist.depth))
    assert (dd <= 1e-6).mean() >= 0.999, dd.max()


def test_meshlet_frame_ignores_subtiles():
    out = {}
    for sub in (False, True):
        imgs, hist, stats = render_sequence_meshlet(
            *_port_inputs(), RendererConfig(**CFG, subtiles=sub),
            MeshletFrameConfig(draw_capacity=1024), with_stats=True)
        out[sub] = (imgs.numpy(), hist.depth.numpy(),
                    {k: v.tolist() for k, v in stats.items()})
    np.testing.assert_array_equal(out[True][0], out[False][0])
    np.testing.assert_array_equal(out[True][1], out[False][1])
    assert out[True][2] == out[False][2]
