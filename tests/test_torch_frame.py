"""The ported `off` frame against chord_tpu, end to end.

Three frames of render_sequence_meshlet(with_stats=True) at render 128x64,
post 192x96 (tile-mode TSR upscale, bloom, auto exposure) on the tiny
atrium, with a jittered moving camera. Each package builds the scene with
its own host code from the same seed; chord_tpu runs its Pallas kernels in
interpret mode, the port its plain PyTorch kernel versions.

Tolerances: the per-frame stats are integers and must match exactly. The
images are u8 after the ACES tonemap: f32 rounding differences (matrix
inverse, einsum sum order, pow/log2 ulps) move a pixel by at most a level
or two, so >= 99.9% of channel values must lie within 2 levels. History
depth must match to 1e-6 absolute on >= 99.9% of pixels (a pixel at a
depth-tie edge may take the other triangle) and the TSR history colour to
2e-3 relative.
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

from chord_tpu_torch.asset.procedural import build_sponza_like
from chord_tpu_torch.ops.gi import GIConfig
from chord_tpu_torch.ops.screen_probe import ScreenProbeConfig
from chord_tpu_torch.ops.shadow import ShadowConfig
from chord_tpu_torch.renderer import (DeviceView, MeshletFrameConfig,
                                      MeshletRenderer, RendererConfig,
                                      render_sequence_meshlet)
from chord_tpu_torch.rhi.framebuffer import FrameHistory
from chord_tpu_torch.rhi.meshlet_scene import build_meshlet_pools
from chord_tpu_torch.utils.camera import Camera

N_FRAMES = 3
W, H, PW, PH = 128, 64, 192, 96
CFG = dict(width=W, height=H, post_width=PW, post_height=PH,
           pair_capacity=4096, big_capacity=128, enable_bloom=True,
           enable_tsr=True, tsr_mode="tile")


def _path(cam):
    cam.position = np.array([-15.0, 4.0, 0.0])
    cam.look_at(np.array([10.0, 2.0, 0.0]))
    for i in range(N_FRAMES):
        cam.position = np.array([-15.0 + 0.5 * i, 4.0, 0.3 * i])
        yield cam.view_uniform(i, jitter=True)


@pytest.fixture(scope="module")
def runs():
    jb = jax_sponza(detail=1)
    jcam = JCamera(width=W, height=H)
    jviews = [JView.from_uniform(u) for u in _path(jcam)]
    jinst = jb.frame_instances(jcam)
    j_imgs, j_hist, j_stats = jax_sequence(
        jax_pools(jb), jinst,
        jax.tree.map(lambda *xs: jax.numpy.stack(xs), *jviews),
        JHistory.empty(H, W, post_h=PH, post_w=PW),
        config=JConfig(**CFG, interpret=True),
        mcfg=JMcfg(draw_capacity=1024, occlusion=True), with_stats=True)

    b = build_sponza_like(detail=1)
    cam = Camera(width=W, height=H)
    views = DeviceView.stack([DeviceView.from_uniform(u, device="cpu")
                              for u in _path(cam)])
    inst = b.frame_instances(cam, device="cpu")
    pools = build_meshlet_pools(b, device="cpu")
    imgs, hist, stats = render_sequence_meshlet(
        pools, inst, views, FrameHistory.empty(H, W, PH, PW, device="cpu"),
        RendererConfig(**CFG), MeshletFrameConfig(draw_capacity=1024),
        with_stats=True)
    return dict(jax=(np.asarray(j_imgs), j_hist, j_stats),
                torch=(imgs.numpy(), hist, stats),
                scene=(b, pools, inst, views))


def test_frame_stats_match_exactly(runs):
    _, _, j_stats = runs["jax"]
    _, _, stats = runs["torch"]
    for k, v in stats.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(j_stats[k]),
                                      err_msg=k)
    assert int(stats["drawn_tris"].min()) > 100
    for k in ("bin_overflow", "draw_overflow", "active_overflow"):
        assert int(stats[k].max()) == 0, k


def test_frame_images_match(runs):
    j_imgs, _, _ = runs["jax"]
    imgs, _, _ = runs["torch"]
    assert imgs.shape == j_imgs.shape == (N_FRAMES, PH, PW, 3)
    diff = np.abs(imgs.astype(np.int32) - j_imgs.astype(np.int32))
    assert (diff <= 2).mean() >= 0.999, (diff.max(), (diff > 2).mean())
    assert imgs[-1].std() > 5.0     # not a constant image


def test_frame_history_matches(runs):
    _, j_hist, _ = runs["jax"]
    _, hist, _ = runs["torch"]
    assert int(hist.frame_count) == int(j_hist.frame_count) == N_FRAMES
    assert float(hist.valid) == float(j_hist.valid) == 1.0
    dd = np.abs(hist.depth.numpy() - np.asarray(j_hist.depth))
    assert (dd <= 1e-6).mean() >= 0.999, dd.max()
    np.testing.assert_allclose(hist.exposure.numpy(),
                               np.asarray(j_hist.exposure), rtol=1e-4)
    tc, jtc = hist.tsr_color.numpy(), np.asarray(j_hist.tsr_color)
    close = np.abs(tc - jtc) <= 2e-3 * np.maximum(np.abs(jtc), 1e-2)
    assert close.mean() >= 0.999, np.abs(tc - jtc).max()
    hz = np.abs(hist.hzb_flat.numpy() - np.asarray(j_hist.hzb_flat))
    assert (hz <= 1e-6).mean() >= 0.999


def test_renderer_matches_sequence(runs):
    """MeshletRenderer.render, frame by frame, equals the sequence run."""
    b, pools, inst, views = runs["scene"]
    imgs, _, _ = runs["torch"]
    r = MeshletRenderer(RendererConfig(**CFG),
                        MeshletFrameConfig(draw_capacity=1024))
    cam = Camera(width=W, height=H)
    for i, u in enumerate(_path(cam)):
        img, stats = r.render(pools, inst, u)
        np.testing.assert_array_equal(img.numpy(), imgs[i])
    assert int(r.history.frame_count) == N_FRAMES


def test_flags_outside_the_slice_raise(runs):
    b, pools, inst, views = runs["scene"]
    hist = FrameHistory.empty(H, W, PH, PW, device="cpu")
    for mcfg, cfg in [
            (MeshletFrameConfig(shadows=True, shadow_cfg=ShadowConfig(
                pipelined=True)), RendererConfig(**CFG)),
            (MeshletFrameConfig(masked_layers=2), RendererConfig(**CFG)),
            (MeshletFrameConfig(gi=True, gi_rt=True), RendererConfig(**CFG)),
            (MeshletFrameConfig(gi=True, gi_mode="ddgi"),
             RendererConfig(**CFG)),
            (MeshletFrameConfig(gi=True, gi_cfg=GIConfig(ao_mode="rtao")),
             RendererConfig(**CFG)),
            (MeshletFrameConfig(gi=True, probe_cfg=ScreenProbeConfig(
                trace_mode="march")), RendererConfig(**CFG)),
            (MeshletFrameConfig(occlusion=False), RendererConfig(**CFG)),
            (MeshletFrameConfig(), RendererConfig(**{**CFG,
                                                     "tsr_mode": "gather"})),
            (MeshletFrameConfig(), RendererConfig(**{**CFG,
                                                     "output": "hdr10"}))]:
        with pytest.raises(NotImplementedError):
            render_sequence_meshlet(pools, inst, views, hist, cfg, mcfg)
