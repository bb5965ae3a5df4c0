"""The ported GI frame against chord_tpu, end to end.

The `off` frame of tests/test_torch_frame.py (tiny atrium, render 128x64 ->
post 192x96, tile TSR, bloom) with bench.py's `all` GI on top, without the
BVH rays: gi=True, gi_mode="probe", ssr=True,
ScreenProbeConfig(rays=16, steps=6, history_mode="tile") (the probe
history through K4: chord_tpu's in interpret mode, the port's plain
version), GIConfig(cascades=2, probe_dim=8) in place of the 4x32^3 cache
(the cache's size is not what this test holds; chord_tpu compiles one
switch branch per cascade). Three frames of render_sequence_meshlet; the
history goes FrameHistory.empty(gi_cfg=..., probe_tile=8) in, and
chord_tpu's result comes back through interop.history_from_numpy.

Tolerances: stats exact. Images: >= 99.9% of u8 values within 2 levels,
as every frame test. The GI history: probe_sh (packed SH3 + sample count)
within 1e-4 relative + 1e-4 absolute on >= 99.5% of values, the sample
counts (sums of the taps' weights) within 1e-6 relative, the probe depths
within 1e-6; gi_diffuse and gi_specular within 1e-3 relative + 1e-4
absolute on >= 99% of values. The port rounds every f32 operation where
chord_tpu's compiled frame contracts a*b+c into FMAs, and these planes
carry that through three frames of temporal feedback (last frame's TSR
colour feeds the probe taps and SSR). The jitted interleaved-gradient
noise that picks the GGX specular direction is fed to the port (as
tests/test_torch_repro_eval.py does): eager and jitted IGN differ at
~0.35% of pixels. The world cache by probe rows: >= 99% of rows within
1e-4 relative (a probe that lands one cell over under an FMA moves a whole
row).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from chord_tpu.asset.procedural import build_sponza_like as jax_sponza
from chord_tpu.ops import bluenoise as jbn
from chord_tpu.ops.gi import GIConfig as JGIConfig
from chord_tpu.ops.screen_probe import ScreenProbeConfig as JProbeConfig
from chord_tpu.renderer.deferred import DeviceView as JView
from chord_tpu.renderer.deferred import RendererConfig as JConfig
from chord_tpu.renderer.meshlet_frame import MeshletFrameConfig as JMcfg
from chord_tpu.renderer.meshlet_frame import \
    render_sequence_meshlet as jax_sequence
from chord_tpu.rhi.framebuffer import FrameHistory as JHistory
from chord_tpu.rhi.meshlet_scene import build_meshlet_pools as jax_pools
from chord_tpu.utils.camera import Camera as JCamera

import chord_tpu_torch.renderer.meshlet_frame as mf
from chord_tpu_torch import interop
from chord_tpu_torch.asset.procedural import build_sponza_like
from chord_tpu_torch.ops import kernels
from chord_tpu_torch.ops.gi import GIConfig
from chord_tpu_torch.ops.screen_probe import ScreenProbeConfig
from chord_tpu_torch.renderer import (DeviceView, MeshletFrameConfig,
                                      MeshletRenderer, RendererConfig,
                                      render_sequence_meshlet)
from chord_tpu_torch.rhi.framebuffer import FrameHistory
from chord_tpu_torch.rhi.meshlet_scene import build_meshlet_pools
from chord_tpu_torch.utils.camera import Camera
from test_torch_frame import CFG, N_FRAMES, PH, PW, H, W, _path

GI = dict(cascades=2, probe_dim=8)
PROBE = dict(rays=16, steps=6, history_mode="tile")
MCFG = dict(draw_capacity=1024, gi=True, gi_mode="probe", ssr=True)


def _jitted_ign():
    jitted = {}

    def noise(h, w, frame=0, device=None):
        if (h, w) not in jitted:
            jitted[h, w] = jax.jit(lambda f: jbn.interleaved_gradient_noise(
                h, w, f))
        f = int(frame) if isinstance(frame, torch.Tensor) else frame
        out = torch.from_numpy(np.array(jitted[h, w](np.int32(f))))
        return out.to(device or "cpu")
    return noise


def _port_setup():
    b = build_sponza_like(detail=1)
    cam = Camera(width=W, height=H)
    views = DeviceView.stack([DeviceView.from_uniform(u, device="cpu")
                              for u in _path(cam)])
    return (build_meshlet_pools(b, device="cpu"),
            b.frame_instances(cam, device="cpu"), views)


def _port_mcfg():
    return MeshletFrameConfig(**MCFG, gi_cfg=GIConfig(**GI),
                              probe_cfg=ScreenProbeConfig(**PROBE))


@pytest.fixture(scope="module")
def runs():
    jb = jax_sponza(detail=1)
    jcam = JCamera(width=W, height=H)
    jviews = [JView.from_uniform(u) for u in _path(jcam)]
    j_imgs, j_hist, j_stats = jax_sequence(
        jax_pools(jb), jb.frame_instances(jcam),
        jax.tree.map(lambda *xs: jax.numpy.stack(xs), *jviews),
        JHistory.empty(H, W, post_h=PH, post_w=PW, gi_cfg=JGIConfig(**GI),
                       probe_tile=8),
        config=JConfig(**CFG, interpret=True),
        mcfg=JMcfg(**MCFG, gi_cfg=JGIConfig(**GI),
                   probe_cfg=JProbeConfig(**PROBE)), with_stats=True)
    j_hist = interop.history_from_numpy(
        {f: np.asarray(v) for f, v in vars(j_hist).items()
         if f != "ddgi"}, device="cpu")

    pools, inst, views = _port_setup()
    with pytest.MonkeyPatch.context() as mp, \
            kernels.capture_inputs() as captured:
        mp.setattr(mf, "interleaved_gradient_noise", _jitted_ign())
        imgs, hist, stats = render_sequence_meshlet(
            pools, inst, views,
            FrameHistory.empty(H, W, PH, PW, gi_cfg=GIConfig(**GI),
                               probe_tile=8, device="cpu"),
            RendererConfig(**CFG), _port_mcfg(), with_stats=True)
    return dict(jax=(np.asarray(j_imgs), j_hist, j_stats),
                torch=(imgs.numpy(), hist, stats),
                k4_shapes=[tuple(a[0].shape) for a, _ in
                           captured["tile_reproject"]],
                scene=(pools, inst))


def test_gi_frame_stats_match_exactly(runs):
    _, _, j_stats = runs["jax"]
    _, _, stats = runs["torch"]
    assert set(stats) == set(j_stats)
    for k, v in stats.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(j_stats[k]),
                                      err_msg=k)
    for k in ("bin_overflow", "draw_overflow", "active_overflow"):
        assert int(stats[k].max()) == 0, k


def test_gi_frame_images_match(runs):
    j_imgs, _, _ = runs["jax"]
    imgs, _, _ = runs["torch"]
    assert imgs.shape == j_imgs.shape == (N_FRAMES, PH, PW, 3)
    diff = np.abs(imgs.astype(np.int32) - j_imgs.astype(np.int32))
    assert (diff <= 2).mean() >= 0.999, (diff.max(), (diff > 2).mean())
    assert imgs[-1].std() > 5.0


def _share_close(a, b, rtol, atol):
    a, b = a.numpy(), b.numpy()
    assert a.shape == b.shape
    return (np.abs(a - b) <= atol + rtol * np.abs(b)).mean()


def test_gi_frame_history_matches(runs):
    _, jh, _ = runs["jax"]
    _, hist, _ = runs["torch"]
    assert int(hist.frame_count) == int(jh.frame_count) == N_FRAMES
    assert hist.probe_sh.shape == (H // 8, W // 8, 28)
    assert hist.gi_diffuse.shape == (H // 2, W // 2, 3)
    assert hist.gi_specular.shape == (H // 8, W // 8, 3)
    # the sample counts are sums of the taps' float weights
    np.testing.assert_allclose(hist.probe_sh[..., 27].numpy(),
                               jh.probe_sh[..., 27].numpy(), rtol=1e-6)
    assert float(hist.probe_sh[..., 27].max()) > 8.0
    assert _share_close(hist.probe_sh, jh.probe_sh, 1e-4, 1e-4) >= 0.995
    # probe depths are raster depths at the spawn pixels (1e-6, as the
    # depth history of tests/test_torch_frame.py)
    assert _share_close(hist.probe_depth, jh.probe_depth, 0, 1e-6) >= 0.99
    for name in ("gi_diffuse", "gi_specular"):
        share = _share_close(getattr(hist, name), getattr(jh, name), 1e-3,
                             1e-4)
        assert share >= 0.99, (name, share)
        assert float(getattr(hist, name).max()) > 0.0, name
    d = np.abs(hist.gi_cache.numpy() - jh.gi_cache.numpy())
    rows = (d <= 1e-4 * np.maximum(1.0, np.abs(jh.gi_cache.numpy()))).all(-1)
    assert rows.mean() >= 0.99, (rows.mean(), d.max())
    assert (hist.gi_cache[..., 27].numpy() > 0).any()


def test_gi_frame_runs_k4_twice_a_frame(runs):
    """TSR's history (3 planes at post res) and the GI diffuse history (3
    planes at half res, padded to K4's 32x128 tiles plus its margins) go
    through K4's wrapper every frame."""
    shapes = runs["k4_shapes"]
    assert len(shapes) == 2 * N_FRAMES
    margin = (128 + 48, 128 + 256)
    tsr = (3, 96 + margin[0], 256 + margin[1])
    gi = (3, 32 + margin[0], 128 + margin[1])
    assert sorted(set(shapes)) == sorted({tsr, gi}), shapes


def test_gi_renderer_matches_sequence(runs):
    """MeshletRenderer with GI (its own env-BRDF LUT and GI history) equals
    the sequence run frame by frame."""
    pools, inst = runs["scene"]
    imgs, _, _ = runs["torch"]
    r = MeshletRenderer(RendererConfig(**CFG), _port_mcfg())
    cam = Camera(width=W, height=H)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mf, "interleaved_gradient_noise", _jitted_ign())
        for i, u in enumerate(_path(cam)):
            img, _ = r.render(pools, inst, u)
            np.testing.assert_array_equal(img.numpy(), imgs[i])
    assert r.history.gi_cache.shape == (2, 512, 28)
    assert tuple(r._brdf_cache.shape) == (32, 32, 2)
    assert dataclasses.is_dataclass(r.history)


def test_check_slice_accepts_all_no_rt():
    """bench.py's `all` rung (bench.py:204-219) with gi_rt=False passes the
    slice check; with gi_rt=True it raises."""
    rcfg = RendererConfig(width=1280, height=720, post_width=1920,
                          post_height=1080, tsr_mode="tile")
    all_no_rt = MeshletFrameConfig(
        draw_capacity=2048, masked_draw_capacity=256, shadows=True,
        atmosphere=True, gi=True, gi_mode="probe", ssr=True, textured=True,
        alpha_masked=True, alpha_blend=True, normal_mapped=True,
        pbr_textures=True, shadow_masked=True, trilinear=True,
        probe_cfg=ScreenProbeConfig(rays=16, steps=6, history_mode="tile"))
    mf.check_slice(rcfg, all_no_rt)
    with pytest.raises(NotImplementedError):
        mf.check_slice(rcfg, all_no_rt._replace(gi_rt=True, rt_rays=2))


def test_gi_history_and_brdf_lut_cross_interop():
    """FrameHistory.empty with GI has chord_tpu's fields and shapes, which
    interop carries across (the `ddgi` leaf is left behind); a per-frame
    stacked env-BRDF LUT arrives once, shared by the path."""
    from chord_tpu.ops import brdf_lut as jbrdf

    jh = JHistory.empty(H, W, post_h=PH, post_w=PW, gi_cfg=JGIConfig(**GI),
                        probe_tile=8)
    got = FrameHistory.empty(H, W, PH, PW, gi_cfg=GIConfig(**GI),
                             probe_tile=8, device="cpu")
    ref = {f.name: np.asarray(getattr(jh, f.name))
           for f in dataclasses.fields(got)}
    carried = interop.history_from_numpy(
        dict(ref, ddgi=object()), device="cpu")
    for name, a in ref.items():
        np.testing.assert_array_equal(getattr(got, name).numpy(), a, name)
        np.testing.assert_array_equal(getattr(carried, name).numpy(), a,
                                      name)
    lut = np.asarray(jbrdf.build_env_brdf_lut(4))
    jcam = JCamera(width=W, height=H)
    jviews = [JView.from_uniform(u).replace(brdf_lut=lut)
              for u in _path(jcam)]
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *jviews)
    view = interop.view_from_numpy(
        {k: v for k, v in vars(stacked).items() if v is not None},
        device="cpu")
    assert view.num_frames == N_FRAMES
    np.testing.assert_array_equal(view.brdf_lut.numpy(), lut)
    assert view.frame(1).brdf_lut is view.brdf_lut
