"""The ported `geo_shadow_atmo` frame against chord_tpu, end to end.

The bench's `geo_shadow_atmo` rung (bench.py:42-44, 204-256): the `geo_tex`
frame plus cascaded shadow maps (round-robin refresh, scrolled cache,
alpha-tested masked casters), PCSS on a rotating 2x2 phase of the 1/4-res
eval grid with the temporal mask, the physically based sky, sun tint and
ambient, and aerial perspective; the atmosphere LUTs are built once on the
host as bench.py does (each package builds its own). Five frames of
render_sequence_meshlet(with_stats=True) at render 128x64 -> post 192x96
along a jittered moving camera, ShadowConfig(cascade_count=2,
resolution=256) and bench defaults otherwise, on test_torch_frame_tex.py's
hand-built textured scene (leaf cards are the masked casters).

chord_tpu runs its Pallas kernels in interpret mode; its PCSS goes through
evaluate_shadow on the CPU (its own dispatch), which is the function K6
computes. Its paged sampler is wrapped to report palette coverage, which
must be complete (test_torch_frame_tex.py says why).

Tolerances: stats are integers and must match exactly. Images: >= 99.9% of
u8 channel values within 2 levels (test_torch_frame_tex.py; a PCSS tap
that flips on an XLA FMA moves a mask texel by 1/6). Shadow mask: >= 99%
of texels within 1e-5 and every texel within one PCF sample (1/6) plus
the temporal blend's float slack. Cascade maps: coverage (depth > 0) equal
on >= 99.9% of texels, depth within ShadowConfig.depth_bias (2e-4) on
>= 99.9% and within 1e-3 everywhere: each package runs its own mesh-shader
setup, whose plane coefficients differ by XLA's FMAs (<= 7e-7 relative,
test_torch_mesh_shader.py), and the homogeneous depth divide amplifies that
to ~2e-4 in [0,1] light-space depth (test_torch_shadow.py measures it and
shows the port's raster within 1e-6 on chord_tpu's own setup). Cascade
matrices and the depth range: 1e-5 relative (f32 fit arithmetic, XLA vs
PyTorch rounding).
"""

import jax
import numpy as np
import pytest

import chord_tpu.asset.procedural as jproc
import chord_tpu.asset.texture as jtex
import chord_tpu.ops.atmosphere as jatm
import chord_tpu.ops.paged_texture as jpt
import chord_tpu.rhi.scene_arrays as jsa
import chord_tpu.utils.math as jmath
from chord_tpu.ops.shadow import ShadowConfig as JShadowConfig
from chord_tpu.renderer.deferred import DeviceView as JView
from chord_tpu.renderer.deferred import RendererConfig as JConfig
from chord_tpu.renderer.meshlet_frame import MeshletFrameConfig as JMcfg
from chord_tpu.renderer.meshlet_frame import \
    render_sequence_meshlet as jax_sequence
from chord_tpu.rhi.framebuffer import FrameHistory as JHistory
from chord_tpu.rhi.meshlet_scene import build_meshlet_pools as jax_pools
from chord_tpu.utils.camera import Camera as JCamera

import torch

import chord_tpu_torch.asset.procedural as proc
import chord_tpu_torch.asset.texture as tex
import chord_tpu_torch.renderer.meshlet_frame as mf
import chord_tpu_torch.rhi.scene_arrays as sa
from chord_tpu_torch.ops import atmosphere as atm
from chord_tpu_torch.ops import kernels
from chord_tpu_torch.ops.shadow import ShadowConfig
from chord_tpu_torch.renderer import (DeviceView, MeshletFrameConfig,
                                      MeshletRenderer, RendererConfig,
                                      render_sequence_meshlet)
from chord_tpu_torch.rhi.framebuffer import FrameHistory
from chord_tpu_torch.rhi.meshlet_scene import build_meshlet_pools
from chord_tpu_torch.utils import math as tmath
from chord_tpu_torch.utils.camera import Camera
from test_torch_frame_tex import (CFG, MCFG, PH, PW, H, W,
                                  build_textured_scene, camera_path)

N_FRAMES = 5
SHADOW = dict(cascade_count=2, resolution=256)
# bench.py's geo_shadow_atmo rung on top of the geo_tex config
SMCFG = dict(MCFG, shadows=True, atmosphere=True, shadow_masked=True,
             shadow_draw_capacity=2048)
HIST = dict(shadow_div=4, shadow_cascades=2, shadow_res=256, shadow_phase=2)
SUN = np.asarray([0.3, 0.8, 0.5], np.float32) / np.float32(
    np.linalg.norm([0.3, 0.8, 0.5]))


def _jax_run(coverage):
    orig = jpt.paged_sample

    def covered_sample(*args, **kwargs):
        c = args[4].shape[0]
        kwargs.update(with_coverage=True, k_pages=16 if c > 1 else 5)
        rgba, cov = orig(*args, **kwargs)
        jax.debug.callback(lambda m: coverage.append(float(m)), cov.min())
        return rgba

    scfg = JShadowConfig(**SHADOW)
    jb = build_textured_scene(jproc, jsa, jtex, jmath)
    jcam = JCamera(width=W, height=H)
    p = jatm.AtmosphereParams()
    t = jatm.build_transmittance_lut(p, 40)
    ms = jatm.build_multiscatter_lut(p, t, dir_samples=16, steps=12)
    sky = jatm.build_sky_view_lut(p, t, ms, jax.numpy.asarray(SUN))
    jviews = [JView.from_uniform(u, shadow_cfg=scfg).replace(
        atmo_t_lut=t, atmo_ms_lut=ms, atmo_sky_lut=sky)
        for u in camera_path(jcam, N_FRAMES)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpt, "paged_sample", covered_sample)
        imgs, hist, stats = jax_sequence(
            jax_pools(jb, texture_pool=jb.texture_pool),
            jb.frame_instances(jcam),
            jax.tree.map(lambda *xs: jax.numpy.stack(xs), *jviews),
            JHistory.empty(H, W, post_h=PH, post_w=PW, **HIST),
            config=JConfig(**CFG, interpret=True),
            mcfg=JMcfg(**SMCFG, shadow_cfg=scfg), with_stats=True)
        return np.asarray(imgs), hist, stats


def _port_inputs():
    scfg = ShadowConfig(**SHADOW)
    b = build_textured_scene(proc, sa, tex, tmath)
    cam = Camera(width=W, height=H)
    p = atm.AtmosphereParams()
    t = atm.build_transmittance_lut(p, 40, device="cpu")
    ms = atm.build_multiscatter_lut(p, t, dir_samples=16, steps=12)
    sky = atm.build_sky_view_lut(p, t, ms, torch.from_numpy(SUN))
    views = DeviceView.stack([
        DeviceView.from_uniform(u, shadow_cfg=scfg, device="cpu").replace(
            atmo_t_lut=t, atmo_ms_lut=ms, atmo_sky_lut=sky)
        for u in camera_path(cam, N_FRAMES)])
    pools = build_meshlet_pools(b, texture_pool=b.texture_pool, device="cpu")
    return pools, b.frame_instances(cam, device="cpu"), views


@pytest.fixture(scope="module")
def runs():
    coverage = []
    jax_out = _jax_run(coverage)
    pools, inst, views = _port_inputs()
    strips = []
    bin_windows = mf.bin_windows

    def spy(setup, config, tile_keep=None):
        # a scrolled refresh keeps only the exposed tile strips
        if tile_keep is not None:
            strips.append(int((~tile_keep).sum()))
        return bin_windows(setup, config, tile_keep=tile_keep)

    with pytest.MonkeyPatch.context() as mp, \
            kernels.capture_inputs() as captured:
        mp.setattr(mf, "bin_windows", spy)
        imgs, hist, stats = render_sequence_meshlet(
            pools, inst, views, FrameHistory.empty(H, W, PH, PW, **HIST,
                                                   device="cpu"),
            RendererConfig(**CFG), MeshletFrameConfig(
                **SMCFG, shadow_cfg=ShadowConfig(**SHADOW)), with_stats=True)
    return dict(jax=jax_out, torch=(imgs.numpy(), hist, stats),
                coverage=coverage, strips=strips,
                calls={k: len(v) for k, v in captured.items()},
                scene=(pools, inst))


def test_shadow_frame_reference_palette_covers_every_pixel(runs):
    cov = runs["coverage"]
    # per frame: the resolve (4 maps), the masked test, and the masked
    # casters of every refreshed cascade (both are < shadow_masked_cascades)
    assert len(cov) == 3 * N_FRAMES and min(cov) == 1.0, cov


def test_shadow_frame_stats_match_exactly(runs):
    _, _, j_stats = runs["jax"]
    _, _, stats = runs["torch"]
    # the port adds the cascade refresh's overflows to chord_tpu's stats
    shadow_keys = {"shadow_draw_overflow", "shadow_masked_overflow",
                   "shadow_bin_overflow"}
    assert set(stats) == set(j_stats) | shadow_keys
    for k, v in j_stats.items():
        np.testing.assert_array_equal(stats[k].numpy(), np.asarray(v),
                                      err_msg=k)
    assert int(stats["draws_masked"].min()) > 0
    for k in ("bin_overflow", "draw_overflow", "active_overflow",
              *shadow_keys):
        assert int(stats[k].max()) == 0, k


def test_shadow_frame_images_match(runs):
    j_imgs, _, _ = runs["jax"]
    imgs, _, _ = runs["torch"]
    assert imgs.shape == j_imgs.shape == (N_FRAMES, PH, PW, 3)
    diff = np.abs(imgs.astype(np.int32) - j_imgs.astype(np.int32))
    assert (diff <= 2).mean() >= 0.999, (diff.max(), (diff > 2).mean())
    assert imgs[-1].std() > 5.0


def test_shadow_frame_history_matches(runs):
    _, j_hist, _ = runs["jax"]
    _, hist, _ = runs["torch"]
    assert int(hist.frame_count) == int(j_hist.frame_count) == N_FRAMES
    m, jm = hist.shadow_mask.numpy(), np.asarray(j_hist.shadow_mask)
    assert m.shape == jm.shape == (H // 4, W // 4)
    dm = np.abs(m - jm)
    assert (dm <= 1e-5).mean() >= 0.99 and dm.max() <= 1 / 6 + 1e-4, \
        dm.max()
    sm, jsm = hist.shadow_maps.numpy(), np.asarray(j_hist.shadow_maps)
    assert sm.shape == jsm.shape == (2, 256, 256)
    dsm = np.abs(sm - jsm)
    assert ((sm > 0) == (jsm > 0)).mean() >= 0.999
    assert (dsm <= 2e-4).mean() >= 0.999 and dsm.max() <= 1e-3, dsm.max()
    np.testing.assert_allclose(hist.shadow_mats.numpy(),
                               np.asarray(j_hist.shadow_mats), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(hist.depth_range.numpy(),
                               np.asarray(j_hist.depth_range), rtol=1e-5)
    dd = np.abs(hist.depth.numpy() - np.asarray(j_hist.depth))
    assert (dd <= 1e-6).mean() >= 0.999, dd.max()


def test_shadow_frame_casts_shadow_and_scrolls(runs):
    """The mask holds lit and shadowed texels, the cached maps hold depth,
    at least one refresh took the scrolled path (some tiles dropped), and
    the frame called K6's wrapper once per frame and K5's three times (on
    the CPU the wrappers run their plain versions)."""
    _, hist, _ = runs["torch"]
    m = hist.shadow_mask.numpy()
    assert (m < 0.5).any() and (m > 0.99).any()
    assert (hist.shadow_maps.numpy() > 0).mean(axis=(1, 2)).min() > 0.01
    assert max(runs["strips"]) > 0, runs["strips"]
    assert runs["calls"]["pcss"] == N_FRAMES
    assert runs["calls"]["paged_texture"] == 3 * N_FRAMES


def test_shadow_renderer_warms_every_cascade(runs):
    """MeshletRenderer fills every cached cascade before its first image
    and carries the shadow state frame to frame."""
    pools, inst = runs["scene"]
    r = MeshletRenderer(RendererConfig(**CFG), MeshletFrameConfig(
        **SMCFG, shadow_cfg=ShadowConfig(**SHADOW)))
    cam = Camera(width=W, height=H)
    for u in camera_path(cam, 2):
        img, _ = r.render(pools, inst, u)
    assert int(r.history.frame_count) == 2 + SHADOW["cascade_count"] - 1
    assert (r.history.shadow_maps.numpy() > 0).mean(axis=(1, 2)).min() > 0.01
    assert img.shape == (PH, PW, 3) and img.numpy().std() > 5.0
