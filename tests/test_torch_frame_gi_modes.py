"""The GI frame's other modes against chord_tpu, end to end: DDGI probe
volumes, and the triangle-exact BVH with RTAO and the probe march.

tests/test_torch_frame_gi.py's frame (tiny atrium, render 128x64 -> post
192x96, tile TSR, bloom, GIConfig(cascades=2, probe_dim=8), SSR), three
frames of render_sequence_meshlet, each package with a BVH built from its
own pools and instance table:
(a) `ddgi`: gi_mode="ddgi" with DDGIConfig() (4 cascades of 16x8x16
    probes, 32 rays, one (cascade, phase) slice of 512 probes a frame)
    and gi_rt=True, rt_rays=2 over a meshlet-granularity BVH: DDGI's rays
    and SSR's misses trace it; the world cache takes the lit surfels.
(b) `exact`: a triangle-granularity BVH (7,256 root-cut triangles: the
    dense triangle route), GIConfig(ao_mode="rtao") (4 rays a pixel at
    64x32), ScreenProbeConfig(trace_mode="march", rays=16, steps=6,
    history_mode="tile"), gi_rt=True, rt_rays=2.

Tolerances: those of tests/test_torch_frame_gi.py, for the same reasons
(the port rounds every f32 operation where chord_tpu's compiled frame
contracts FMAs, through three frames of temporal feedback; the port is fed
chord_tpu's jitted IGN noise, in the frame and in RTAO): stats exact;
images >= 99.9% of u8 values within 2 levels; gi_diffuse and gi_specular
within 1e-3 relative + 1e-4 absolute on >= 99% of values; the world cache
>= 99% of probe rows within 1e-4 relative; on `exact` the probe SH within
1e-4 relative + 1e-4 absolute on >= 99.5% of values, the sample counts
within 1e-6 relative (each march ray weighs 1, each BVH ray its hit), the
probe depths within 1e-6. The DDGI state: irradiance, distance moments
and SH within 1e-3 relative + 1e-4 absolute on >= 99.5% of values,
offsets within 1e-4 absolute on >= 99.5%, weights exact (the probe rays
are rotated by f32 cos / sin, libm against XLA, and a ray that grazes a
proxy sphere may hit on one side only).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from chord_tpu.asset.procedural import build_sponza_like as jax_sponza
from chord_tpu.ops import rt as jrt
from chord_tpu.ops.ddgi import DDGIConfig as JDDGIConfig
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
from chord_tpu_torch.ops import ddgi as ddgi_ops
from chord_tpu_torch.ops import gi as gi_ops
from chord_tpu_torch.ops import rt
from chord_tpu_torch.ops.ddgi import DDGIConfig
from chord_tpu_torch.ops.gi import GIConfig
from chord_tpu_torch.ops.screen_probe import ScreenProbeConfig
from chord_tpu_torch.renderer import (MeshletFrameConfig, MeshletRenderer,
                                      RendererConfig, render_sequence_meshlet)
from chord_tpu_torch.rhi.framebuffer import FrameHistory
from chord_tpu_torch.utils.camera import Camera
from test_torch_frame import CFG, N_FRAMES, PH, PW, H, W, _path
from test_torch_frame_gi import GI, _jitted_ign, _port_setup, _share_close

BASE = dict(draw_capacity=1024, gi=True, ssr=True, gi_rt=True, rt_rays=2)
MODES = {
    "ddgi": dict(mcfg=dict(gi_mode="ddgi"), gi={}, probe=None, ddgi=True,
                 granularity="meshlet"),
    "exact": dict(mcfg=dict(gi_mode="probe"), gi=dict(ao_mode="rtao"),
                  probe=dict(trace_mode="march", rays=16, steps=6,
                             history_mode="tile"), ddgi=False,
                  granularity="triangle"),
}


def _mcfgs(mode):
    m = MODES[mode]
    gi = dict(GI, **m["gi"])
    j = JMcfg(**BASE, **m["mcfg"], gi_cfg=JGIConfig(**gi),
              probe_cfg=m["probe"] and JProbeConfig(**m["probe"]),
              ddgi_cfg=JDDGIConfig() if m["ddgi"] else None)
    t = MeshletFrameConfig(**BASE, **m["mcfg"], gi_cfg=GIConfig(**gi),
                           probe_cfg=m["probe"] and
                           ScreenProbeConfig(**m["probe"]),
                           ddgi_cfg=DDGIConfig() if m["ddgi"] else None)
    return j, t


def _history(mode, device="cpu"):
    m = MODES[mode]
    return FrameHistory.empty(
        H, W, PH, PW, gi_cfg=GIConfig(**GI, **m["gi"]),
        probe_tile=0 if m["ddgi"] else 8,
        ddgi_cfg=DDGIConfig() if m["ddgi"] else None, device=device)


def _port_run(mode, pools, inst, views, mcfg, bvh):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mf, "interleaved_gradient_noise", _jitted_ign())
        mp.setattr(gi_ops, "interleaved_gradient_noise", _jitted_ign())
        return render_sequence_meshlet(pools, inst, views, _history(mode),
                                       RendererConfig(**CFG), mcfg, bvh=bvh,
                                       with_stats=True)


# the modes this file renders; `exact` (the slower) renders in
# tests/test_torch_frame_gi_modes_exact.py, so that a run that spreads
# test files over workers spreads the two modes
FILE_MODES = ("ddgi",)


@pytest.fixture(scope="module", params=FILE_MODES)
def runs(request):
    return make_runs(request.param)


def make_runs(mode):
    """Both packages' three frames of `mode`, each over its own BVH."""
    m = MODES[mode]
    jm, tm = _mcfgs(mode)
    jb = jax_sponza(detail=1)
    jcam = JCamera(width=W, height=H)
    jviews = [JView.from_uniform(u) for u in _path(jcam)]
    jpools, jinst = jax_pools(jb), jb.frame_instances(jcam)
    jbvh = jrt.build_scene_bvh(jpools, jinst, granularity=m["granularity"])
    j_imgs, j_hist, j_stats = jax_sequence(
        jpools, jinst, jax.tree.map(lambda *xs: jax.numpy.stack(xs), *jviews),
        JHistory.empty(H, W, post_h=PH, post_w=PW,
                       gi_cfg=JGIConfig(**GI, **m["gi"]),
                       probe_tile=0 if m["ddgi"] else 8,
                       ddgi_cfg=JDDGIConfig() if m["ddgi"] else None),
        config=JConfig(**CFG, interpret=True), mcfg=jm, bvh=jbvh,
        with_stats=True)
    j_hist = interop.history_from_numpy(
        {f: (v if f == "ddgi" else np.asarray(v))
         for f, v in vars(j_hist).items()}, device="cpu")

    pools, inst, views = _port_setup()
    bvh = rt.build_scene_bvh(pools, inst, granularity=m["granularity"])
    calls, dense, rays = rt.trace.calls, rt.trace.dense, rt.trace.rays
    imgs, hist, stats = _port_run(mode, pools, inst, views, tm, bvh)
    traced = (rt.trace.calls - calls, rt.trace.dense - dense,
              rt.trace.rays - rays)
    return dict(mode=mode, jax=(np.asarray(j_imgs), j_hist, j_stats, jbvh),
                torch=(imgs.numpy(), hist, stats, bvh), traced=traced,
                scene=(pools, inst, views), mcfg=tm)


def test_gi_modes_bvh_matches(runs):
    """Each side's BVH over its own pools: the same tree and leaves."""
    jbvh, bvh = runs["jax"][3], runs["torch"][3]
    for f in ("node_sphere", "node_count", "node_leaf"):
        np.testing.assert_array_equal(getattr(bvh, f).numpy(),
                                      np.asarray(getattr(jbvh, f)), f)
    for f in ("leaf_sphere", "tri_planes", "leaf_normal"):
        if getattr(jbvh, f) is None:
            assert getattr(bvh, f) is None, f
            continue
        np.testing.assert_allclose(getattr(bvh, f).numpy(),
                                   np.asarray(getattr(jbvh, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)


def test_gi_modes_stats_match_exactly(runs):
    j_stats, stats = runs["jax"][2], runs["torch"][2]
    assert set(stats) == set(j_stats)
    for k, v in stats.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(j_stats[k]),
                                      err_msg=k)


def test_gi_modes_images_match(runs):
    j_imgs, imgs = runs["jax"][0], runs["torch"][0]
    assert imgs.shape == j_imgs.shape == (N_FRAMES, PH, PW, 3)
    diff = np.abs(imgs.astype(np.int32) - j_imgs.astype(np.int32))
    assert (diff <= 2).mean() >= 0.999, (diff.max(), (diff > 2).mean())
    assert imgs[-1].std() > 5.0


def test_gi_modes_history_matches(runs):
    jh, hist = runs["jax"][1], runs["torch"][1]
    for name in ("gi_diffuse", "gi_specular", "probe_sh", "probe_depth"):
        assert getattr(hist, name).shape == getattr(jh, name).shape, name
    for name in ("gi_diffuse", "gi_specular"):
        share = _share_close(getattr(hist, name), getattr(jh, name), 1e-3,
                             1e-4)
        assert share >= 0.99, (name, share)
    assert float(hist.gi_specular.max()) > 0.0
    d = np.abs(hist.gi_cache.numpy() - jh.gi_cache.numpy())
    rows = (d <= 1e-4 * np.maximum(1.0, np.abs(jh.gi_cache.numpy()))).all(-1)
    assert rows.mean() >= 0.99, (rows.mean(), d.max())
    assert (hist.gi_cache[..., 27].numpy() > 0).any()
    if runs["mode"] == "exact":
        np.testing.assert_allclose(hist.probe_sh[..., 27].numpy(),
                                   jh.probe_sh[..., 27].numpy(), rtol=1e-6)
        assert float(hist.probe_sh[..., 27].max()) > 8.0
        assert _share_close(hist.probe_sh, jh.probe_sh, 1e-4, 1e-4) >= 0.995
        assert _share_close(hist.probe_depth, jh.probe_depth, 0,
                            1e-6) >= 0.99
        assert float(hist.gi_diffuse.max()) > 0.0
    for f in ddgi_ops.DDGIState._fields:
        assert getattr(hist.ddgi, f).shape == getattr(jh.ddgi, f).shape, f
    if runs["mode"] == "ddgi":
        for f in ("irr", "dist", "sh"):
            share = _share_close(getattr(hist.ddgi, f), getattr(jh.ddgi, f),
                                 1e-3, 1e-4)
            assert share >= 0.995, (f, share)
        assert _share_close(hist.ddgi.offset, jh.ddgi.offset, 0,
                            1e-4) >= 0.995
        np.testing.assert_array_equal(hist.ddgi.weight.numpy(),
                                      jh.ddgi.weight.numpy())
        # three (cascade, phase) slices of 512 probes traced once
        assert int((hist.ddgi.weight > 0).sum()) == 3 * 512
        assert float(hist.ddgi.irr.max()) > 0.0


def test_gi_modes_trace_their_rays(runs):
    """rt.trace calls a frame: on `ddgi` DDGI's update and SSR's misses
    (2, dense over the meshlet spheres); on `exact` RTAO's 4 rays, the
    probe rays and SSR's misses (6, dense over the 7,256 triangles)."""
    calls, dense, rays = runs["traced"]
    per = 2 if runs["mode"] == "ddgi" else 6
    assert calls == dense == per * N_FRAMES
    if runs["mode"] == "ddgi":
        assert rays == N_FRAMES * (512 * 32 + (H // 8) * (W // 8))
    else:
        assert rays == N_FRAMES * (4 * (H // 2) * (W // 2) +
                                   2 * (H // 8) * (W // 8) +
                                   (H // 8) * (W // 8))


def test_gi_modes_renderer(runs):
    """MeshletRenderer: on `ddgi` it builds the BVH itself with
    gi_rt=False (DDGI needs it) at the config's granularity and renders
    what the sequence renders with that BVH; on `exact` it builds the
    triangle BVH and renders what the sequence rendered, and RTAO without
    a BVH (gi_rt=False: none is built) renders as SSAO, as chord_tpu
    does."""
    pools, inst, views = runs["scene"]
    granularity = MODES[runs["mode"]]["granularity"]

    def render(mcfg):
        r = MeshletRenderer(RendererConfig(**CFG),
                            mcfg._replace(rt_granularity=granularity))
        cam = Camera(width=W, height=H)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mf, "interleaved_gradient_noise", _jitted_ign())
            mp.setattr(gi_ops, "interleaved_gradient_noise", _jitted_ign())
            return r, [r.render(pools, inst, u)[0].numpy()
                       for u in _path(cam)]

    if runs["mode"] == "exact":
        r, imgs = render(runs["mcfg"])
        assert r._bvh.tri_planes is not None
        np.testing.assert_array_equal(np.stack(imgs), runs["torch"][0])
    mcfg = runs["mcfg"]._replace(gi_rt=False)
    r, imgs = render(mcfg)
    if runs["mode"] == "ddgi":
        assert r._bvh is not None
        assert torch.equal(r._bvh.node_sphere, runs["torch"][3].node_sphere)
        ref = _port_run("ddgi", pools, inst, views, mcfg, r._bvh)[0]
    else:
        assert r._bvh is None
        ref = _port_run("exact", pools, inst, views, mcfg._replace(
            gi_cfg=mcfg.gi_cfg._replace(ao_mode="ssao")), None)[0]
    np.testing.assert_array_equal(np.stack(imgs), ref.numpy())
    assert dataclasses.is_dataclass(r.history)
    if runs["mode"] == "ddgi":
        assert r.history.ddgi.weight.shape == (4, 2048)
        with pytest.raises(AssertionError, match="BVH"):
            render_sequence_meshlet(pools, inst, views, _history("ddgi"),
                                    RendererConfig(**CFG), mcfg)
