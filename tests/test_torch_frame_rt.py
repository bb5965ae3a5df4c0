"""The ported GI frame with the BVH rays (gi_rt) against chord_tpu.

tests/test_torch_frame_gi.py's frame (tiny atrium, render 128x64 -> post
192x96, tile TSR, bloom, screen-probe GI with ScreenProbeConfig(rays=16,
steps=6, history_mode="tile"), GIConfig(cascades=2, probe_dim=8), SSR)
with bench.py's rays on: gi_rt=True, rt_rays=2. Each package builds an
object-granularity BVH (one sphere per instance, as bench.py:221-233)
from its own pools and instance table, and passes it as `bvh`: each frame
traces 2 rays a probe (16x8 probes) beside the screen taps, and one ray a
1/8-res pixel where SSR missed. Three frames of render_sequence_meshlet.

Tolerances: those of tests/test_torch_frame_gi.py, for the same reasons
(the port rounds every f32 operation where chord_tpu's compiled frame
contracts FMAs, through three frames of temporal feedback; the port is
fed chord_tpu's jitted IGN noise): stats exact; images >= 99.9% of u8
values within 2 levels; probe_sh within 1e-4 relative + 1e-4 absolute on
>= 99.5% of values, its sample counts within 1e-6 relative, probe depths
within 1e-6; gi_diffuse and gi_specular within 1e-3 relative + 1e-4
absolute on >= 99% of values; the world cache >= 99% of probe rows within
1e-4 relative.
"""

import numpy as np
import pytest
import torch

from chord_tpu.asset.procedural import build_sponza_like as jax_sponza
from chord_tpu.ops import rt as jrt
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

import jax

import chord_tpu_torch.renderer.meshlet_frame as mf
from chord_tpu_torch import interop
from chord_tpu_torch.ops import rt
from chord_tpu_torch.ops.gi import GIConfig
from chord_tpu_torch.renderer import (MeshletRenderer, RendererConfig,
                                      render_sequence_meshlet)
from chord_tpu_torch.rhi.framebuffer import FrameHistory
from chord_tpu_torch.utils.camera import Camera
from test_torch_frame import CFG, N_FRAMES, PH, PW, H, W, _path
from test_torch_frame_gi import (GI, MCFG, PROBE, _jitted_ign, _port_mcfg,
                                 _port_setup, _share_close)

RT = dict(gi_rt=True, rt_rays=2)


def _port_run(pools, inst, views, mcfg, bvh):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mf, "interleaved_gradient_noise", _jitted_ign())
        return render_sequence_meshlet(
            pools, inst, views,
            FrameHistory.empty(H, W, PH, PW, gi_cfg=GIConfig(**GI),
                               probe_tile=8, device="cpu"),
            RendererConfig(**CFG), mcfg, bvh=bvh, with_stats=True)


@pytest.fixture(scope="module")
def runs():
    jb = jax_sponza(detail=1)
    jcam = JCamera(width=W, height=H)
    jviews = [JView.from_uniform(u) for u in _path(jcam)]
    jpools, jinst = jax_pools(jb), jb.frame_instances(jcam)
    jbvh = jrt.build_scene_bvh(jpools, jinst, granularity="object")
    j_imgs, j_hist, j_stats = jax_sequence(
        jpools, jinst, jax.tree.map(lambda *xs: jax.numpy.stack(xs), *jviews),
        JHistory.empty(H, W, post_h=PH, post_w=PW, gi_cfg=JGIConfig(**GI),
                       probe_tile=8),
        config=JConfig(**CFG, interpret=True),
        mcfg=JMcfg(**MCFG, **RT, gi_cfg=JGIConfig(**GI),
                   probe_cfg=JProbeConfig(**PROBE)),
        bvh=jbvh, with_stats=True)
    j_hist = interop.history_from_numpy(
        {f: np.asarray(v) for f, v in vars(j_hist).items()
         if f != "ddgi"}, device="cpu")

    pools, inst, views = _port_setup()
    bvh = rt.build_scene_bvh(pools, inst, granularity="object")
    calls = rt.trace.calls
    imgs, hist, stats = _port_run(pools, inst, views,
                                  _port_mcfg()._replace(**RT), bvh)
    traced = rt.trace.calls - calls
    no_rt = _port_run(pools, inst, views, _port_mcfg(), None)
    return dict(jax=(np.asarray(j_imgs), j_hist, j_stats, jbvh),
                torch=(imgs.numpy(), hist, stats, bvh), traced=traced,
                no_rt=no_rt[1], scene=(pools, inst))


def test_rt_frame_bvh_matches(runs):
    """Each side's object BVH over its own pools: the same tree."""
    jbvh, bvh = runs["jax"][3], runs["torch"][3]
    assert bvh.node_sphere.shape[0] > 1
    for f in ("node_sphere", "node_count", "node_leaf", "leaf_sphere"):
        np.testing.assert_array_equal(getattr(bvh, f).numpy(),
                                      np.asarray(getattr(jbvh, f)), f)


def test_rt_frame_stats_match_exactly(runs):
    j_stats, stats = runs["jax"][2], runs["torch"][2]
    assert set(stats) == set(j_stats)
    for k, v in stats.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(j_stats[k]),
                                      err_msg=k)


def test_rt_frame_images_match(runs):
    j_imgs, imgs = runs["jax"][0], runs["torch"][0]
    assert imgs.shape == j_imgs.shape == (N_FRAMES, PH, PW, 3)
    diff = np.abs(imgs.astype(np.int32) - j_imgs.astype(np.int32))
    assert (diff <= 2).mean() >= 0.999, (diff.max(), (diff > 2).mean())
    assert imgs[-1].std() > 5.0


def test_rt_frame_history_matches(runs):
    jh, hist = runs["jax"][1], runs["torch"][1]
    np.testing.assert_allclose(hist.probe_sh[..., 27].numpy(),
                               jh.probe_sh[..., 27].numpy(), rtol=1e-6)
    assert _share_close(hist.probe_sh, jh.probe_sh, 1e-4, 1e-4) >= 0.995
    assert _share_close(hist.probe_depth, jh.probe_depth, 0, 1e-6) >= 0.99
    for name in ("gi_diffuse", "gi_specular"):
        share = _share_close(getattr(hist, name), getattr(jh, name), 1e-3,
                             1e-4)
        assert share >= 0.99, (name, share)
    d = np.abs(hist.gi_cache.numpy() - jh.gi_cache.numpy())
    rows = (d <= 1e-4 * np.maximum(1.0, np.abs(jh.gi_cache.numpy()))).all(-1)
    assert rows.mean() >= 0.99, (rows.mean(), d.max())


def test_rt_frame_traces_its_rays(runs):
    """Two rt.trace calls a frame (the probe rays and SSR's misses), and
    the rays change the probes: their SH differs from the same frames with
    gi_rt=False, and the sample counts grew by the rays' hits."""
    assert runs["traced"] == 2 * N_FRAMES
    hist, no_rt = runs["torch"][1], runs["no_rt"]
    d = (hist.probe_sh[..., :27] - no_rt.probe_sh[..., :27]).abs()
    assert float(d.max()) > 1e-3
    assert float((hist.probe_sh[..., 27] - no_rt.probe_sh[..., 27]).max()) \
        > 0.0


def test_rt_renderer_matches_sequence(runs):
    """MeshletRenderer with gi_rt and rt_granularity="object" builds the
    same BVH itself (once) and renders what the sequence rendered."""
    pools, inst = runs["scene"]
    imgs = runs["torch"][0]
    r = MeshletRenderer(RendererConfig(**CFG),
                        _port_mcfg()._replace(**RT, rt_granularity="object"))
    cam = Camera(width=W, height=H)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mf, "interleaved_gradient_noise", _jitted_ign())
        for i, u in enumerate(_path(cam)):
            img, _ = r.render(pools, inst, u)
            np.testing.assert_array_equal(img.numpy(), imgs[i])
            if i == 0:
                first = r._bvh
    assert r._bvh is first
    assert torch.equal(r._bvh.node_sphere, runs["torch"][3].node_sphere)
