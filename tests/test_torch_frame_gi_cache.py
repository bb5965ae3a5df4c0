"""The ported GI frame in world-cache mode (gi_mode="cache") against
chord_tpu, end to end.

tests/test_torch_frame_gi.py's frame (tiny atrium, render 128x64 -> post
192x96, tile TSR, bloom, GIConfig(cascades=2, probe_dim=8), SSR) with
gi_mode="cache": the diffuse indirect samples the world SH cache
(gi.sample) and the frame's lit surfels are injected into it after
lighting (gi.inject), with no screen probes. Three frames of
render_sequence_meshlet; chord_tpu's history comes back through
interop.history_from_numpy.

Tolerances, and why, as in tests/test_torch_frame_gi.py: stats exact;
>= 99.9% of u8 image values within 2 levels; gi_specular within 1e-3
relative + 1e-4 absolute on >= 99% of values; the world cache by probe
rows, >= 99% of rows within 1e-4 relative (an FMA in chord_tpu's compiled
frame can move a surfel one cell over, which moves a whole row). The
jitted interleaved-gradient noise that picks the GGX specular direction is
fed to the port.
"""

import jax
import numpy as np
import pytest

from chord_tpu.asset.procedural import build_sponza_like as jax_sponza
from chord_tpu.ops.gi import GIConfig as JGIConfig
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
from chord_tpu_torch.ops.gi import GIConfig
from chord_tpu_torch.renderer import (MeshletFrameConfig, RendererConfig,
                                      render_sequence_meshlet)
from chord_tpu_torch.rhi.framebuffer import FrameHistory
from test_torch_frame import CFG, N_FRAMES, PH, PW, H, W, _path
from test_torch_frame_gi import GI, _jitted_ign, _port_setup, _share_close

MCFG = dict(draw_capacity=1024, gi=True, gi_mode="cache", ssr=True)


@pytest.fixture(scope="module")
def runs():
    jb = jax_sponza(detail=1)
    jcam = JCamera(width=W, height=H)
    jviews = [JView.from_uniform(u) for u in _path(jcam)]
    j_imgs, j_hist, j_stats = jax_sequence(
        jax_pools(jb), jb.frame_instances(jcam),
        jax.tree.map(lambda *xs: jax.numpy.stack(xs), *jviews),
        JHistory.empty(H, W, post_h=PH, post_w=PW, gi_cfg=JGIConfig(**GI)),
        config=JConfig(**CFG, interpret=True),
        mcfg=JMcfg(**MCFG, gi_cfg=JGIConfig(**GI)), with_stats=True)
    j_hist = interop.history_from_numpy(
        {f: np.asarray(v) for f, v in vars(j_hist).items()
         if f != "ddgi"}, device="cpu")

    pools, inst, views = _port_setup()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mf, "interleaved_gradient_noise", _jitted_ign())
        imgs, hist, stats = render_sequence_meshlet(
            pools, inst, views,
            FrameHistory.empty(H, W, PH, PW, gi_cfg=GIConfig(**GI),
                               device="cpu"),
            RendererConfig(**CFG),
            MeshletFrameConfig(**MCFG, gi_cfg=GIConfig(**GI)),
            with_stats=True)
    return dict(jax=(np.asarray(j_imgs), j_hist, j_stats),
                torch=(imgs.numpy(), hist, stats))


def test_cache_frame_stats_match_exactly(runs):
    _, _, j_stats = runs["jax"]
    _, _, stats = runs["torch"]
    assert set(stats) == set(j_stats)
    for k, v in stats.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(j_stats[k]),
                                      err_msg=k)
    for k in ("bin_overflow", "draw_overflow", "active_overflow"):
        assert int(stats[k].max()) == 0, k


def test_cache_frame_images_match(runs):
    j_imgs, _, _ = runs["jax"]
    imgs, _, _ = runs["torch"]
    assert imgs.shape == j_imgs.shape == (N_FRAMES, PH, PW, 3)
    diff = np.abs(imgs.astype(np.int32) - j_imgs.astype(np.int32))
    assert (diff <= 2).mean() >= 0.999, (diff.max(), (diff > 2).mean())
    assert imgs[-1].std() > 5.0


def test_cache_frame_history_matches(runs):
    """The world cache took the lit surfels (by rows, as said above), the
    specular history matches, and the probe fields stay the placeholders
    a cache-mode history carries."""
    _, jh, _ = runs["jax"]
    _, hist, _ = runs["torch"]
    assert int(hist.frame_count) == int(jh.frame_count) == N_FRAMES
    assert hist.gi_cache.shape == jh.gi_cache.shape == (2, 512, 28)
    d = np.abs(hist.gi_cache.numpy() - jh.gi_cache.numpy())
    rows = (d <= 1e-4 * np.maximum(1.0, np.abs(jh.gi_cache.numpy()))).all(-1)
    assert rows.mean() >= 0.99, (rows.mean(), d.max())
    assert (hist.gi_cache[..., 27].numpy() > 0).any()
    share = _share_close(hist.gi_specular, jh.gi_specular, 1e-3, 1e-4)
    assert share >= 0.99, share
    for name in ("probe_sh", "probe_depth", "gi_diffuse"):
        assert getattr(hist, name).shape == getattr(jh, name).shape, name
        assert not getattr(hist, name).any(), name
