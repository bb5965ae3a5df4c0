"""The pipelined shadow split (ShadowConfig(pipelined=True)) against
chord_tpu.

The frame exports the PCSS's and the temporal blend's inputs
(stats["shadow_split"]) and lights with last frame's mask; after it,
shadow_service_step refreshes cascade fc % N, evaluates PCSS, expands the
phase and blends, and its cascades, matrices and mask re-enter the next
frame through the history (chord_tpu meshlet_frame.py:704-800, :1299-1442).
Three frames at render 128x64 -> post 192x96 (tile TSR, bloom) on the tiny
atrium with 2 cascades of 128², through render_sequence_split in both
packages; chord_tpu runs its Pallas kernels in interpret mode and its PCSS
through evaluate_shadow on the CPU. The service step is also held alone:
both packages' services on chord_tpu's own split dict and history of frame
1 (carried by interop), so a scrolled refresh of cascade 1 is compared on
identical inputs.

Tolerances (test_torch_frame_shadow.py gives the reasons): images >= 99.9%
of u8 values within 2 levels; cascade depth within 1.8e-4 (the existing
bound: each package's mesh-shader setup rounds differently) on >= 99.9% of
texels and coverage equal on >= 99.9%; the mask >= 99% of texels within
1e-5 and every texel within one PCF sample (1/6) + 1e-4; matrices 1e-5
relative.
"""

import jax
import numpy as np
import pytest

from chord_tpu.asset.procedural import build_sponza_like as jax_sponza
from chord_tpu.ops.shadow import ShadowConfig as JShadowConfig
from chord_tpu.renderer import meshlet_frame as jmf
from chord_tpu.renderer.deferred import DeviceView as JView
from chord_tpu.renderer.deferred import RendererConfig as JConfig
from chord_tpu.rhi.framebuffer import FrameHistory as JHistory
from chord_tpu.rhi.meshlet_scene import build_meshlet_pools as jax_pools
from chord_tpu.utils.camera import Camera as JCamera

import torch

import chord_tpu_torch.renderer.meshlet_frame as mf
from chord_tpu_torch import interop
from chord_tpu_torch.asset.procedural import build_sponza_like
from chord_tpu_torch.ops import kernels
from chord_tpu_torch.ops.shadow import ShadowConfig
from chord_tpu_torch.renderer import (DeviceView, MeshletFrameConfig,
                                      MeshletRenderer, RendererConfig,
                                      render_sequence_meshlet,
                                      render_sequence_split)
from chord_tpu_torch.rhi.framebuffer import FrameHistory
from chord_tpu_torch.rhi.meshlet_scene import build_meshlet_pools
from chord_tpu_torch.utils.camera import Camera

N_FRAMES = 3
W, H, PW, PH = 128, 64, 192, 96
CFG = dict(width=W, height=H, post_width=PW, post_height=PH,
           pair_capacity=4096, big_capacity=128, enable_bloom=True,
           enable_tsr=True, tsr_mode="tile")
SHADOW = dict(cascade_count=2, resolution=128, pipelined=True)
MCFG = dict(draw_capacity=1024, shadows=True)
HIST = dict(shadow_div=4, shadow_cascades=2, shadow_res=128, shadow_phase=2)


def _path(cam):
    for i in range(N_FRAMES):
        cam.position = np.array([-15.0 + 0.5 * i, 4.0, 0.3 * i])
        cam.look_at(np.array([10.0, 2.0, 0.0]))
        yield cam.view_uniform(i, jitter=True)


def _np(x):
    return {f: np.asarray(v) for f, v in vars(x).items()
            if v is not None and f != "ddgi"}


@pytest.fixture(scope="module")
def runs():
    scfg = JShadowConfig(**SHADOW)
    config = JConfig(**CFG, interpret=True)
    mcfg = jmf.MeshletFrameConfig(**MCFG, shadow_cfg=scfg)
    jb = jax_sponza(detail=1)
    jcam = JCamera(width=W, height=H)
    jviews = [JView.from_uniform(u, shadow_cfg=scfg) for u in _path(jcam)]
    jpools, jinst = jax_pools(jb), jb.frame_instances(jcam)
    j_imgs, j_hist = jmf.render_sequence_split(
        jpools, jinst, jax.tree.map(lambda *xs: jax.numpy.stack(xs), *jviews),
        JHistory.empty(H, W, post_h=PH, post_w=PW, **HIST), config, mcfg)
    # frame 1 again, one dispatch at a time through the same (cached)
    # jitted pair, for the service's own inputs and outputs
    frame_fn, svc_fn = jmf._split_sequence_fns(config, mcfg)
    h = JHistory.empty(H, W, post_h=PH, post_w=PW, **HIST)
    for i in range(2):
        _, h, st = frame_fn(jpools, jinst, jviews[i], h, None)
        out = svc_fn(jpools, jinst, jviews[i], h, st["shadow_split"])
        if i == 0:
            h = h.replace(shadow_maps=out[0], shadow_mats=out[1],
                          shadow_mask=out[3])
    service = dict(view=jviews[1], hist=h, sp=st["shadow_split"], out=out)

    b = build_sponza_like(detail=1)
    cam = Camera(width=W, height=H)
    views = DeviceView.stack([
        DeviceView.from_uniform(u, shadow_cfg=ShadowConfig(**SHADOW),
                                device="cpu") for u in _path(cam)])
    pools = build_meshlet_pools(b, device="cpu")
    inst = b.frame_instances(cam, device="cpu")
    with kernels.capture_inputs() as captured:
        imgs, hist, stats = render_sequence_split(
            pools, inst, views,
            FrameHistory.empty(H, W, PH, PW, **HIST, device="cpu"),
            RendererConfig(**CFG), MeshletFrameConfig(
                **MCFG, shadow_cfg=ShadowConfig(**SHADOW)), with_stats=True)
    return dict(jax=(np.asarray(j_imgs), j_hist), service=service,
                torch=(imgs.numpy(), hist, stats), scene=(pools, inst),
                calls={k: len(v) for k, v in captured.items()})


def _close_maps(got, ref):
    assert got.shape == ref.shape
    d = np.abs(got - ref)
    assert ((got > 0) == (ref > 0)).mean() >= 0.999
    assert (d <= 1.8e-4).mean() >= 0.999, d.max()


def _close_mask(got, ref):
    assert got.shape == ref.shape
    d = np.abs(got - ref)
    assert (d <= 1e-5).mean() >= 0.99 and d.max() <= 1 / 6 + 1e-4, d.max()


def test_service_step_matches_on_chord_tpu_inputs(runs):
    """Both services on chord_tpu's frame-1 split dict and history: the
    refreshed cascades, their matrices, the PCSS grid and the blended
    mask."""
    s = runs["service"]
    pools, inst = runs["scene"]
    sp = {k: torch.from_numpy(np.array(v)) for k, v in s["sp"].items()
          if k != "fc"}
    sp["fc"] = int(s["sp"]["fc"])
    hist = interop.history_from_numpy(_np(s["hist"]), device="cpu")
    view = interop.view_from_numpy(_np(s["view"]), device="cpu")
    maps, mats, q, mask = mf.shadow_service_step(
        pools, inst, view, hist, sp, config=RendererConfig(**CFG),
        mcfg=MeshletFrameConfig(**MCFG, shadow_cfg=ShadowConfig(**SHADOW)))
    j_maps, j_mats, j_q, j_mask = (np.asarray(x) for x in s["out"])
    _close_maps(maps.numpy(), j_maps)
    np.testing.assert_allclose(mats.numpy(), j_mats, rtol=1e-5, atol=1e-6)
    assert q.shape == j_q.shape == (H // 8, W // 8)
    _close_mask(q.numpy(), j_q)
    _close_mask(mask.numpy(), j_mask)
    assert (maps.numpy() > 0).mean(axis=(1, 2)).min() > 0.01


def test_split_sequence_images_match(runs):
    j_imgs, _ = runs["jax"]
    imgs, _, _ = runs["torch"]
    assert imgs.shape == j_imgs.shape == (N_FRAMES, PH, PW, 3)
    diff = np.abs(imgs.astype(np.int32) - j_imgs.astype(np.int32))
    assert (diff <= 2).mean() >= 0.999, (diff.max(), (diff > 2).mean())
    assert imgs[-1].std() > 5.0


def test_split_sequence_history_matches(runs):
    _, j_hist = runs["jax"]
    _, hist, _ = runs["torch"]
    assert int(hist.frame_count) == int(j_hist.frame_count) == N_FRAMES
    _close_maps(hist.shadow_maps.numpy(), np.asarray(j_hist.shadow_maps))
    _close_mask(hist.shadow_mask.numpy(), np.asarray(j_hist.shadow_mask))
    np.testing.assert_allclose(hist.shadow_mats.numpy(),
                               np.asarray(j_hist.shadow_mats), rtol=1e-5,
                               atol=1e-6)


def test_split_runs_one_refresh_and_one_pcss_a_frame(runs):
    """The service refreshes one cascade and evaluates once a frame, its
    overflows join the per-frame stats, and the mask is lit and shadowed."""
    _, hist, stats = runs["torch"]
    assert runs["calls"]["pcss"] == N_FRAMES
    # per frame: the two occlusion phases and the cascade's depth pass
    assert runs["calls"]["raster"] == 3 * N_FRAMES
    for k in ("shadow_draw_overflow", "shadow_bin_overflow", "bin_overflow"):
        assert stats[k].shape == (N_FRAMES,) and int(stats[k].max()) == 0, k
    m = hist.shadow_mask.numpy()
    assert (m < 0.5).any() and (m > 0.99).any()


def test_split_is_accepted_and_the_scan_runner_refuses_it(runs):
    """check_slice refuses no flag; render_sequence_meshlet refuses a
    pipelined config as chord_tpu does; auto (None) resolves inline on
    either device, and True splits on either."""
    pools, inst = runs["scene"]
    scfg = ShadowConfig(**SHADOW)
    mcfg = MeshletFrameConfig(**MCFG, shadow_cfg=scfg)
    mf.check_slice(RendererConfig(**CFG), mcfg)
    cam = Camera(width=W, height=H)
    views = DeviceView.stack([DeviceView.from_uniform(
        u, shadow_cfg=scfg, device="cpu") for u in _path(cam)])
    with pytest.raises(ValueError, match="render_sequence_split"):
        render_sequence_meshlet(
            pools, inst, views,
            FrameHistory.empty(H, W, PH, PW, **HIST, device="cpu"),
            RendererConfig(**CFG), mcfg)
    for dev in ("cpu", "cuda"):
        assert mf.shadow_pipelined(scfg, dev)
        assert not mf.shadow_pipelined(ShadowConfig(), dev)
        assert not mf.shadow_pipelined(scfg._replace(pipelined=False), dev)
    assert mf.shadow_pipelined(ShadowConfig(eval_kernel=False), "cuda")
    assert not mf.shadow_pipelined(ShadowConfig(eval_kernel=False), "cpu")


def test_split_renderer_resolves_after_every_frame(runs):
    """MeshletRenderer runs the service after each warm-up frame and after
    the presented one: the first image already reads a blended mask, and
    its history matches render_sequence_split's over the same frames."""
    pools, inst = runs["scene"]
    r = MeshletRenderer(RendererConfig(**CFG), MeshletFrameConfig(
        **MCFG, shadow_cfg=ShadowConfig(**SHADOW)))
    cam = Camera(width=W, height=H)
    u = next(_path(cam))
    img, stats = r.render(pools, inst, u)
    assert "shadow_split" in stats
    assert int(r.history.frame_count) == SHADOW["cascade_count"]
    views = DeviceView.stack([DeviceView.from_uniform(
        u, shadow_cfg=ShadowConfig(**SHADOW), device="cpu")] * 2)
    imgs, hist = render_sequence_split(
        pools, inst, views,
        FrameHistory.empty(H, W, PH, PW, **HIST, device="cpu"),
        RendererConfig(**CFG), MeshletFrameConfig(
            **MCFG, shadow_cfg=ShadowConfig(**SHADOW)))
    np.testing.assert_array_equal(img.numpy(), imgs[-1].numpy())
    for f in ("shadow_maps", "shadow_mats", "shadow_mask"):
        np.testing.assert_array_equal(getattr(r.history, f).numpy(),
                                      getattr(hist, f).numpy(), f)
