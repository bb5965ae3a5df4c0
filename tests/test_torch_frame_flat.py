"""The ported flat DeferredRenderer frame against chord_tpu's, end to end.

Three frames of DeferredRenderer.render at 128x64 (bloom, gather-mode TSR
at render size, auto exposure) on the tiny atrium, with a jittered moving
camera, for three raster configs: the flat K1 raster, the sub-tile raster
(RendererConfig(subtiles=True), K8) and the brick raster (the
r.raster.bricks cvar, K7). Both packages render chord_tpu's flat pools
(carried into the port by interop.scene_pools_from_numpy); chord_tpu runs
its Pallas kernels in interpret mode, the port its plain kernel versions.

Tolerances: the per-frame stats are integers and must match exactly. The
images are u8 after the ACES tonemap: XLA's CPU FMA contraction and f32
rounding differences (barycentric sums, the bf16 history's bilinear
weights, pow/log2 ulps) move a pixel by at most a level or two, so >=
99.9% of channel values must lie within 2 levels. History depth must
match to 1e-6 on >= 99.9% of pixels (a pixel on an edge to within an ulp
may take the other triangle) and the TSR colour to 2e-3 relative on >=
99.9% of values.
"""

import jax
import numpy as np
import pytest
import torch

from chord_tpu.asset.procedural import build_sponza_like as jax_sponza
from chord_tpu.renderer.deferred import DeferredRenderer as JRenderer
from chord_tpu.renderer.deferred import RendererConfig as JConfig
from chord_tpu.utils.camera import Camera as JCamera
from chord_tpu.utils.cvar import cvars as jcvars

from chord_tpu_torch import interop
from chord_tpu_torch.asset.procedural import build_sponza_like
from chord_tpu_torch.renderer import DeferredRenderer, RendererConfig
from chord_tpu_torch.renderer.deferred import DeviceView, render_frame_flat
from chord_tpu_torch.rhi.framebuffer import FrameHistory
from chord_tpu_torch.utils.camera import Camera
from chord_tpu_torch.utils.cvar import cvars

N_FRAMES = 3
W, H = 128, 64
CFG = dict(width=W, height=H, pair_capacity=4096, big_capacity=128,
           enable_bloom=True, enable_tsr=True)
CASES = {"flat": dict(), "subtiles": dict(subtiles=True),
         "bricks": dict()}


def _np(obj):
    return {k: np.asarray(v) for k, v in vars(obj).items() if v is not None}


def _path(cam):
    for i in range(N_FRAMES):
        cam.position = np.array([-15.0 + 0.5 * i, 4.0, 0.3 * i])
        cam.look_at(np.array([10.0, 2.0, 0.0]))
        yield cam.view_uniform(i, jitter=True)


def _render(case):
    """-> per frame (chord_tpu (image, stats), port (image, stats)), and
    both final histories."""
    jb = jax_sponza(detail=1)
    jpools = jb.build_pools()
    tpools = interop.scene_pools_from_numpy(_np(jpools), device="cpu")
    bricks = case == "bricks"
    keep = [(c, c.get("r.raster.bricks")) for c in (jcvars, cvars)]
    jcvars.set("r.raster.bricks", bricks)
    cvars.set("r.raster.bricks", bricks)
    try:
        jr = JRenderer(JConfig(**CFG, **CASES[case], interpret=True))
        tr = DeferredRenderer(RendererConfig(**CFG, **CASES[case]))
        jcam, cam = JCamera(width=W, height=H), Camera(width=W, height=H)
        frames = []
        for ju, u in zip(_path(jcam), _path(cam)):
            jinst = jb.frame_instances(jcam)
            tinst = interop.instances_from_numpy(_np(jinst), device="cpu")
            jimg, jst = jr.render(jpools, jinst, ju)
            img, st = tr.render(tpools, tinst, u)
            frames.append(((np.asarray(jimg), jst), (img.numpy(), st)))
        assert tr.config.raster_config().bricks == bricks
        assert tr.config.raster_config().tile_h == (192 if bricks else 216)
    finally:
        for c, v in keep:
            c.set("r.raster.bricks", v)
    return frames, jr.history, tr.history


@pytest.fixture(scope="module", params=list(CASES))
def run(request):
    return request.param, _render(request.param)


def test_flat_frame_stats_match_exactly(run):
    case, (frames, _, _) = run
    for (_, jst), (_, st) in frames:
        assert set(st) == set(jst) == {"bin_overflow", "drawn_tris",
                                       "binned_pairs", "visible_objects"}
        for k, v in st.items():
            assert v.dtype == torch.int32, k
            assert int(v) == int(jst[k]), (case, k)
        assert int(st["bin_overflow"]) == 0 and int(st["drawn_tris"]) > 500


def test_flat_frame_images_match(run):
    case, (frames, _, _) = run
    for (jimg, _), (img, _) in frames:
        assert img.shape == jimg.shape == (H, W, 3)
        diff = np.abs(img.astype(np.int32) - jimg.astype(np.int32))
        assert (diff <= 2).mean() >= 0.999, (case, diff.max())
    assert frames[-1][1][0].std() > 5.0      # not a constant image


def test_flat_frame_history_matches(run):
    case, (_, jh, th) = run
    assert int(th.frame_count) == int(jh.frame_count) == N_FRAMES
    dd = np.abs(th.depth.numpy() - np.asarray(jh.depth))
    assert (dd <= 1e-6).mean() >= 0.999, dd.max()
    np.testing.assert_allclose(th.exposure.numpy(), np.asarray(jh.exposure),
                               rtol=1e-4)
    tc, jtc = th.tsr_color.numpy(), np.asarray(jh.tsr_color)
    close = np.abs(tc - jtc) <= 2e-3 * np.maximum(np.abs(jtc), 1e-2)
    assert close.mean() >= 0.999, np.abs(tc - jtc).max()


def test_build_pools_matches():
    """The port's own SceneBuilder.build_pools equals chord_tpu's."""
    jpools = jax_sponza(detail=1).build_pools()
    pools = build_sponza_like(detail=1).build_pools(device="cpu")
    for k, v in _np(jpools).items():
        np.testing.assert_array_equal(getattr(pools, k).numpy(), v,
                                      err_msg=k)
    assert pools.num_triangles % 128 == 0 and not pools.tri_valid[-1]


def test_render_frame_flat_refuses_axis_name():
    """torch has no named mesh axis: the strip frame takes a process group
    (`group=`, tests/test_torch_sharded.py), and chord_tpu's `axis_name`
    is no argument of the port's frame."""
    pools = build_sponza_like(detail=1).build_pools(device="cpu")
    cam = Camera(width=W, height=H)
    cam.position = np.array([-15.0, 4.0, 0.0])
    cam.look_at(np.array([10.0, 2.0, 0.0]))
    b = build_sponza_like(detail=1)
    with pytest.raises(TypeError, match="axis_name"):
        render_frame_flat(pools, b.frame_instances(cam, device="cpu"),
                          DeviceView.from_uniform(cam.view_uniform(0),
                                                  device="cpu"),
                          FrameHistory.empty(H, W, device="cpu"),
                          RendererConfig(**CFG), axis_name="x")
