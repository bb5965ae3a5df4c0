"""The port's strip-parallel frame (chord_tpu_torch/parallel/sharded.py)
against chord_tpu's (chord_tpu/parallel/sharded.py), on the flat path.

The strip views: `_strip_matrix` exactly, and every DeviceView leaf of
`strip_device_views` within 1e-7, for 1, 2 and 4 strips. The flat frame:
chord_tpu's ShardedRenderer on 2 of the 8 virtual CPU devices
(tests/conftest.py) against the port's on 2 gloo ranks on the CPU
(spawn_strips, device="cpu"), both on chord_tpu's flat pools of the tiny
atrium at 128x64 (no bloom, no TSR), two frames so the exposure adapts
from history. Tolerances, as tests/test_torch_frame_flat.py states them:
the summed stats are integers and must be equal; >= 99.9% of u8 channel
values within 2 levels (XLA's FMA contraction and f32 ulps move a pixel
a level or two); the adapted exposure, the same on every rank, within
1e-6 of chord_tpu's.
"""

import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from chord_tpu.asset.procedural import build_sponza_like as jax_sponza
from chord_tpu.ops.shadow import ShadowConfig as JShadowConfig
from chord_tpu.parallel import sharded as jsharded
from chord_tpu.renderer.deferred import RendererConfig as JConfig
from chord_tpu.utils.camera import Camera as JCamera

from chord_tpu_torch.asset.procedural import build_sponza_like
from chord_tpu_torch.ops.shadow import ShadowConfig
from chord_tpu_torch.parallel import sharded
from chord_tpu_torch.renderer import RendererConfig
from chord_tpu_torch.renderer.deferred import DeviceView, render_frame_flat
from chord_tpu_torch.rhi.framebuffer import FrameHistory
from chord_tpu_torch.utils.camera import Camera

N = 2
W, H = 128, 64
N_FRAMES = 2
CFG = dict(width=W, height=H, pair_capacity=2048, big_capacity=64,
           enable_bloom=False, enable_tsr=False)


def _np(obj):
    return {k: np.asarray(v) for k, v in vars(obj).items() if v is not None}


def _camera(cls, i=0):
    cam = cls(width=W, height=H)
    cam.position = np.array([-15.0 + 0.5 * i, 4.0, 3.0 - 0.3 * i])
    cam.look_at(np.array([10.0, 2.0, -2.0]))
    return cam


@pytest.mark.parametrize("n", [1, 2, 4])
def test_strip_matrix_equals_chord_tpu(n):
    for k in range(n):
        np.testing.assert_array_equal(sharded._strip_matrix(k, n),
                                      jsharded._strip_matrix(k, n))


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("shadows", [False, True])
def test_strip_device_views_equal_chord_tpu(n, shadows):
    """Every leaf of every strip's view (with the host cascade fit, which
    reads the strip's aspect, when `shadows`)."""
    kw = dict(shadow_cfg=ShadowConfig()) if shadows else {}
    jkw = dict(shadow_cfg=JShadowConfig()) if shadows else {}
    u = _camera(Camera).view_uniform(3, jitter=True)
    ju = _camera(JCamera).view_uniform(3, jitter=True)
    views = sharded.strip_device_views(u, n, device="cpu", **kw)
    jviews = jsharded.strip_device_views(ju, n, **jkw)
    assert len(views) == n
    for f in dataclasses.fields(DeviceView):
        jleaf = getattr(jviews, f.name)
        for k, v in enumerate(views):
            leaf = getattr(v, f.name)
            assert (leaf is None) == (jleaf is None), f.name
            if leaf is not None:
                np.testing.assert_allclose(leaf.numpy(),
                                           np.asarray(jleaf)[k], rtol=0,
                                           atol=1e-7, err_msg=f.name)
    one = sharded.strip_view(u, n - 1, n, device="cpu", **kw)
    np.testing.assert_array_equal(one.tw_to_clip.numpy(),
                                  views[-1].tw_to_clip.numpy())


@pytest.fixture(scope="module")
def flat_runs():
    jb = jax_sponza(detail=1)
    jpools = jb.build_pools()
    mesh = Mesh(np.array(jax.devices()[:N]), (jsharded.AXIS,))
    jr = jsharded.ShardedRenderer(JConfig(**CFG, interpret=True), mesh,
                                  path="flat")
    jframes = []
    for i in range(N_FRAMES):
        jcam = _camera(JCamera, i)
        img, st = jr.render(jpools, jb.frame_instances(jcam),
                            jcam.view_uniform(i))
        jframes.append((np.asarray(img),
                        {k: np.asarray(v) for k, v in st.items()},
                        np.asarray(jr.history.exposure)))

    cams = [_camera(Camera, i) for i in range(N_FRAMES)]
    job = sharded.StripJob(
        "flat", RendererConfig(**CFG), None, _np(jpools),
        [_np(jb.frame_instances(_camera(JCamera, i)))
         for i in range(N_FRAMES)],
        [c.view_uniform(i) for i, c in enumerate(cams)])
    ranks = sharded.spawn_strips(N, sharded.render_strips, job,
                                 device="cpu", timeout_s=300)
    return jframes, ranks


def test_sharded_flat_stats_equal_chord_tpu(flat_runs):
    jframes, ranks = flat_runs
    for i, (_, jst, _) in enumerate(jframes):
        for r in ranks:
            st = r[i]["stats"]
            assert set(st) == set(jst)
            for k, v in jst.items():
                assert int(st[k]) == int(v), (i, k)
        assert int(jst["bin_overflow"]) == 0 and int(jst["drawn_tris"]) > 500


def test_sharded_flat_image_matches_chord_tpu(flat_runs):
    jframes, ranks = flat_runs
    for i, (jimg, _, _) in enumerate(jframes):
        img = ranks[0][i]["image"]
        assert ranks[1][i]["image"] is None
        assert img.shape == jimg.shape == (H, W, 3)
        diff = np.abs(img.astype(np.int32) - jimg.astype(np.int32))
        assert (diff <= 2).mean() >= 0.999, (i, diff.max())
        for k in range(N):
            assert img[k * H // N:(k + 1) * H // N].std() > 1.0, k


def test_sharded_flat_exposure_matches_chord_tpu(flat_runs):
    """Auto exposure sees the whole image on every rank: one adapted
    value, chord_tpu's to 1e-6."""
    jframes, ranks = flat_runs
    for i, (_, _, jexp) in enumerate(jframes):
        assert np.ptp(jexp) == 0.0
        for r in ranks:
            assert abs(r[i]["exposure"] - float(jexp[0])) <= 1e-6, i
    assert ranks[0][-1]["exposure"] != 1.0     # it adapted


def test_sharded_renderer_refuses_post_size_and_unknown_path():
    with pytest.raises(ValueError, match="post"):
        sharded.ShardedRenderer(RendererConfig(**CFG, post_width=192,
                                               post_height=96),
                                device="cpu")
    with pytest.raises(ValueError, match="path"):
        sharded.ShardedRenderer(RendererConfig(**CFG), path="tiles",
                                device="cpu")


def test_one_strip_without_a_group_is_the_flat_frame():
    """No process group: one strip, the whole image, render_frame_flat's
    own output."""
    b = build_sponza_like(detail=1)
    pools = b.build_pools(device="cpu")
    cam = _camera(Camera)
    inst = b.frame_instances(cam, device="cpu")
    r = sharded.ShardedRenderer(RendererConfig(**CFG), device="cpu")
    assert (r.n, r.rank) == (1, 0)
    img, st = r.render(pools, inst, cam.view_uniform(0))
    ref, _, ref_st = render_frame_flat(
        pools, inst, DeviceView.from_uniform(cam.view_uniform(0),
                                             device="cpu"),
        FrameHistory.empty(H, W, device="cpu"), RendererConfig(**CFG))
    np.testing.assert_array_equal(img.numpy(), ref.numpy())
    assert {k: int(v) for k, v in st.items()} == \
        {k: int(v) for k, v in ref_st.items()}


def test_spawn_strips_reraises_a_rank_traceback():
    job = sharded.StripJob("tiles", RendererConfig(**CFG), None, {}, {},
                           [])
    with pytest.raises(RuntimeError, match="ValueError"):
        sharded.spawn_strips(N, sharded.render_strips, job, device="cpu",
                             timeout_s=120)


def test_spawn_strips_deadline_fails_instead_of_hanging():
    """A run that overruns its deadline raises TimeoutError and its ranks
    are stopped (they cannot even import torch in 0.2 s)."""
    job = sharded.StripJob("flat", RendererConfig(**CFG), None, {}, {}, [])
    with pytest.raises(TimeoutError):
        sharded.spawn_strips(N, sharded.render_strips, job, device="cpu",
                             timeout_s=0.2)


def test_strip_backend_rule():
    assert sharded.strip_backend(2, "cpu")[:2] == ("gloo", "cpu")
