"""The port's strip-parallel meshlet frame (chord_tpu_torch/parallel/
sharded.py, path="meshlet") against chord_tpu's, against the port's own
single-device frame, and on chord_tpu's full feature set.

1. chord_tpu's ShardedRenderer on 2 of the 8 virtual CPU devices against
   the port's on 2 gloo ranks on the CPU (spawn_strips, device="cpu"):
   chord_tpu's meshlet pools of the tiny atrium at 128x64,
   draw_capacity=256, occlusion=False, no bloom or TSR (the configuration
   of chord_tpu's tests/test_sharded.py). Tolerances of
   tests/test_torch_frame.py: summed stats equal; >= 99.9% of u8 channel
   values within 2 levels; the adapted exposure (the strips' histograms
   averaged inside the frame) within 1e-6.
2. The port's sharded image against the port's single-device
   MeshletRenderer image of the same frame, under chord_tpu's own gate
   (tests/test_sharded.py): under 2% of pixels off by more than 8 levels
   (the strip frusta clip geometry at slightly different precision along
   the seam rows), and no strip empty.
3. chord_tpu's full-feature configuration (test_sharded_full_feature_frame:
   textures, masked and blend buckets, cascaded shadows, atmosphere,
   screen-probe GI with BVH rays, SSR, bloom, global TSR) on the port
   alone, 2 strips of 16 rows, two frames: finite, std > 8, no bin
   overflow, every strip non-empty, and after each frame the world SH
   cache bit-equal on both ranks (each strip injects its own probes; the
   all-reduce must leave one cache).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from chord_tpu.asset.procedural import build_sponza_like as jax_sponza
from chord_tpu.parallel import sharded as jsharded
from chord_tpu.renderer.deferred import RendererConfig as JConfig
from chord_tpu.renderer.meshlet_frame import MeshletFrameConfig as JMcfg
from chord_tpu.rhi.meshlet_scene import build_meshlet_pools as jax_pools
from chord_tpu.utils.camera import Camera as JCamera

from chord_tpu_torch import interop
from chord_tpu_torch.parallel import sharded
from chord_tpu_torch.renderer import (MeshletFrameConfig, MeshletRenderer,
                                      RendererConfig)
from chord_tpu_torch.utils.camera import Camera

N = 2
W, H = 128, 64
CFG = dict(width=W, height=H, pair_capacity=2048, big_capacity=64,
           enable_bloom=False, enable_tsr=False)
MCFG = dict(draw_capacity=256, occlusion=False)


def _np(obj):
    return {k: np.asarray(v) for k, v in vars(obj).items() if v is not None}


def _camera(cls, w=W, h=H):
    cam = cls(width=w, height=h)
    cam.position = np.array([-15.0, 4.0, 3.0])
    cam.look_at(np.array([10.0, 2.0, -2.0]))
    return cam


@pytest.fixture(scope="module")
def runs():
    jb = jax_sponza(detail=1)
    jpools = jax_pools(jb)
    jcam = _camera(JCamera)
    jinst = jb.frame_instances(jcam)
    mesh = Mesh(np.array(jax.devices()[:N]), (jsharded.AXIS,))
    jr = jsharded.ShardedRenderer(JConfig(**CFG, interpret=True), mesh,
                                  path="meshlet", mcfg=JMcfg(**MCFG))
    jimg, jst = jr.render(jpools, jinst, jcam.view_uniform(0))
    jst = {k: np.asarray(v) for k, v in jst.items()}
    jexp = np.asarray(jr.history.exposure)

    u = _camera(Camera).view_uniform(0)
    job = sharded.StripJob("meshlet", RendererConfig(**CFG),
                           MeshletFrameConfig(**MCFG), _np(jpools),
                           _np(jinst), [u])
    frame = sharded.spawn_strips(N, sharded.render_strips, job,
                                 device="cpu", timeout_s=300)[0][0]

    single = MeshletRenderer(RendererConfig(**CFG),
                             MeshletFrameConfig(**MCFG))
    one, _ = single.render(interop.pools_from_numpy(_np(jpools), "cpu"),
                           interop.instances_from_numpy(_np(jinst), "cpu"),
                           u)
    return (np.asarray(jimg), jst, jexp), frame, one.numpy()


def test_sharded_meshlet_stats_equal_chord_tpu(runs):
    (_, jst, _), frame, _ = runs
    assert set(frame["stats"]) == set(jst)
    for k, v in jst.items():
        np.testing.assert_array_equal(frame["stats"][k], v, err_msg=k)
    assert int(jst["drawn_tris"]) > 100 and int(jst["bin_overflow"]) == 0


def test_sharded_meshlet_image_matches_chord_tpu(runs):
    (jimg, _, _), frame, _ = runs
    img = frame["image"]
    assert img.shape == jimg.shape == (H, W, 3)
    diff = np.abs(img.astype(np.int32) - jimg.astype(np.int32))
    assert (diff <= 2).mean() >= 0.999, (diff.max(), (diff > 2).mean())


def test_sharded_meshlet_exposure_matches_chord_tpu(runs):
    """The strips' exposure histogram is averaged over the ranks inside
    the frame (render_frame_meshlet(group=...)): one adapted exposure on
    every rank, chord_tpu's to 1e-6."""
    (_, _, jexp), frame, _ = runs
    assert np.ptp(jexp) == 0.0
    assert abs(frame["exposure"] - float(jexp[0])) <= 1e-6
    assert frame["exposure"] != 1.0


def test_sharded_meshlet_matches_single_device(runs):
    _, frame, one = runs
    img = frame["image"]
    assert img.shape == one.shape
    diff = np.abs(one.astype(np.int32) - img.astype(np.int32))
    frac_off = (diff.max(-1) > 8).mean()
    assert frac_off < 0.02, f"{frac_off:.4f} of pixels differ"
    for k in range(N):
        assert img[k * H // N:(k + 1) * H // N].std() > 1.0, f"strip {k}"


@pytest.fixture(scope="module")
def full_feature():
    """chord_tpu's test_sharded_full_feature_frame configuration (its
    dryrun's) on 2 strips (h = 16 * 2), two frames, the scene built with
    the port's host code (sharded.dryrun_job)."""
    job = sharded.dryrun_job(N, frames=2)
    return job.config.height, job.config.width, sharded.spawn_strips(
        N, sharded.render_strips, job, device="cpu", timeout_s=300)


def test_sharded_full_feature_frame(full_feature):
    h, w, ranks = full_feature
    img = None
    for i, frame in enumerate(ranks[0]):
        img = frame["image"]
        assert img.shape == (h, w, 3)
        for k in range(N):
            assert img[k * h // N:(k + 1) * h // N].std() > 1.0, (i, k)
        for r in ranks:
            assert int(r[i]["stats"]["bin_overflow"]) == 0, i
    assert np.isfinite(img.astype(np.float64)).all()
    assert img.std() > 8.0, "full-feature sharded frame is blank"


def test_sharded_world_cache_equal_on_every_rank(full_feature):
    _, _, ranks = full_feature
    for i in range(len(ranks[0])):
        digests = {r[i]["gi_cache"] for r in ranks}
        assert len(digests) == 1, f"frame {i}: the ranks' caches differ"
    # the cache took probes: it is not the empty history's
    empty = sharded.digest(torch.zeros(4, 32 ** 3, 28))
    assert ranks[0][-1]["gi_cache"] != empty


def test_dryrun_prints_chord_tpu_line(capfd):
    """dryrun(2) on gloo CPU ranks: chord_tpu's dry-run frame, and its
    line with the whole image's shape and the summed stats."""
    sharded.dryrun(N, device="cpu")
    out = capfd.readouterr().out
    line = [ln for ln in out.splitlines()
            if ln.startswith("dryrun_multichip(")][-1]
    assert line.startswith(f"dryrun_multichip({N}): image (32, 128, 3), "
                           "stats {"), line
    assert "'bin_overflow': 0" in line and "'drawn_tris': " in line
