"""Culling and HZB: the port against chord_tpu on identical state.

The tiny atrium's pools / instances / view go to the port through
`interop`, so both packages cull the very same arrays. Draw lists, counts
and overflows are integers and must match exactly, in both occlusion
phases and under a capacity cut (which pairs survive depends on the
stable compaction order). HZB pyramids are min-reductions: exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chord_tpu.asset.procedural import build_sponza_like
from chord_tpu.ops import cull as jcull
from chord_tpu.ops import hzb as jhzb
from chord_tpu.renderer.deferred import DeviceView as JView
from chord_tpu.rhi.meshlet_scene import build_meshlet_pools
from chord_tpu.utils.camera import Camera

from chord_tpu_torch import interop
from chord_tpu_torch.ops import cull, hzb

W, H = 128, 64


def _np(obj):
    return {k: np.asarray(v) for k, v in vars(obj).items() if v is not None}


@pytest.fixture(scope="module")
def state():
    b = build_sponza_like(detail=1)
    pools = build_meshlet_pools(b)
    cam = Camera(width=W, height=H)
    cam.position = np.array([-15.0, 4.0, 2.0])
    cam.look_at(np.array([10.0, 2.0, -1.0]))
    view = JView.from_uniform(cam.view_uniform(0))
    inst = b.frame_instances(cam)
    return dict(j=(pools, inst, view),
                t=(interop.pools_from_numpy(_np(pools)),
                   interop.instances_from_numpy(_np(inst)),
                   interop.view_from_numpy(_np(view))))


def _same_draws(port, ref):
    for name in ("object_id", "meshlet_id", "count", "overflow"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)


def _depth(seed=0):
    """A depth buffer with occluding slabs (reverse-Z) from a seed."""
    rng = np.random.default_rng(seed)
    d = np.zeros((H, W), np.float32)
    for _ in range(6):
        y0, x0 = rng.integers(0, H - 8), rng.integers(0, W - 16)
        d[y0:y0 + rng.integers(8, 40), x0:x0 + rng.integers(16, 90)] = \
            rng.uniform(0.02, 0.5)
    return d


def test_hzb_pyramid_matches():
    d = _depth(1)[:61, :97]        # odd sizes: zero-padded reductions
    ref = jhzb.build_hzb(jnp.asarray(d))
    got = hzb.build_hzb(torch.from_numpy(d))
    assert got.widths == ref.widths and got.heights == ref.heights
    assert got.offsets == ref.offsets
    np.testing.assert_array_equal(got.flat.numpy(), np.asarray(ref.flat))


def test_occlusion_test_spheres_matches(state):
    _, _, jview = state["j"]
    rng = np.random.default_rng(3)
    n = 512
    c = np.stack([rng.uniform(-10, 10, n), rng.uniform(-2, 6, n),
                  rng.uniform(-30, 2, n)], 1).astype(np.float32)
    r = rng.uniform(0.01, 3.0, n).astype(np.float32)
    d = _depth(2)
    jp = jhzb.build_hzb(jnp.asarray(d))
    tp = hzb.build_hzb(torch.from_numpy(d))
    m = np.asarray(jview.tw_to_clip_nj)
    ref = jhzb.occlusion_test_spheres(jp, jnp.asarray(c), jnp.asarray(r),
                                      jnp.asarray(m))
    got = hzb.occlusion_test_spheres(tp, torch.from_numpy(c),
                                     torch.from_numpy(r), torch.from_numpy(m))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < int(got.sum()) < n      # both outcomes exercised


@pytest.mark.parametrize("cap", [1024, 24])
def test_two_phase_cull_matches(state, cap):
    jpools, jinst, jview = state["j"]
    pools, inst, view = state["t"]
    planes_j, planes_t = jview.frustum_planes, view.frustum_planes
    ps_j = 0.5 * H * jview.tw_to_clip_nj[1, 1]
    ps_t = 0.5 * H * view.tw_to_clip_nj[1, 1]

    act_j = jcull.build_active_pairs(jpools, jinst, planes_j, 256)
    act_t = cull.build_active_pairs(pools, inst, planes_t, 256)
    for f in ("pair_object", "pair_meshlet", "pair_valid", "pair_cull",
              "count", "overflow"):
        np.testing.assert_array_equal(getattr(act_t, f).numpy(),
                                      np.asarray(getattr(act_j, f)),
                                      err_msg=f)

    # phase 0 against an all-zero (invalid) history pyramid
    zero = np.zeros((H, W), np.float32)
    res0_j = jcull.cull_pairs(jpools, jinst, planes_j, ps_j, cap,
                              hzb=jhzb.build_hzb(jnp.asarray(zero)),
                              hzb_tw_to_clip=jview.prev_tw_to_clip_nj,
                              active=act_j)
    res0_t = cull.cull_pairs(pools, inst, planes_t, ps_t, cap,
                             hzb=hzb.build_hzb(torch.from_numpy(zero)),
                             hzb_tw_to_clip=view.prev_tw_to_clip_nj,
                             active=act_t)
    _same_draws(res0_t.draws, res0_j.draws)
    if cap == 24:
        assert int(res0_t.draws.overflow) > 0

    # phase 1: the occluded remainder against an occluding pyramid
    d = _depth(4)
    res_j = jcull.cull_pairs(jpools, jinst, planes_j, ps_j, cap,
                             hzb=jhzb.build_hzb(jnp.asarray(d)),
                             hzb_tw_to_clip=jview.tw_to_clip_nj,
                             active=act_j)
    res_t = cull.cull_pairs(pools, inst, planes_t, ps_t, cap,
                            hzb=hzb.build_hzb(torch.from_numpy(d)),
                            hzb_tw_to_clip=view.tw_to_clip_nj, active=act_t)
    _same_draws(res_t.draws, res_j.draws)
    np.testing.assert_array_equal(res_t.occluded_mask.numpy(),
                                  np.asarray(res_j.occluded_mask))
    res1_j = jcull.cull_pairs(jpools, jinst, planes_j, ps_j, 256,
                              hzb=jhzb.build_hzb(jnp.asarray(d)),
                              hzb_tw_to_clip=jview.tw_to_clip_nj,
                              extra_mask=res_j.occluded_mask, active=act_j)
    res1_t = cull.cull_pairs(pools, inst, planes_t, ps_t, 256,
                             hzb=hzb.build_hzb(torch.from_numpy(d)),
                             hzb_tw_to_clip=view.tw_to_clip_nj,
                             extra_mask=res_t.occluded_mask, active=act_t)
    _same_draws(res1_t.draws, res1_j.draws)


@pytest.mark.parametrize("masked", [None, False, True, "blend"])
def test_bucket_filters_match(state, masked):
    jpools, jinst, jview = state["j"]
    pools, inst, view = state["t"]
    # mark a few objects masked / blend so every bucket is non-trivial
    n = inst.object_masked.shape[0]
    mk = (np.arange(n) % 3 == 1).astype(np.float32)
    bl = (np.arange(n) % 5 == 2).astype(np.float32)
    jinst = jinst.replace(object_masked=jnp.asarray(mk),
                          object_blend=jnp.asarray(bl))
    inst = dataclasses.replace(inst, object_masked=torch.from_numpy(mk),
                               object_blend=torch.from_numpy(bl))
    ps = float(0.5 * H * np.asarray(jview.tw_to_clip_nj)[1, 1])
    ref = jcull.cull_pairs(jpools, jinst, jview.frustum_planes,
                           jnp.float32(ps), 1024, masked=masked)
    got = cull.cull_pairs(pools, inst, view.frustum_planes,
                          torch.tensor(ps), 1024, masked=masked)
    _same_draws(got.draws, ref.draws)
