"""The flat frame's vertex transform and object frustum cull against
chord_tpu, on the tiny atrium's flat pools (build_sponza_like(detail=1)),
seen from inside and from outside.

Tolerances: the visibility mask is exact. Clip positions: chord_tpu
multiplies the per-object matrices by the view projection with an einsum
(XLA's dot: another summation order, fused multiply-adds on the CPU)
where the port sums each 4-term dot left to right, so a coordinate may
differ by a few ulps of the products summed: 1e-5 relative to the
vertex's largest |clip| component (min 1).
"""

import numpy as np
import pytest
import torch

from chord_tpu.asset.procedural import build_sponza_like as jax_sponza
from chord_tpu.ops import transform as jtransform
from chord_tpu.renderer.deferred import DeviceView as JView
from chord_tpu.utils.camera import Camera as JCamera

from chord_tpu_torch import interop
from chord_tpu_torch.ops import transform


def _np(obj):
    return {k: np.asarray(v) for k, v in vars(obj).items() if v is not None}


@pytest.mark.parametrize("pos,target", [((-15.0, 4.0, 0.0), (10.0, 2.0, 0.0)),
                                        ((40.0, 30.0, 25.0), (0.0, 0.0, 0.0))])
def test_transform_and_cull_match(pos, target):
    jb = jax_sponza(detail=1)
    jpools = jb.build_pools()
    cam = JCamera(width=128, height=64)
    cam.position = np.array(pos)
    cam.look_at(np.array(target))
    jinst = jb.frame_instances(cam)
    jview = JView.from_uniform(cam.view_uniform(0, jitter=True))
    pools = interop.scene_pools_from_numpy(_np(jpools), device="cpu")
    inst = interop.instances_from_numpy(_np(jinst), device="cpu")
    view = interop.view_from_numpy(_np(jview), device="cpu")

    ref = np.asarray(jtransform.transform_to_clip(
        jpools.positions, jpools.vertex_object, jinst.object_to_tw,
        jview.tw_to_clip))
    got = transform.transform_to_clip(pools.positions, pools.vertex_object,
                                      inst.object_to_tw, view.tw_to_clip)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    scale = np.maximum(np.abs(ref).max(1, keepdims=True), 1.0)
    err = np.abs(got.numpy() - ref) / scale
    assert err.max() <= 1e-5, err.max()

    jvis = np.asarray(jtransform.frustum_cull_spheres(
        jinst.object_sphere_tw, jview.frustum_planes))
    vis = transform.frustum_cull_spheres(inst.object_sphere_tw,
                                         view.frustum_planes)
    np.testing.assert_array_equal(vis.numpy(), jvis)
    assert 0 < jvis.sum() <= len(jvis)
