"""Mesh shader (K2's plain version) against chord_tpu's Pallas kernel in
interpret mode, on identical draws.

Tolerances. Integer outputs — the payload lane, window bbox, validity and
sub-bounds, and so the sort permutation — must be equal. The float
coefficient lanes may differ by a few ulp: the port (like its CUDA kernel)
rounds every product and sum separately, in the reference kernel's order,
while XLA's CPU backend contracts a*b+c into fused multiply-adds inside
the interpret-mode kernel (jit(x*y+z) differs from the separately rounded
result). The planes are built from vertices scaled to |X|,|Y|,|w| <= 1, so
the bound is |port - ref| <= 2e-6 * max(|ref|, 1) (about 16 ulp at 1;
measured at most 6.7e-7). Cases: with and without the in-window sort and
back-face culling, a phase-1 payload base, and slack slots (poison); an
empty draw list (every slot poison) and a full one (a cull at a capacity
below the scene's live draws: no slot is slack).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chord_tpu.asset.procedural import build_sponza_like
from chord_tpu.ops import cull as jcull
from chord_tpu.ops import mesh_shader as jms
from chord_tpu.renderer.deferred import DeviceView as JView
from chord_tpu.rhi.meshlet_scene import build_meshlet_pools
from chord_tpu.utils.camera import Camera

from chord_tpu_torch import interop
from chord_tpu_torch.ops import cull, mesh_shader

W, H = 128, 64
CAP = 128
FULL_CAP = 32          # below the scene's live draws: the cull fills it


def _np(obj):
    return {k: np.asarray(v) for k, v in vars(obj).items() if v is not None}


@pytest.fixture(scope="module")
def state():
    b = build_sponza_like(detail=1)
    pools = build_meshlet_pools(b)
    cam = Camera(width=W, height=H)
    cam.position = np.array([-15.0, 4.0, 2.0])
    cam.look_at(np.array([10.0, 2.0, -1.0]))
    view = JView.from_uniform(cam.view_uniform(0, jitter=True))
    inst = b.frame_instances(cam)
    ps = 0.5 * H * view.tw_to_clip_nj[1, 1]
    res = jcull.cull_pairs(pools, inst, view.frustum_planes, ps, CAP)
    tpools = interop.pools_from_numpy(_np(pools), device="cpu")
    tinst = interop.instances_from_numpy(_np(inst), device="cpu")
    tdraws = cull.DrawList(*[torch.from_numpy(np.array(x))
                             for x in res.draws])
    full = jcull.cull_pairs(pools, inst, view.frustum_planes, ps,
                            FULL_CAP).draws
    return dict(j=(pools, inst, view, res.draws),
                t=(tpools, tinst, torch.from_numpy(
                    np.array(view.tw_to_clip)), tdraws),
                full=(full, cull.DrawList(*[torch.from_numpy(np.array(x))
                                            for x in full])))


def _compare(ref, got, cap):
    coef_ref = np.asarray(ref.coefT)[:, :32]
    coef = got.coefT.numpy().view(np.uint32)
    assert coef.shape == coef_ref.shape == ((cap + 1) * 128, 32)
    np.testing.assert_array_equal(coef[:, 15], coef_ref[:, 15])   # payload
    fl = [i for i in range(32) if i != 15]
    cf, cf_ref = coef[:, fl].view(np.float32), coef_ref[:, fl].view(
        np.float32)
    assert (np.abs(cf - cf_ref) <= 2e-6 * np.maximum(np.abs(cf_ref), 1.0)
            ).all(), np.abs(cf - cf_ref).max()
    np.testing.assert_array_equal(got.window_bbox.numpy(),
                                  np.asarray(ref.window_bbox))
    np.testing.assert_array_equal(got.window_valid.numpy(),
                                  np.asarray(ref.window_valid))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.sub_bounds.numpy(),
                                  np.asarray(ref.sub_bounds))


@pytest.mark.parametrize("sort_tris,backface_cull,payload_base",
                         [(True, True, 0), (False, True, 0),
                          (True, False, 0), (True, True, 512)])
def test_mesh_shader_setup_matches(state, sort_tris, backface_cull,
                                   payload_base):
    jpools, jinst, jview, jdraws = state["j"]
    pools, inst, m, draws = state["t"]
    assert 0 < int(draws.count) < CAP     # live draws and slack slots
    kw = dict(payload_base=payload_base, backface_cull=backface_cull,
              sort_tris=sort_tris, sub_s=8)
    ref = jms.mesh_shader_setup(jdraws, jpools, jinst, jview.tw_to_clip, CAP,
                                W, H, interpret=True, **kw)
    got = mesh_shader.mesh_shader_setup(draws, pools, inst, m, CAP, W, H,
                                        **kw)
    _compare(ref, got, CAP)
    assert int(got.valid.sum()) > 100


@pytest.mark.parametrize("draw_list", ["empty", "full"])
def test_mesh_shader_setup_edge_counts(state, draw_list):
    """count == 0 (every slot and the appended window poison) and count ==
    capacity (no slack slot)."""
    jpools, jinst, jview, jdraws = state["j"]
    pools, inst, m, draws = state["t"]
    cap = CAP
    if draw_list == "empty":
        jdraws = jdraws._replace(count=jnp.zeros_like(jdraws.count))
        draws = draws._replace(count=torch.zeros_like(draws.count))
    else:
        cap = FULL_CAP
        jdraws, draws = state["full"]
        assert int(draws.count) == cap and int(draws.overflow) > 0
    kw = dict(sort_tris=True, backface_cull=True, sub_s=8)
    ref = jms.mesh_shader_setup(jdraws, jpools, jinst, jview.tw_to_clip, cap,
                                W, H, interpret=True, **kw)
    got = mesh_shader.mesh_shader_setup(draws, pools, inst, m, cap, W, H,
                                        **kw)
    _compare(ref, got, cap)
    n_valid = int(got.valid.sum())
    assert n_valid == 0 if draw_list == "empty" else n_valid > 100
