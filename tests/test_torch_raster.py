"""Binning + raster (K1's plain version) against chord_tpu's Pallas raster
in interpret mode, fed the SAME TriangleSetup (chord_tpu's, converted).

Tolerances.
- Work queue: exact — per-tile starts/counts, pair count, overflow, and
  each tile's set of windows (chord_tpu's key-value sort leaves the order
  of equal keys to the backend; the port sorts stably, and the raster
  result does not depend on the order within a tile).
- Synthetic scenes whose planes are exact dyadic rationals (including
  pixel centres exactly on a shared edge at equal depth): every render
  target bit-exact.
- Meshlet scenes: XLA's CPU backend contracts b*y + c into fused
  multiply-adds in the interpret-mode kernel, where the port (and its CUDA
  kernel) round each operation; a pixel centre within an ulp of an edge
  can flip. So vis must match on >= 99.9% of pixels, and where it matches
  depth to 1e-6. The attribute planes to 1e-3 (relative, min 1): an
  attribute is (a*px + (b*y + c)) / sum(l), whose terms reach ~1e3-1e4 at
  these pixel coordinates, so one differently rounded term moves it by
  ~1e-4 (measured at most 1.3e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chord_tpu.asset.procedural import build_sponza_like
from chord_tpu.ops import cull as jcull
from chord_tpu.ops import mesh_shader as jms
from chord_tpu.ops import raster as jr
from chord_tpu.renderer.deferred import DeviceView as JView
from chord_tpu.renderer.meshlet_frame import MeshletFrameConfig as JMcfg
from chord_tpu.rhi.meshlet_scene import build_meshlet_pools
from chord_tpu.utils.camera import Camera

from chord_tpu_torch import interop
from chord_tpu_torch.ops import cull, mesh_shader, raster
from chord_tpu_torch.rhi.framebuffer import vis_to_uint32

W, H = 128, 64


def _np(obj):
    return {k: np.asarray(v) for k, v in vars(obj).items() if v is not None}


def _port_setup(js) -> raster.TriangleSetup:
    t = lambda a: torch.from_numpy(np.array(a))
    return raster.TriangleSetup(
        coefT=t(np.asarray(js.coefT)[:, :32].view(np.int32)),
        window_bbox=t(js.window_bbox), window_valid=t(js.window_valid),
        valid=t(js.valid), sub_bounds=t(js.sub_bounds))


def _port_cfg(rc) -> raster.RasterConfig:
    fields = {f: getattr(rc, f) for f in raster.RasterConfig._fields}
    return raster.RasterConfig(**fields)


def _same_queue(q, jq, d):
    for f in ("starts", "counts", "n_pairs", "overflow"):
        np.testing.assert_array_equal(getattr(q, f).numpy(),
                                      np.asarray(getattr(jq, f)), err_msg=f)
    pw, jpw = q.pair_win.numpy(), np.asarray(jq.pair_win)
    for s, c in zip(q.starts.numpy(), q.counts.numpy()):
        np.testing.assert_array_equal(np.sort(pw[s:s + c]),
                                      np.sort(jpw[s:s + c]))
    n = int(q.n_pairs)
    assert (pw[n:] == d).all() and (jpw[n:] == d).all()


def _outs(rts):
    return [np.asarray(x) for x in rts]


def _compare_exact(got, ref):
    np.testing.assert_array_equal(vis_to_uint32(got[1]), ref[1])
    for k in [0] + list(range(2, len(ref))):
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=str(k))


def _compare_close(got, ref):
    vis, jvis = vis_to_uint32(got[1]), ref[1]
    same = vis == jvis
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_allclose(got[0].numpy()[same], ref[0][same],
                               rtol=0, atol=1e-6)
    for k in range(2, len(ref)):
        a, b = got[k].numpy()[same], ref[k][same]
        assert (np.abs(a - b) <= 1e-3 * np.maximum(np.abs(b), 1.0)).all(), k


# --- synthetic: exact planes, shared-edge ties ----------------------------

def _square_scene():
    """Two coplanar squares (z=0.5) of two triangles each, split along a
    diagonal through pixel centres: the diagonal ties within a window's
    group; the second window's copy ties across windows (larger payload
    wins). Vertex coordinates are dyadic, so every plane is exact."""
    px = np.array([[0, 0], [64, 0], [0, 64], [64, 64]], np.float64)
    clip = np.zeros((8, 4), np.float32)
    for k in range(2):
        x = px[:, 0] * 2.0 / W - 1.0
        y = 1.0 - px[:, 1] * 2.0 / H
        clip[4 * k:4 * k + 4] = np.stack([x, y, np.full(4, 0.5),
                                          np.ones(4)], 1)
    idx = np.zeros((256, 3), np.int32)
    idx[0], idx[1] = [0, 1, 3], [0, 3, 2]
    idx[128], idx[129] = [4, 5, 7], [4, 7, 6]
    valid = np.zeros(256, bool)
    valid[[0, 1, 128, 129]] = True
    payload = np.zeros(256, np.uint32)
    payload[[0, 1, 128, 129]] = [(1 << 7) | 0, (1 << 7) | 1,
                                 (2 << 7) | 0, (2 << 7) | 1]
    rng = np.random.default_rng(0)
    attrs = (rng.integers(-8, 9, (8, 5)) / 8.0).astype(np.float32)
    return clip, idx, valid, payload, attrs


@pytest.mark.parametrize("with_attrs", [True, False])
def test_shared_edge_ties_bit_exact(with_attrs):
    rc = jr.RasterConfig(width=W, height=H, tile_h=32, sub_s=4,
                         pair_capacity=256, big_capacity=16,
                         with_attrs=with_attrs, interpret=True)
    clip, idx, valid, payload, attrs = _square_scene()
    js = jr.setup_triangles(jnp.asarray(clip), jnp.asarray(idx),
                            jnp.asarray(valid), jnp.asarray(payload), rc,
                            backface_cull=False, attrs=jnp.asarray(attrs))
    jq = jr.bin_windows(js, rc)
    ref = _outs(jr.raster_queue(jq, js, rc))
    setup, cfg = _port_setup(js), _port_cfg(rc)
    q = raster.bin_windows(setup, cfg)
    _same_queue(q, jq, setup.num_windows)
    got = raster.raster_queue(q, setup, cfg)
    _compare_exact(got, ref)
    # the diagonal really tied: window 1's payloads won everywhere inside
    inside = ref[0] > 0
    assert (ref[1][inside] >> 7 == 2).all() and inside.sum() > 64 * 60


# --- meshlet scenes --------------------------------------------------------

@pytest.fixture(scope="module")
def meshlet_setups():
    b = build_sponza_like(detail=1)
    pools = build_meshlet_pools(b)
    out = []
    for pos, tgt in [((-15.0, 4.0, 2.0), (10.0, 2.0, -1.0)),
                     ((-3.0, 1.5, 5.0), (8.0, 1.0, -6.0))]:
        cam = Camera(width=W, height=H)
        cam.position = np.array(pos)
        cam.look_at(np.array(tgt))
        view = JView.from_uniform(cam.view_uniform(0))
        inst = b.frame_instances(cam)
        res = jcull.cull_pairs(pools, inst, view.frustum_planes,
                               0.5 * H * view.tw_to_clip_nj[1, 1], 256)
        out.append(jms.mesh_shader_setup(res.draws, pools, inst,
                                         view.tw_to_clip, 256, W, H,
                                         interpret=True, sub_s=8))
    return out


def _rc(**kw):
    base = dict(width=W, height=H, tile_h=32, sub_s=8, pair_capacity=2048,
                big_capacity=64, interpret=True)
    base.update(kw)
    return jr.RasterConfig(**base)


@pytest.fixture(scope="module")
def phase0_ref(meshlet_setups):
    """chord_tpu's with-attrs raster of the first setup (also the seeds of
    the phase-1 style case)."""
    rc = _rc(with_attrs=True)
    js = meshlet_setups[0]
    jq = jr.bin_windows(js, rc)
    return jq, _outs(jr.raster_queue(jq, js, rc))


@pytest.mark.parametrize("with_attrs", [True, False])
def test_meshlet_raster_matches(meshlet_setups, phase0_ref, with_attrs):
    rc = _rc(with_attrs=with_attrs)
    js = meshlet_setups[0]
    jq, ref = phase0_ref
    if not with_attrs:
        ref = _outs(jr.raster_queue(jq, js, rc))
    setup, cfg = _port_setup(js), _port_cfg(rc)
    q = raster.bin_windows(setup, cfg)
    _same_queue(q, jq, setup.num_windows)
    _compare_close(raster.raster_queue(q, setup, cfg), ref)
    assert (ref[0] > 0).mean() > 0.3


def test_seeded_and_zclip_raster_matches(meshlet_setups, phase0_ref):
    """Phase-1 style seeding from another raster, and the z_clip peel."""
    rc = _rc(with_attrs=True)
    js1 = meshlet_setups[1]
    jseeds = phase0_ref[1]
    seeds = [torch.from_numpy(np.array(x)) for x in jseeds]
    seeds[1] = torch.from_numpy(np.array(jseeds[1]).view(np.int32))
    jq = jr.bin_windows(js1, rc)
    setup, cfg = _port_setup(js1), _port_cfg(rc)
    q = raster.bin_windows(setup, cfg)
    ref = _outs(jr.raster_queue(jq, js1, rc, seeds=tuple(
        jnp.asarray(x) for x in jseeds)))
    _compare_close(raster.raster_queue(q, setup, cfg, seeds=seeds), ref)

    rcz = rc._replace(z_clip=True, with_attrs=False)
    zc = jseeds[0]
    ref = _outs(jr.raster_queue(jq, js1, rcz, zclip=jnp.asarray(zc)))
    got = raster.raster_queue(q, setup, _port_cfg(rcz),
                              zclip=torch.from_numpy(np.array(zc)))
    _compare_close(got, ref)
    assert (got[0].numpy() < np.where(zc > 0, zc, 1e30)).all()


def test_capacity_overflow_matches(meshlet_setups):
    rc = _rc(with_attrs=True, pair_capacity=40, big_capacity=2)
    js = meshlet_setups[1]
    jq = jr.bin_windows(js, rc)
    q = raster.bin_windows(_port_setup(js), _port_cfg(rc))
    assert int(q.overflow) > 0
    for f in ("counts", "n_pairs", "overflow"):
        np.testing.assert_array_equal(getattr(q, f).numpy(),
                                      np.asarray(getattr(jq, f)), err_msg=f)


def test_no_phantom_from_invalid_lanes():
    """tests/test_meshlet.py's phantom-geometry case through the port: the
    in-window sort must not create coverage (the ortho shadow-light view
    makes windows with many invalid lanes); sorted and unsorted setups
    raster the same coverage, no payload-0 coverage, and the port agrees
    with chord_tpu."""
    b = build_sponza_like(detail=1)
    pools = build_meshlet_pools(b)
    cam = Camera(width=256, height=256)
    cam.position = np.array([-15.0, 4.0, 3.0])
    cam.look_at(np.array([10.0, 2.0, -2.0]))
    inst = b.frame_instances(cam)
    scfg = JMcfg(draw_capacity=256).shadow_cfg
    view = JView.from_uniform(cam.view_uniform(0), shadow_cfg=scfg)
    r = 256
    m = view.shadow_tw_to_light[1]
    res = jcull.cull_pairs(pools, inst, view.shadow_frustum_planes[1],
                           jnp.float32(0.5 * r * np.asarray(m)[1, 1]), 256,
                           lod_threshold=1.0, enable_cone=False)
    rc = jr.RasterConfig(width=r, height=r, pair_capacity=4096,
                         big_capacity=64, interpret=True)
    cfg = _port_cfg(rc)
    tpools = interop.pools_from_numpy(_np(pools))
    tinst = interop.instances_from_numpy(_np(inst))
    draws = cull.DrawList(*[torch.from_numpy(np.array(x))
                            for x in res.draws])
    outs = {}
    for sort in (True, False):
        setup = mesh_shader.mesh_shader_setup(
            draws, tpools, tinst, torch.from_numpy(np.array(m)), 256, r, r,
            backface_cull=False, sort_tris=sort, sub_s=rc.sub_s)
        d, v = raster.raster_queue(raster.bin_windows(setup, cfg), setup,
                                   cfg)[:2]
        outs[sort] = (d.numpy(), vis_to_uint32(v))
    (d_s, v_s), (d_n, v_n) = outs[True], outs[False]
    np.testing.assert_array_equal(d_s > 0, d_n > 0)
    np.testing.assert_allclose(d_s, d_n, atol=1e-5)
    assert not ((v_s == 0) & (d_s > 0)).any()
    assert (d_s > 0).any()
    js = jms.mesh_shader_setup(res.draws, pools, inst, m, 256, r, r,
                               backface_cull=False, sub_s=rc.sub_s,
                               interpret=True)
    jd, jv = jr.raster_queue(jr.bin_windows(js, rc), js, rc)[:2]
    assert (v_s == np.asarray(jv)).mean() >= 0.999
