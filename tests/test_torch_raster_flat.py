"""The flat raster path against chord_tpu: `setup_triangles`,
`bin_windows_subtile`, the sub-tile raster (K8's plain version) and the
brick raster (K7's plain version), on seeded random triangles; chord_tpu's
Pallas kernels run in interpret mode.

Tolerances.
- setup_triangles: pixel bboxes, validity, payloads and sub-bounds exact.
  Coefficients: XLA's CPU backend contracts a*b + c into fused
  multiply-adds where the port rounds each operation, so each coefficient
  must lie within 2e-6 of the largest coefficient magnitude of its plane
  (a few ulps of the terms that were summed; measured at most 2.4e-7).
- bin_windows_subtile: starts, counts, n_pairs and overflow exact; each
  (tile, sub-tile)'s set of windows equal. chord_tpu's key-value sort
  leaves equal keys in backend order and the port sorts stably, so which
  windows share a round may differ: rounds are compared as sets per
  sub-tile, and the round y ranges only where the rounds hold the same
  windows.
- Raster, fed chord_tpu's own setup and queue: on dyadic planes (exact in
  f32) every render target bit-exact; on random triangles the same FMA
  contraction can flip a pixel centre within an ulp of an edge, so vis
  must match on >= 99.9% of pixels, depth to 1e-6 where it does and the
  attribute planes to 1e-3 relative (min 1), as in test_torch_raster.py.
- Against the NumPy rasterize_oracle: chord_tpu's own gate
  (tests/test_raster.py): vis mismatch <= 1%, depth p99 < 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chord_tpu.ops import raster as jr

from chord_tpu_torch.ops import raster
from chord_tpu_torch.rhi.framebuffer import vis_to_uint32

W, H = 128, 32


def _tris(n, rng, perspective=True, backfaces=0.0, crossing=0.0,
          behind=0.0, size=(0.1, 0.35), sort=True):
    """n random triangles in clip space -> (clip, idx, valid, payload,
    attrs), T padded to 128. Perspective: per-vertex w in [0.6, 2.5];
    `backfaces` / `crossing` / `behind` are the fractions wound CW, with
    one vertex behind the eye (w < 0) and with all three behind. Sorted by
    centre so consecutive triangles (a window) stay close on screen."""
    centers = rng.uniform(-1.1, 1.1, (n, 2))
    if sort:
        centers = centers[np.lexsort((centers[:, 0],
                                      np.floor(centers[:, 1] * 4)))]
    clip = np.zeros((n * 3, 4), np.float32)
    for t in range(n):
        pts = centers[t] + rng.uniform(-1, 1, (3, 2)) * rng.uniform(*size)
        a2 = (pts[1, 0] - pts[0, 0]) * (pts[2, 1] - pts[0, 1]) - \
             (pts[1, 1] - pts[0, 1]) * (pts[2, 0] - pts[0, 0])
        if (a2 < 0) != (rng.uniform() < backfaces):
            pts = pts[::-1]
        w = rng.uniform(0.6, 2.5, 3) if perspective else np.ones(3)
        r = rng.uniform()
        if r < behind:
            w = -w
        elif r < behind + crossing:
            w[rng.integers(3)] *= -0.5
        z = rng.uniform(0.1, 0.9)
        clip[3 * t:3 * t + 3, 0:2] = pts * w[:, None]
        clip[3 * t:3 * t + 3, 2] = z * w
        clip[3 * t:3 * t + 3, 3] = w
    t_pad = -(-n // 128) * 128
    idx = np.zeros((t_pad, 3), np.int32)
    idx[:n] = np.arange(n * 3, dtype=np.int32).reshape(n, 3)
    valid = np.zeros(t_pad, bool)
    valid[:n] = True
    payload = np.zeros(t_pad, np.uint32)
    payload[:n] = (np.arange(n, dtype=np.uint32) + 1) << 7
    attrs = rng.normal(size=(n * 3, 5)).astype(np.float32)
    return clip, idx, valid, payload, attrs


def _dyadic_scene(rc):
    """Axis-aligned squares (two triangles each, split along a diagonal
    through pixel centres) at dyadic depths, w = 1: every plane is exact,
    the diagonals tie inside a window and overlapping squares at equal
    depth tie across windows (larger payload wins)."""
    # corners whose max(x, y, 1) is a power of two, so the per-vertex
    # scale of setup_triangles stays exact
    sq = [(0, 0, 64, 32, 0.5), (32, 0, 64, 32, 0.5), (16, 8, 32, 16, 0.75),
          (64, 0, 128, 32, 0.25)]
    clip = np.zeros((4 * len(sq), 4), np.float32)
    idx = np.zeros((128 * len(sq), 3), np.int32)
    valid = np.zeros(128 * len(sq), bool)
    payload = np.zeros(128 * len(sq), np.uint32)
    for k, (x0, y0, x1, y1, z) in enumerate(sq):
        px = np.array([[x0, y0], [x1, y0], [x0, y1], [x1, y1]], np.float64)
        clip[4 * k:4 * k + 4] = np.stack(
            [px[:, 0] * 2.0 / rc.width - 1.0, 1.0 - px[:, 1] * 2.0 /
             rc.height, np.full(4, z), np.ones(4)], 1)
        b = 4 * k
        idx[128 * k], idx[128 * k + 1] = [b, b + 1, b + 3], [b, b + 3, b + 2]
        valid[[128 * k, 128 * k + 1]] = True
        payload[[128 * k, 128 * k + 1]] = [((k + 1) << 7), ((k + 1) << 7) | 1]
    rng = np.random.default_rng(0)
    attrs = (rng.integers(-8, 9, (len(clip), 5)) / 8.0).astype(np.float32)
    return clip, idx, valid, payload, attrs


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(np.array(a.view(np.int32) if a.dtype ==
                                      np.uint32 else a))


def _port_cfg(rc) -> raster.RasterConfig:
    return raster.RasterConfig(**{f: getattr(rc, f)
                                  for f in raster.RasterConfig._fields})


def _port_setup(js) -> raster.TriangleSetup:
    return raster.TriangleSetup(
        coefT=_t(np.asarray(js.coefT)[:, :32]), window_bbox=_t(js.window_bbox),
        window_valid=_t(js.window_valid), valid=_t(js.valid),
        sub_bounds=_t(js.sub_bounds))


def _jsetup(scene, rc, backface_cull=True):
    clip, idx, valid, payload, attrs = scene
    return jr.setup_triangles(jnp.asarray(clip), jnp.asarray(idx),
                              jnp.asarray(valid), jnp.asarray(payload), rc,
                              backface_cull=backface_cull,
                              attrs=jnp.asarray(attrs))


def _psetup(scene, rc, backface_cull=True):
    clip, idx, valid, payload, attrs = scene
    return raster.setup_triangles(_t(clip), _t(idx), _t(valid), _t(payload),
                                  _port_cfg(rc), backface_cull=backface_cull,
                                  attrs=_t(attrs))


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


def _seeds(ref):
    """chord_tpu render targets -> port seed planes (vis as int32 bits)."""
    return [_t(x) for x in ref]


# --- setup_triangles ---------------------------------------------------------

@pytest.mark.parametrize("backface_cull", [True, False])
def test_setup_triangles_matches(backface_cull):
    rng = np.random.default_rng(1)
    scene = _tris(300, rng, backfaces=0.3, crossing=0.08, behind=0.04)
    rc = jr.RasterConfig(width=W, height=H, tile_h=16, sub_s=8,
                         with_attrs=True, interpret=True)
    js = _jsetup(scene, rc, backface_cull)
    s = _psetup(scene, rc, backface_cull)
    valid = np.asarray(js.valid)
    np.testing.assert_array_equal(s.valid.numpy(), valid)
    # every kind of triangle is present: valid, culled back faces, eye-plane
    # crossings (full-screen bbox), fully behind
    assert 0.2 < valid[:300].mean() < 0.95
    for f in ("window_bbox", "window_valid", "sub_bounds"):
        np.testing.assert_array_equal(getattr(s, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    jc = np.asarray(js.coefT)[:, :32]
    pc = s.coefT.numpy().view(np.uint32)
    assert pc.shape == jc.shape
    np.testing.assert_array_equal(pc[:, 15], jc[:, 15])       # payload
    np.testing.assert_array_equal(pc[:, 31], jc[:, 31])       # pad
    jf, pf = jc.view(np.float32), pc.view(np.float32)
    for plane in [(k, 5 + k, 10 + k) for k in range(5)] + \
            [(16 + 3 * k, 17 + 3 * k, 18 + 3 * k) for k in range(5)]:
        cols = list(plane)
        scale = np.maximum(np.abs(jf[:, cols]).max(1, keepdims=True),
                           1e-30)
        err = np.abs(pf[:, cols] - jf[:, cols]) / scale
        assert err.max() <= 2e-6, (plane, err.max())
    # invalid triangles and the poison window carry the poison row
    poison = ~np.concatenate([valid, np.zeros(128, bool)])
    assert (pf[poison, 10:13] == -1.0).all()


# --- bin_windows_subtile -----------------------------------------------------

def _queue_case(case):
    """-> (chord_tpu setup, chord_tpu RasterConfig) of a binning case on a
    256x64 screen (2 x 4 tiles of 128x16, 32 sub-tiles)."""
    rng = np.random.default_rng(2)
    clip, idx, valid, payload, attrs = _tris(900, rng, size=(0.05, 0.15))
    # a few windows of large triangles spanning the screen (the big path)
    big = _tris(256, rng, size=(0.6, 0.9), sort=False)
    scene = (np.concatenate([clip, big[0]]),
             np.concatenate([idx, big[1] + len(clip)]),
             np.concatenate([valid, big[2]]),
             np.concatenate([payload, big[3] + (1 << 20)]),
             np.concatenate([attrs, big[4]]))
    rc = jr.RasterConfig(width=256, height=64, tile_h=16, sub_s=8,
                         small_kx=1, small_ky=1, pair_capacity=4096,
                         big_capacity=128, subtiles=True, interpret=True)
    rc = {"fits": rc,
          "round_overflow": rc._replace(pair_capacity=160),
          "big_overflow": rc._replace(big_capacity=1)}[case]
    return _jsetup(scene, rc), rc


def _same_subtile_queue(q, jq, d):
    for f in ("starts", "counts", "n_pairs", "overflow"):
        np.testing.assert_array_equal(getattr(q, f).numpy(),
                                      np.asarray(getattr(jq, f)), err_msg=f)
    gw, jgw = q.gwin.numpy().reshape(-1, 4), np.asarray(jq.gwin).reshape(-1, 4)
    y = (q.y0r.numpy(), q.y1r.numpy())
    jy = (np.asarray(jq.y0r), np.asarray(jq.y1r))
    live = np.zeros(len(gw), bool)
    for s, c in zip(q.starts.numpy(), q.counts.numpy()):
        live[s:s + c] = True
        for sub in range(4):
            np.testing.assert_array_equal(np.sort(gw[s:s + c, sub]),
                                          np.sort(jgw[s:s + c, sub]))
        same = (gw[s:s + c] == jgw[s:s + c]).all(1)
        for a, b in zip(y, jy):
            np.testing.assert_array_equal(a[s:s + c][same], b[s:s + c][same])
    assert (gw[~live] == d).all() and (jgw[~live] == d).all()
    for a, b in zip(y, jy):
        np.testing.assert_array_equal(a[~live], b[~live])


@pytest.mark.parametrize("case", ["fits", "round_overflow", "big_overflow"])
def test_bin_windows_subtile_matches(case):
    js, rc = _queue_case(case)
    jq = jr.bin_windows_subtile(js, rc)
    q = raster.bin_windows_subtile(_port_setup(js), _port_cfg(rc))
    _same_subtile_queue(q, jq, js.num_windows)
    n_big = int((np.asarray(js.window_bbox)[2] // 32 -
                 np.asarray(js.window_bbox)[0] // 32 > 0).sum())
    assert n_big > 1 and int(q.n_pairs) > (100 if case == "fits" else 0)
    assert (int(q.overflow) == 0) == (case == "fits"), int(q.overflow)


# --- K8: the sub-tile raster -------------------------------------------------

RC_ST = jr.RasterConfig(width=W, height=H, tile_h=16, sub_s=4,
                        pair_capacity=1024, big_capacity=32, subtiles=True,
                        interpret=True)


# chord_tpu's raster entry points, jitted so that cases of one config and
# shape share one interpret-mode compile
_jq_subtile = jax.jit(jr.raster_queue_subtile, static_argnums=(2,))
_jq_queue = jax.jit(jr.raster_queue, static_argnums=(2,))


def _port_raster(scene, rc):
    """The port's K1 raster of a scene (chord_tpu layout: vis uint32),
    used as seeds and as a z_clip plane."""
    cfg = _port_cfg(rc._replace(bricks=False, subtiles=False, z_clip=False))
    clip, idx, valid, payload, attrs = scene
    out = raster.rasterize(_t(clip), _t(idx), _t(valid), _t(payload), cfg,
                           attrs=_t(attrs))[:-1]
    out = [x.numpy() for x in out]
    out[1] = out[1].view(np.uint32)
    return out


@pytest.fixture(scope="module")
def subtile_refs():
    """chord_tpu's sub-tile rasters of a random scene, without attributes
    and with attributes seeded by the port's raster of a second scene, and
    of the dyadic scene (same shapes, zero seeds)."""
    rng = np.random.default_rng(3)
    scene = _tris(400, rng, crossing=0.03)
    rc, rca = RC_ST, RC_ST._replace(with_attrs=True)
    out = {"scene": scene}
    js = _jsetup(scene, rc)
    jq = jr.bin_windows_subtile(js, rc)
    out["plain"] = (js, jq, rc, None, _outs(_jq_subtile(jq, js, rc)))
    for case, sc, seeds in (
            ("attrs_seeded", scene, _port_raster(_tris(200, rng), rca)),
            ("dyadic", _dyadic_scene(rca), [np.zeros((H, W), np.float32),
                                            np.zeros((H, W), np.uint32)] +
             [np.zeros((H, W), np.float32)] * 5)):
        js = _jsetup(sc, rca, backface_cull=case != "dyadic")
        jq = jr.bin_windows_subtile(js, rca)
        out[case] = (js, jq, rca, seeds, _outs(_jq_subtile(
            jq, js, rca, tuple(jnp.asarray(x) for x in seeds))))
    return out


def _run_subtile(js, jq, rc, seeds):
    q = raster.SubtileQueue(*[_t(x) for x in jq])
    cfg = _port_cfg(rc)
    return raster.raster_queue_subtile(
        q, _port_setup(js), cfg, seeds=None if seeds is None
        else _seeds(seeds))


@pytest.mark.parametrize("case", ["plain", "attrs_seeded"])
def test_subtile_raster_matches(subtile_refs, case):
    """K8's plain version on chord_tpu's setup and queue, and the port's
    whole sub-tile path (its own setup and stable-sorted queue)."""
    js, jq, rc, seeds, ref = subtile_refs[case]
    got = _run_subtile(js, jq, rc, seeds)
    _compare_close(got, ref)
    assert (ref[0] > 0).mean() > 0.3
    cfg = _port_cfg(rc)
    s = _psetup(subtile_refs["scene"], rc)
    own = raster.raster_queue_subtile(
        raster.bin_windows_subtile(s, cfg), s, cfg,
        seeds=None if seeds is None else _seeds(seeds))
    _compare_close(own, ref)


def test_subtile_raster_dyadic_bit_exact(subtile_refs):
    js, jq, rc, seeds, ref = subtile_refs["dyadic"]
    _compare_exact(_run_subtile(js, jq, rc, seeds), ref)
    inside = ref[0] > 0
    assert inside.mean() > 0.5 and (ref[1][inside] >> 7 >= 2).any()


def test_subtile_raster_matches_oracle(subtile_refs):
    clip, idx, valid, payload, _ = subtile_refs["scene"]
    cfg = _port_cfg(RC_ST)
    d, v, stats = raster.rasterize(_t(clip), _t(idx), _t(valid),
                                   _t(payload), cfg)
    d_ref, v_ref = jr.rasterize_oracle(clip, idx, valid, payload, W, H)
    assert int(stats["bin_overflow"]) == 0
    assert (v_ref != 0).sum() > 500
    assert np.mean(vis_to_uint32(v) != v_ref) <= 0.01
    assert np.percentile(np.abs(d.numpy() - d_ref), 99) < 1e-3


# --- K7: the brick raster ----------------------------------------------------

RC_BR = jr.RasterConfig(width=W, height=H, tile_h=16, sub_s=4,
                        pair_capacity=512, big_capacity=32, bricks=True,
                        interpret=True)


@pytest.fixture(scope="module")
def brick_refs():
    """chord_tpu's brick rasters of a random scene, without attributes and
    with attributes, seeded by the port's raster of a second scene and
    z-clipped by its raster of a third, and of the dyadic scene (same
    shapes, zero seeds, no clip)."""
    rng = np.random.default_rng(4)
    scene = _tris(400, rng, crossing=0.03)
    rc, rca = RC_BR, RC_BR._replace(with_attrs=True, z_clip=True)
    out = {"scene": scene}
    js = _jsetup(scene, rc)
    jq = jr.bin_windows(js, rc)
    out["plain"] = (js, jq, rc, None, None, _outs(_jq_queue(jq, js, rc)))
    seeds = _port_raster(_tris(200, rng), rca)
    zc = _port_raster(_tris(200, rng), rca)[0]
    zc = np.where(zc > 0, zc, 3e38).astype(np.float32)
    zero = [np.zeros((H, W), np.float32), np.zeros((H, W), np.uint32)] + \
        [np.zeros((H, W), np.float32)] * 5
    for case, sc, sd, z in (
            ("attrs_seeded_zclip", scene, seeds, zc),
            ("dyadic", _dyadic_scene(rca), zero,
             np.full((H, W), 3e38, np.float32))):
        js = _jsetup(sc, rca, backface_cull=case != "dyadic")
        jq = jr.bin_windows(js, rca)
        out[case] = (js, jq, rca, sd, z, _outs(_jq_queue(
            jq, js, rca, tuple(jnp.asarray(x) for x in sd), jnp.asarray(z))))
    return out


def _run_bricks(js, jq, rc, seeds, zc):
    return raster.raster_queue(
        raster.WorkQueue(*[_t(x) for x in jq]), _port_setup(js),
        _port_cfg(rc), seeds=None if seeds is None else _seeds(seeds),
        zclip=None if zc is None else _t(zc))


@pytest.mark.parametrize("case", ["plain", "attrs_seeded_zclip"])
def test_bricks_raster_matches(brick_refs, case):
    js, jq, rc, seeds, zc, ref = brick_refs[case]
    got = _run_bricks(js, jq, rc, seeds, zc)
    _compare_close(got, ref)
    assert (ref[0] > 0).mean() > 0.3
    if zc is not None:   # the peel rejected every fragment at or nearer
        assert (got[0].numpy()[ref[0] > np.asarray(seeds[0])] <
                zc[ref[0] > np.asarray(seeds[0])]).all()


def test_bricks_raster_dyadic_bit_exact(brick_refs):
    js, jq, rc, seeds, zc, ref = brick_refs["dyadic"]
    _compare_exact(_run_bricks(js, jq, rc, seeds, zc), ref)
    inside = ref[0] > 0
    assert inside.mean() > 0.5 and (ref[1][inside] >> 7 >= 2).any()


def test_bricks_raster_matches_oracle(brick_refs):
    clip, idx, valid, payload, _ = brick_refs["scene"]
    d, v, stats = raster.rasterize(_t(clip), _t(idx), _t(valid),
                                   _t(payload), _port_cfg(RC_BR))
    d_ref, v_ref = jr.rasterize_oracle(clip, idx, valid, payload, W, H)
    assert int(stats["bin_overflow"]) == 0
    assert (v_ref != 0).sum() > 500
    assert np.mean(vis_to_uint32(v) != v_ref) <= 0.01
    assert np.percentile(np.abs(d.numpy() - d_ref), 99) < 1e-3


def test_rasterize_stats_match():
    """rasterize()'s stats equal chord_tpu's on the flat, sub-tile and
    brick paths (binning and setup only: the raster is tested above)."""
    rng = np.random.default_rng(5)
    clip, idx, valid, payload, _ = _tris(300, rng, crossing=0.03)
    for rc in (RC_BR._replace(bricks=False), RC_ST, RC_BR):
        js = _jsetup((clip, idx, valid, payload, np.zeros((len(clip), 5),
                                                          np.float32)), rc)
        jq = (jr.bin_windows_subtile(js, rc) if rc.subtiles
              else jr.bin_windows(js, rc))
        d, v, stats = raster.rasterize(_t(clip), _t(idx), _t(valid),
                                       _t(payload), _port_cfg(rc))
        assert int(stats["bin_overflow"]) == int(jq.overflow)
        assert int(stats["binned_pairs"]) == int(jq.n_pairs)
        assert int(stats["drawn_tris"]) == int(np.asarray(js.valid).sum())
        assert stats["drawn_tris"].dtype == torch.int32
