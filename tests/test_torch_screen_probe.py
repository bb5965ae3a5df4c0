"""The ported screen-probe GI stage and SSR against chord_tpu
(chord_tpu/ops/screen_probe.py, chord_tpu/ops/ssr.py), on seeded numpy
inputs: a wavy floor in front of a camera, its probes, their SH, a moving
view and last frame's colour.

Tolerances: gathers, selections and integer outputs (probe positions,
spawn picks, masks, the packed sample counts) match exactly. Float outputs
1e-5 relative plus 1e-5 absolute on values of O(1): each is a chain of
rounded f32 operations whose reductions (einsum, sums over taps) XLA and
PyTorch order differently, and libm's exp / pow / cos / sin differ by an
ulp or two; `_weighted_resize`'s non-power-of-two path is a pair of
resampling matrices on both sides (jax.image.resize, post._linear_weights)
and within 1e-4 absolute (its test says why). `history_reproject_half` in
"tile" mode runs chord_tpu's kernel K4 in interpret mode against the
port's plain K4
(1e-5, as tests/test_torch_post.py). The world-cache inject is compared by
probe rows, as tests/test_torch_gi.py says. trace_probes (the march):
>= 99.9% of ray values within 1e-5 on chord_tpu's ray set, >= 99% on
the port's own (its test says why); at this seed every value is exact on
the shared ray set (57% of the rays miss the floor). ssr.trace: the hit
mask and hit pixels are exact on these inputs and the colour within 1e-5;
a ray step that lands on a depth-band edge could flip on an XLA FMA,
which this input does not reach.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chord_tpu.ops import gi as jgi
from chord_tpu.ops import screen_probe as jsp
from chord_tpu.ops import ssr as jssr

from chord_tpu_torch.ops import gi, screen_probe as sp, ssr
from chord_tpu_torch.utils.camera import Camera

H, W = 64, 128
TILE = 8


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _close(got, ref, rtol=1e-5, atol=1e-5):
    if isinstance(got, (tuple, list)):
        for g, r in zip(got, ref):
            _close(g, r, rtol, atol)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _unit(a):
    return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)


def _views():
    """(current, previous) no-jitter view-projections of a camera at the
    translated-world origin that moved a little."""
    cam = Camera(width=W, height=H)
    cam.position = np.array([0.0, 0.0, 0.0])
    cam.look_at(np.array([0.0, -1.0, -3.0]))
    u0 = cam.view_uniform(0)
    cam.position = np.array([0.15, 0.05, 0.1])
    cam.look_at(np.array([0.1, -1.0, -3.0]))
    u1 = cam.view_uniform(1)
    return (u1.translated_world_to_clip_nojitter.astype(np.float32),
            u1.prev_translated_world_to_clip_nojitter.astype(np.float32))


def _scene(rng, h=H, w=W):
    """A wavy floor y ~ -1.5 from x in [-3,3], z in [-9,-2]: positions,
    normals, valid (a hole), reverse-Z depth through the current view."""
    m, _ = _views()
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    x = (xs / w - 0.5) * 6.0
    z = -2.0 - (1.0 - ys / h) * 7.0
    y = -1.5 + 0.2 * np.sin(x * 2.0) * np.cos(z)
    pos = np.stack([x, y, z], -1).astype(np.float32)
    nrm = _unit(np.float32([0, 1, 0]) + rng.normal(0, 0.15, (h, w, 3)))
    valid = np.ones((h, w), bool)
    valid[10:20, 90:110] = False
    c = pos @ m[:3] + m[3]
    depth = np.where(valid, c[..., 2] / c[..., 3], 0.0).astype(np.float32)
    return pos, nrm, valid, depth


class GB:
    def __init__(self, pos, nrm, valid, rough=None):
        self.position_tw, self.normal, self.valid = pos, nrm, valid
        self.roughness = rough


def _gbufs(rng):
    pos, nrm, valid, depth = _scene(rng)
    return (GB(_j(pos), _j(nrm), _j(valid)), GB(_t(pos), _t(nrm), _t(valid)),
            depth)


def _probes(rng, frame=3):
    jg, tg, depth = _gbufs(rng)
    cfg_j, cfg_t = jsp.ScreenProbeConfig(), sp.ScreenProbeConfig()
    jp = jsp.spawn_probes(jg, _j(depth), jnp.int32(frame), cfg_j)
    tp = sp.spawn_probes(tg, _t(depth), torch.tensor(frame, dtype=torch.int32),
                         cfg_t)
    return jp, tp


def _probe_sh(rng, ph, pw):
    shc = rng.normal(0, 0.5, (ph, pw, 9, 3)).astype(np.float32)
    shc[..., 0, :] = np.abs(shc[..., 0, :]) + 1.0
    n = rng.choice([0.0, 4.0, 16.0, 64.0], (ph, pw)).astype(np.float32)
    return np.concatenate([shc.reshape(ph, pw, 27), n[..., None]], -1)


# --- setup -------------------------------------------------------------------

def test_octahedral_dirs_and_jitter_rotation_match():
    for n in (2, 4):
        np.testing.assert_array_equal(sp._octahedral_dirs(n),
                                      jsp._octahedral_dirs(n))
    for f in (0, 7, 40):
        # the port's frame ray table: the octahedral set times the
        # jitter rotation, built on the host
        want = jsp._octahedral_dirs(4) @ np.asarray(
            jsp._jitter_rotation(jnp.int32(f))).T
        _close(torch.from_numpy(sp.ray_table(f, 16)), want, atol=1e-6)


@pytest.mark.parametrize("frame", [0, 3, 13, 70])
def test_spawn_probes_match(frame):
    """The spawn is a strided pick at the frame's in-tile offset: exact."""
    jp, tp = _probes(np.random.default_rng(0), frame)
    assert tp.depth.shape == (H // TILE, W // TILE)
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_probe_ray_dirs_match():
    jp, tp = _probes(np.random.default_rng(1))
    for f in (0, 5):
        cfg = dict(rays=16)
        _close(sp.probe_ray_dirs(tp, torch.tensor(f, dtype=torch.int32),
                                 sp.ScreenProbeConfig(**cfg)),
               jsp.probe_ray_dirs(jp, jnp.int32(f),
                                  jsp.ScreenProbeConfig(**cfg)), atol=1e-6)


def test_reproject_probe_sh_matches():
    rng = np.random.default_rng(2)
    jp, tp = _probes(rng)
    ph, pw = tp.depth.shape
    prev = _probe_sh(rng, ph, pw)
    # last frame's probe depths: this frame's, slightly off, some far off
    prev_z = (tp.depth.numpy() + rng.normal(0, 0.01, (ph, pw))).astype(
        np.float32)
    _, pm = _views()
    for hv in (0.0, 1.0):
        got = sp.reproject_probe_sh(tp, _t(prev), _t(prev_z), _t(pm),
                                    torch.tensor(hv), sp.ScreenProbeConfig())
        ref = jsp.reproject_probe_sh(jp, _j(prev), _j(prev_z), _j(pm),
                                     jnp.float32(hv), jsp.ScreenProbeConfig())
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    kept = got[1].numpy() > 0
    assert 0.1 < kept.mean() < 1.0


def test_gather_probe_taps_match():
    rng = np.random.default_rng(3)
    jp, tp = _probes(rng)
    ph, pw = tp.depth.shape
    scene_rad = rng.uniform(0, 3, (ph, pw, 3)).astype(np.float32)
    sky = np.float32([0.3, 0.4, 0.6])
    got = sp.gather_probe_taps(tp, _t(scene_rad), _t(sky),
                               sp.ScreenProbeConfig())
    ref = jsp.gather_probe_taps(jp, _j(scene_rad), _j(sky),
                                jsp.ScreenProbeConfig())
    assert got[0].shape == (ph, pw, 16 + 7, 3)
    _close(got, ref, atol=1e-6)


def test_project_and_merge_matches():
    rng = np.random.default_rng(4)
    jp, tp = _probes(rng)
    ph, pw = tp.depth.shape
    rad = rng.uniform(0, 3, (ph, pw, 23, 3)).astype(np.float32)
    dirs = _unit(rng.normal(size=(ph, pw, 23, 3)))
    w = rng.uniform(0, 1, (ph, pw, 23)).astype(np.float32)
    sh_hist = rng.normal(size=(ph, pw, 9, 3)).astype(np.float32)
    n_hist = rng.choice([0.0, 10.0, 60.0], (ph, pw)).astype(np.float32)
    for weights in (None, w):
        got = sp.project_and_merge(
            _t(rad), _t(dirs), tp, _t(sh_hist), _t(n_hist),
            sp.ScreenProbeConfig(),
            weights=None if weights is None else _t(weights))
        ref = jsp.project_and_merge(
            _j(rad), _j(dirs), jp, _j(sh_hist), _j(n_hist),
            jsp.ScreenProbeConfig(),
            weights=None if weights is None else _j(weights))
        _close(got, ref)


@pytest.mark.parametrize("frame", [None, 5])
def test_inject_world_cache_matches(frame):
    rng = np.random.default_rng(5)
    jp, tp = _probes(rng)
    ph, pw = tp.depth.shape
    # 2-unit voxels: the floor's probes lie inside both cascades
    cfg = dict(cascades=2, probe_dim=8, base_voxel=2.0)
    probe_sh = _probe_sh(rng, ph, pw)
    cache = rng.normal(size=(2, 512, 28)).astype(np.float32)
    cache[..., 27] = rng.choice([0.0, 1.0], (2, 512))
    got = sp.inject_world_cache(_t(cache), _t(probe_sh), tp,
                                gi.GIConfig(**cfg), frame_index=frame)
    ref = jsp.inject_world_cache(
        _j(cache), _j(probe_sh), jp, jgi.GIConfig(**cfg),
        frame_count=None if frame is None else jnp.int32(frame))
    d = np.abs(got.numpy() - np.asarray(ref))
    rows = (d <= 1e-5 * np.maximum(1.0, np.abs(np.asarray(ref)))).all(-1)
    assert rows.mean() == 1.0, (rows.mean(), d.max())
    assert (got.numpy()[..., 27] != cache[..., 27]).any()


@pytest.mark.parametrize("fallback", ["none", "sky", "cache_sky",
                                      "traced_cache_sky"])
def test_trace_probes_matches(fallback):
    """The probe march (trace_mode "march": 16 rays, 6 steps against the
    1/4-res depth, hits from last frame's post-size colour), then the miss
    chain: the traced radiance where its confidence > 0.5, the world
    cache, the sky. Rays from chord_tpu's probe_ray_dirs go to both (the
    march's steps then round alike): radiance within 1e-5 on >= 99.9% of
    ray values; the port's own ray set once, without fallbacks, within
    1e-5 on >= 99% (a step that lands on a depth-band edge under an
    ulp-different direction may flip)."""
    rng = np.random.default_rng(11)
    jg, tg, depth = _gbufs(rng)
    cfg_j = jsp.ScreenProbeConfig(trace_mode="march", rays=16, steps=6)
    cfg_t = sp.ScreenProbeConfig(trace_mode="march", rays=16, steps=6)
    f = 3
    jp = jsp.spawn_probes(jg, _j(depth), jnp.int32(f), cfg_j)
    tp = sp.spawn_probes(tg, _t(depth), torch.tensor(f, dtype=torch.int32),
                         cfg_t)
    ph, pw = tp.depth.shape
    m, _ = _views()
    depth_lo = depth[::4, ::4]
    prev = rng.uniform(0, 3, (96, 192, 3)).astype(np.float32)
    dirs = np.asarray(jsp.probe_ray_dirs(jp, jnp.int32(f), cfg_j))
    kw_j, kw_t = {}, {}
    if "cache" in fallback:
        gcfg = dict(cascades=2, probe_dim=8, base_voxel=2.0)
        cache = rng.normal(size=(2, 512, 28)).astype(np.float32)
        cache[..., 27] = rng.choice([0.0, 1.0], (2, 512))
        kw_j.update(world_cache=_j(cache), gi_cfg=jgi.GIConfig(**gcfg))
        kw_t.update(world_cache=_t(cache), gi_cfg=gi.GIConfig(**gcfg))
    if "sky" in fallback:
        sky = np.float32([0.3, 0.4, 0.6])
        kw_j.update(sky_ambient=_j(sky))
        kw_t.update(sky_ambient=_t(sky))
    if "traced" in fallback:
        t_rad = rng.uniform(0, 2, (ph, pw, 16, 3)).astype(np.float32)
        t_conf = rng.choice([0.0, 1.0], (ph, pw, 16)).astype(np.float32)
        kw_j.update(traced_miss=(_j(t_rad), _j(t_conf)))
        kw_t.update(traced_miss=(_t(t_rad), _t(t_conf)))
    got = sp.trace_probes(tp, _t(depth_lo), _t(prev), _t(m),
                          torch.tensor(f, dtype=torch.int32), cfg_t,
                          dirs=_t(dirs), **kw_t)
    ref = jsp.trace_probes(jp, _j(depth_lo), _j(prev), _j(m), jnp.int32(f),
                           cfg_j, dirs=_j(dirs), **kw_j)
    assert got[0].shape == (ph, pw, 16, 3)
    np.testing.assert_array_equal(got[1].numpy(), dirs)
    d = np.abs(got[0].numpy() - np.asarray(ref[0]))
    assert (d <= 1e-5).mean() >= 0.999, ((d > 1e-5).mean(), d.max())
    if fallback == "none":
        # some rays hit the floor (last frame's colour), some miss (zero)
        missed = (got[0].numpy() == 0).all(-1)
        assert 0.05 < missed.mean() < 0.95
        own = sp.trace_probes(tp, _t(depth_lo), _t(prev), _t(m),
                              torch.tensor(f, dtype=torch.int32), cfg_t)
        d = np.abs(own[0].numpy() - np.asarray(ref[0]))
        assert (d <= 1e-5).mean() >= 0.99, (d > 1e-5).mean()


# --- half-res diffuse chain --------------------------------------------------

@pytest.mark.parametrize("ph,pw,h,w", [(8, 16, 32, 64), (6, 10, 15, 25),
                                       (6, 10, 14, 31)])
def test_weighted_resize_matches(ph, pw, h, w):
    """Power-of-two ratio: the shift + lerp path; 2.5x and an anisotropic
    ratio: the resampling-matrix fallback (jax.image.resize in chord_tpu,
    post._linear_weights here)."""
    rng = np.random.default_rng(6)
    planes = rng.normal(size=(ph, pw, 27)).astype(np.float32)
    wt = rng.choice([0.0, 1.0, 20.0], (ph, pw)).astype(np.float32)
    # the fallback's matrix products sum in another order than XLA's, and
    # the division by the resized weight (down to its 1e-4 floor next to
    # weightless probes) amplifies that: 1e-4 absolute there
    _close(sp._weighted_resize(_t(planes), _t(wt), (h, w)),
           jsp._weighted_resize(_j(planes), _j(wt), (h, w)),
           atol=1e-5 if h == 4 * ph else 1e-4)


def test_interpolate_half_matches():
    rng = np.random.default_rng(7)
    jp, tp = _probes(rng)
    ph, pw = tp.depth.shape
    probe_sh = _probe_sh(rng, ph, pw)
    pos, nrm, valid, _ = _scene(rng)
    nh, vh = nrm[::2, ::2], valid[::2, ::2]
    got = sp.interpolate_half(_t(probe_sh), tp, _t(nh), _t(vh),
                              sp.ScreenProbeConfig())
    ref = jsp.interpolate_half(_j(probe_sh), jp, _j(nh), _j(vh),
                               jsp.ScreenProbeConfig())
    _close(got, ref)
    assert float(got.max()) > 0.0


@pytest.mark.parametrize("mode", ["tile", "global", "gather"])
def test_history_reproject_half_matches(mode):
    """"tile" runs chord_tpu's K4 in interpret mode and the port's plain
    K4."""
    rng = np.random.default_rng(8)
    hh, wh = 48, 160
    fresh = rng.uniform(0, 2, (hh, wh, 3)).astype(np.float32)
    prev = rng.uniform(0, 2, (hh, wh, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:hh, 0:wh].astype(np.float32)
    mot = np.stack([0.02 + 0.01 * np.sin(xx / 9.0),
                    -0.03 + 0.01 * np.cos(yy / 7.0)], -1).astype(np.float32)
    disocc = (rng.uniform(size=(hh, wh)) < 0.05).astype(np.float32)
    for hv, dis in ((1.0, None), (1.0, disocc), (0.0, None)):
        got = sp.history_reproject_half(
            _t(fresh), _t(mot), _t(prev), torch.tensor(hv),
            sp.ScreenProbeConfig(history_mode=mode),
            disocclusion=None if dis is None else _t(dis))
        ref = jsp.history_reproject_half(
            _j(fresh), _j(mot), _j(prev), jnp.float32(hv),
            jsp.ScreenProbeConfig(history_mode=mode),
            disocclusion=None if dis is None else _j(dis))
        _close(got, ref)
    assert not np.allclose(got.numpy(), fresh) or hv == 0.0


def test_spatial_filter_and_bilateral_upsample_match():
    rng = np.random.default_rng(9)
    pos, nrm, valid, depth = _scene(rng)
    dh, nh = depth[::2, ::2], nrm[::2, ::2]
    diff = rng.uniform(0, 2, dh.shape + (3,)).astype(np.float32)
    for taps in (1, 2):
        _close(sp.spatial_filter_half(_t(diff), _t(dh), _t(nh),
                                      sp.ScreenProbeConfig(filter_taps=taps)),
               jsp.spatial_filter_half(_j(diff), _j(dh), _j(nh),
                                       jsp.ScreenProbeConfig(
                                           filter_taps=taps)))
    _close(sp.bilateral_upsample(_t(diff), _t(dh), _t(nh), _t(depth),
                                 _t(nrm)),
           jsp.bilateral_upsample(_j(diff), _j(dh), _j(nh), _j(depth),
                                  _j(nrm)))


# --- the specular chain ------------------------------------------------------

def _spec_inputs(rng):
    pos, nrm, valid, depth = _scene(rng, 24, 40)
    spec = rng.uniform(0, 1, (24, 40, 3)).astype(np.float32)
    spec[3, 5] = 50.0                                   # a firefly
    rough = rng.uniform(0, 0.6, (24, 40)).astype(np.float32)
    rough[:4] = 0.0                                     # mirror rows
    return pos, nrm, rough, spec, depth


def test_edge_weight_and_ggx_sample_normal_match():
    rng = np.random.default_rng(10)
    pos, nrm, rough, _, _ = _spec_inputs(rng)
    p2 = np.roll(pos, 1, 0)
    n2 = np.roll(nrm, 1, 1)
    _close(sp._edge_weight(_t(pos), _t(nrm), _t(p2), _t(n2)),
           jsp._edge_weight(_j(pos), _j(nrm), _j(p2), _j(n2)))
    v = _unit(-pos)
    u1 = rng.uniform(0, 1, rough.shape).astype(np.float32)
    u2 = rng.uniform(0, 1, rough.shape).astype(np.float32)
    got = sp.ggx_sample_normal(_t(nrm), _t(v), _t(rough), _t(u1), _t(u2))
    ref = jsp.ggx_sample_normal(_j(nrm), _j(v), _j(rough), _j(u1), _j(u2))
    _close(got, ref)
    # roughness 0 samples a 1e-4-wide lobe: the normal, nearly
    np.testing.assert_allclose(got.numpy()[:4], nrm[:4], atol=1e-3)


def test_specular_filters_match():
    rng = np.random.default_rng(11)
    pos, nrm, rough, spec, _ = _spec_inputs(rng)
    a = [_t(x) for x in (spec, pos, nrm, rough)]
    b = [_j(x) for x in (spec, pos, nrm, rough)]
    got = sp.specular_firefly_clamp(*a)
    _close(got, jsp.specular_firefly_clamp(*b))
    assert float(got[3, 5].max()) < 50.0 or rough[3, 5] == 0.0
    _close(sp.spatial_filter_specular(*a),
           jsp.spatial_filter_specular(*b))


def test_temporal_specular_matches():
    rng = np.random.default_rng(12)
    pos, nrm, rough, spec, _ = _spec_inputs(rng)
    prev = rng.uniform(0, 1, spec.shape).astype(np.float32)
    mot = rng.normal(0, 0.05, spec.shape[:2] + (2,)).astype(np.float32)
    disocc = (rng.uniform(size=rough.shape) < 0.1).astype(np.float32)
    for hv, dis in ((1.0, None), (1.0, disocc), (0.0, None)):
        _close(sp.temporal_specular(_t(spec), _t(mot), _t(prev),
                                    torch.tensor(hv), _t(rough),
                                    None if dis is None else _t(dis)),
               jsp.temporal_specular(_j(spec), _j(mot), _j(prev),
                                     jnp.float32(hv), _j(rough),
                                     None if dis is None else _j(dis)))


# --- ssr ---------------------------------------------------------------------

def test_ssr_trace_matches():
    rng = np.random.default_rng(13)
    pos, nrm, valid, depth = _scene(rng, 32, 64)
    # a wall at the back so reflected rays find something on screen
    depth = np.maximum(depth, np.where(np.arange(32)[:, None] < 10, 0.05,
                                       0.0)).astype(np.float32)
    color = rng.uniform(0, 2, (64, 128, 3)).astype(np.float32)
    m, _ = _views()
    cfg_j, cfg_t = jssr.SSRConfig(res_div=2), ssr.SSRConfig(res_div=2)
    col, conf = ssr.trace(_t(depth), _t(color), _t(pos), _t(nrm), _t(m),
                          cfg_t)
    jcol, jconf = jssr.trace(_j(depth), _j(color), _j(pos), _j(nrm), _j(m),
                             cfg_j)
    np.testing.assert_array_equal(col.numpy() > 0, np.asarray(jcol) > 0)
    _close(col, jcol)
    _close(conf, jconf)
    assert (conf.numpy() > 0).mean() > 0.01
