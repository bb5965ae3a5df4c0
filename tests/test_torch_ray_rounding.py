"""The probe rays and the ray tests round as chord_tpu's compiled frame
does, on every device.

chord_tpu's `trace_dense` expands (o-c)·d and |o-c|^2 into per-ray terms
and the d @ c^T, o @ c^T products; on a large sphere the expansion
cancels (t off by ~1e-5 at r = 12), so the order in which each 3-term dot
is summed moves t by far more than an ulp. XLA's CPU dot and sum (without
FMA, as the bench goldens are rendered) add (p0 + p1) + p2 with one
rounding an operation, and its sqrt is rounded to nearest; a BLAS matmul
sums otherwise, and PyTorch's CPU f32 sqrt is an approximation. Two
nearly equal hits then swap: on the strip frame `sharded_all`, frame 4,
one screen probe's ray hit leaf 15 on the card and leaf 123 in chord_tpu
(t 8.228373 against 8.228368), which put a 19-level blob into the image
(worst window 0.924 at bench size). The same holds for the BVH scan's
node test (`_ray_sphere`) and triangle leaf test, the dense triangle test
(`trace_dense_tri`, six (R,3) @ (3,chunk) products), the two frame
ray tables (the screen probes' and DDGI's) and the per-pixel directions
of RTAO's fan and of the specular GI's GGX reflection, whose cos and sin
are XLA's, the C library's sinf and cosf (ops/_util.sincosf). The oracles
here are chord_tpu's formulas in numpy f32, summed and rooted as XLA does,
with the C library's trig; every comparison is bit for bit, on every ray.
"""

import functools

import numpy as np
import pytest
import torch

from chord_tpu_torch.ops import ddgi, gi, rt
from chord_tpu_torch.ops import screen_probe as sp
from chord_tpu_torch.ops._util import sqrt_rn
from chord_tpu_torch.ops.bluenoise import interleaved_gradient_noise
from chord_tpu_torch.renderer.meshlet_frame import specular_directions
from rt_cases import (libm_sincosf, rays, spheres, tri_bvh, tri_rays,
                      triangles)

F32 = np.float32


def _dot3(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + \
        a[..., 2] * b[..., 2]


def _trace_oracle(o, d, sph, chunk=512):
    """chord_tpu's trace_dense (ops/rt.py:340-385) in numpy f32."""
    pad = (-sph.shape[0]) % chunk
    sph = np.concatenate([sph, np.tile(np.array([[0, 0, 0, -1]], F32),
                                       (pad, 1))])
    od, oo = _dot3(o, d)[:, None], _dot3(o, o)[:, None]
    t_best = np.full(o.shape[0], F32(1e9), F32)
    leaf = np.full(o.shape[0], -1, np.int32)
    for base in range(0, sph.shape[0], chunk):
        c, rad = sph[base:base + chunk, :3], sph[base:base + chunk, 3]
        b = od - _dot3(d[:, None], c[None])
        c2 = ((oo - F32(2) * _dot3(o[:, None], c[None])) +
              _dot3(c, c)[None]) - (rad * rad)[None]
        disc = b * b - c2
        sq = np.sqrt(np.maximum(disc, F32(0)))
        t = np.where(c2 < 0, F32(0), -b - sq)
        hit = (disc >= 0) & ((-b + sq) > 0) & (t > F32(1e-4)) & \
            (rad[None] > 0)
        th = np.where(hit, t, F32(np.inf))
        j = th.argmin(1)
        tc = th[np.arange(len(j)), j]
        take = tc < t_best
        t_best = np.where(take, tc, t_best)
        leaf = np.where(take, j + base, leaf).astype(np.int32)
    return t_best, leaf


def _jitter_oracle(base, f, tilt):
    """chord_tpu's base @ _jitter_rotation(f).T (ops/screen_probe.py,
    ops/ddgi.py) in numpy f32: the angles' cos and sin the C library's
    (XLA's f32 cos and sin; the f64 value rounded is an ulp off on frames
    20, 32, 41 of DDGI's table, 16, 56, 57 of the probes'), each product
    summed (p0 + p1) + p2."""
    a, b = F32(f) * F32(2.3999632297286533), F32(f) * F32(tilt)
    (sa, sb), (ca, cb) = libm_sincosf(np.array([a, b], F32))
    rz = np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]], F32)
    rx = np.array([[1, 0, 0], [0, cb, -sb], [0, sb, cb]], F32)
    rot = _dot3(rz[:, None, :], rx.T[None])            # rz @ rx
    return _dot3(base[:, None, :], rot[None])          # base @ rot.T


def test_sqrt_rn_is_rounded_to_nearest():
    x = (np.random.default_rng(0).random(200_000) * 100).astype(F32)
    want = np.sqrt(x.astype(np.float64)).astype(F32)
    assert np.array_equal(np.sqrt(x), want)
    assert np.array_equal(sqrt_rn(torch.from_numpy(x)).numpy(), want)


def test_trace_dense_rounds_as_xla():
    rng = np.random.default_rng(1)
    o = (rng.standard_normal((3000, 3)) * 5).astype(F32)
    d = rng.standard_normal((3000, 3)).astype(F32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    sph = np.concatenate([rng.standard_normal((700, 3)) * 20,
                          rng.uniform(0.5, 15, (700, 1))], 1).astype(F32)
    t, leaf = rt.trace_dense(torch.from_numpy(o), torch.from_numpy(d),
                             torch.from_numpy(sph))
    want_t, want_leaf = _trace_oracle(o, d, sph)
    assert (want_leaf >= 0).mean() > 0.5
    assert np.array_equal(t.numpy(), want_t)
    assert np.array_equal(leaf.numpy(), want_leaf)


def test_trace_dense_keeps_xlas_closest_of_two_near_hits():
    """The bench-size ray of `sharded_all` frame 4 (strip 1, probe
    (12, 203), ray 0) against its two leaves: in float64 leaf 15 is 7e-6
    nearer, in chord_tpu's f32 expansion leaf 123; the port keeps
    chord_tpu's."""
    o = np.array([[4.267123222351074, -0.50967937707901, 2.433910608291626]],
                 F32)
    d = np.array([[-0.7341502904891968, 0.09083010256290436,
                   -0.6728842854499817]], F32)
    sph = np.zeros((124, 4), F32)
    sph[:, 3] = -1.0
    sph[15] = [-1.293060302734375, 8.982179641723633, -11.949999809265137,
               12.448665618896484]
    sph[123] = [-2.724308490753174, 0.5, -2.897291898727417,
                1.0072828531265259]
    want_t, want_leaf = _trace_oracle(o, d, sph)
    assert want_leaf[0] == 123
    t, leaf = rt.trace_dense(torch.from_numpy(o), torch.from_numpy(d),
                             torch.from_numpy(sph))
    assert int(leaf[0]) == 123 and float(t[0]) == float(want_t[0])


def test_probe_ray_dirs_round_as_xla():
    """The frame's ray table: the angles' cos and sin rounded from f64,
    the rotations' products summed (p0 + p1) + p2; the hemisphere flip
    by the same ordered dot."""
    rng = np.random.default_rng(2)
    normal = rng.standard_normal((2, 3, 3)).astype(F32)
    probes = sp.ProbeState(pos_tw=torch.zeros(2, 3, 3),
                           normal=torch.from_numpy(normal),
                           depth=torch.zeros(2, 3),
                           valid=torch.ones(2, 3, dtype=torch.bool))
    cfg = sp.ScreenProbeConfig(rays=16)
    base = sp._octahedral_dirs(4).astype(F32)
    for f in range(16):
        dirs = _jitter_oracle(base, f, 1.1)
        assert np.array_equal(sp.ray_table(f, 16), dirs)
        dirs = np.broadcast_to(dirs, (2, 3, 16, 3))
        ndot = _dot3(dirs, normal[..., None, :])[..., None]
        want = np.where(ndot < 0, -dirs, dirs)
        for frame in (f, torch.tensor(f, dtype=torch.int32)):
            got = sp.probe_ray_dirs(probes, frame, cfg).numpy()
            assert np.array_equal(got, want)


def test_probe_ray_table_rounds_as_xla():
    """The screen probes' table (tilt 1.1) for frames 0-63: the frames
    whose XLA cos or sin is an ulp from the f64 value (16, 56, 57)
    included."""
    base = sp._octahedral_dirs(4).astype(F32)
    for f in range(64):
        assert np.array_equal(sp.ray_table(f, 16),
                              _jitter_oracle(base, f, 1.1)), f


# --- RTAO's fan and the specular GI's GGX reflection, per pixel --------------

def _surface(h=64, w=128, seed=9):
    """Seeded camera-relative positions, unit normals, roughness."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-20, 20, (h, w, 3)).astype(F32)
    n = rng.standard_normal((h, w, 3))
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(F32)
    return pos, n, rng.uniform(0.05, 0.9, (h, w)).astype(F32)


def _basis(n):
    """chord_tpu's branchless tangent basis (Duff et al.) of (...,3)."""
    s = np.where(n[..., 2:3] >= 0, F32(1), F32(-1))
    a = F32(-1) / (s + n[..., 2:3])
    b = n[..., 0:1] * n[..., 1:2] * a
    t1 = np.concatenate([F32(1) + s * n[..., 0:1] ** 2 * a, s * b,
                         -s * n[..., 0:1]], -1)
    t2 = np.concatenate([b, s + n[..., 1:2] ** 2 * a, -n[..., 1:2]], -1)
    return t1, t2


def _rtao_oracle(n, rot, k):
    """chord_tpu's gi.rtao fan (ops/gi.py:359-367) in numpy f32: ray i of
    k at azimuth rot + (i + 0.5) * pi (3 - sqrt 5), elevation cos
    sqrt((i + 0.5) / k)."""
    t1, t2 = _basis(n)
    out = []
    for i in range(k):
        phi = rot + F32((i + 0.5) * (np.pi * (3.0 - np.sqrt(5.0))))
        ct = np.float32(np.sqrt((i + 0.5) / k))
        st = np.float32(np.sqrt(1.0 - ct * ct))
        sn, cs = libm_sincosf(phi)
        out.append(t1 * (cs * st)[..., None] + t2 * (sn * st)[..., None] +
                   n * ct)
    return out


def _ggx_oracle(pos, n, rough, u1, u2):
    """chord_tpu's specular directions (renderer/meshlet_frame.py:969-984,
    ops/screen_probe.py:657-680) in numpy f32, the norm and the dots
    summed (p0 + p1) + p2 -> (h, the reflected view)."""
    v = -pos / np.maximum(np.sqrt(_dot3(pos, pos))[..., None], F32(1e-6))
    a = np.maximum(rough * rough, F32(1e-4))[..., None]
    u1c = np.clip(u1, F32(0), F32(0.999))[..., None]
    t2 = (a * a) * u1c / (F32(1) - u1c)
    cos_t = F32(1) / np.sqrt(F32(1) + t2)
    sin_t = np.sqrt(np.maximum(F32(1) - cos_t * cos_t, F32(0)))
    sn, cs = libm_sincosf(F32(2.0 * np.pi) * u2[..., None])
    t1v, t2v = _basis(n)
    h = t1v * (cs * sin_t) + t2v * (sn * sin_t) + n * cos_t
    h = h / np.maximum(np.sqrt(_dot3(h, h))[..., None], F32(1e-8))
    d = F32(2) * _dot3(v, h)[..., None] * h - v
    h = np.where(_dot3(d, n)[..., None] > F32(1e-3), h, n)
    return h, F32(2) * _dot3(v, h)[..., None] * h - v


def test_rtao_directions_round_as_xla(monkeypatch):
    """RTAO's 4 rays a pixel at 128x64, frames 0-7 (each frame's IGN
    azimuth): the directions rt.trace is given, bit for bit."""
    pos, n, _ = _surface()
    cfg = gi.GIConfig(ao_mode="rtao")
    seen = []

    @functools.wraps(rt.trace)
    def spy(o, d, b, t_max=1e9, max_steps=None):
        seen.append(d.clone())
        shape = o.shape[:-1]
        return torch.full(shape, float(t_max)), torch.full(
            shape, -1, dtype=torch.int32)
    monkeypatch.setattr(rt, "trace", spy)
    for f in range(8):
        seen.clear()
        gi.rtao(_t(pos), _t(n), None, cfg,
                frame_index=torch.tensor(f, dtype=torch.int32))
        ign = interleaved_gradient_noise(64, 128, f, device="cpu").numpy()
        want = _rtao_oracle(n, ign * F32(2.0) * F32(np.pi), cfg.rtao_rays)
        assert len(seen) == cfg.rtao_rays
        for got, w in zip(seen, want):
            assert np.array_equal(got.numpy(), w), f


def test_specular_directions_round_as_xla():
    """The specular GI's GGX half-vector and reflection at 128x64, frames
    0-7 (the IGN pair of each frame), bit for bit."""
    pos, n, rough = _surface(seed=10)
    for f in range(8):
        h, refl = specular_directions(_t(pos), _t(n), _t(rough),
                                      torch.tensor(f, dtype=torch.int32))
        u1 = interleaved_gradient_noise(64, 128, f, device="cpu").numpy()
        u2 = interleaved_gradient_noise(64, 128, f + 31,
                                        device="cpu").numpy()
        want_h, want_refl = _ggx_oracle(pos, n, rough, u1, u2)
        assert np.array_equal(h.numpy(), want_h), f
        assert np.array_equal(refl.numpy(), want_refl), f


# --- the BVH scan's sphere and triangle tests, the dense triangle test ------

def _ray_sphere_oracle(o, d, sph):
    """chord_tpu's _ray_sphere (ops/rt.py:246-258) in numpy f32."""
    oc = o - sph[..., :3]
    b = _dot3(oc, d)
    c2 = _dot3(oc, oc) - sph[..., 3] * sph[..., 3]
    disc = b * b - c2
    sq = np.sqrt(np.maximum(disc, F32(0)))
    t_entry = np.where(c2 < 0, F32(0), -b - sq)
    return (disc >= 0) & ((-b + sq) > 0), t_entry


def _dense_tri_oracle(o, d, planes, t_max=F32(1e9), chunk=512):
    """chord_tpu's trace_dense_tri (ops/rt.py:300-337) in numpy f32: every
    (R,3) @ (3,chunk) product a dot summed (p0 + p1) + p2, and
    u = (o.n1) + t (d.n1) + d1 in that association."""
    pad = (-planes.shape[0]) % chunk
    planes = np.concatenate([planes, np.zeros((pad, 12), F32)])
    o3, d3 = o[:, None], d[:, None]
    t_best = np.full(o.shape[0], F32(t_max), F32)
    leaf = np.full(o.shape[0], -1, np.int32)
    for base in range(0, planes.shape[0], chunk):
        pc = planes[base:base + chunk][None]
        n, n1, n2 = pc[..., 0:3], pc[..., 4:7], pc[..., 8:11]
        den = _dot3(d3, n)
        safe = np.abs(den) > F32(1e-12)
        t = -(_dot3(o3, n) + pc[..., 3]) / np.where(safe, den, F32(1))
        u = (_dot3(o3, n1) + t * _dot3(d3, n1)) + pc[..., 7]
        v = (_dot3(o3, n2) + t * _dot3(d3, n2)) + pc[..., 11]
        hit = safe & (t > F32(1e-4)) & (u >= 0) & (v >= 0) & (u + v <= 1)
        th = np.where(hit, t, F32(np.inf))
        j = th.argmin(1)
        tc = th[np.arange(len(j)), j]
        take = tc < t_best
        t_best = np.where(take, tc, t_best)
        leaf = np.where(take, j + base, leaf).astype(np.int32)
    return t_best, leaf


def _scan_oracle(o, d, node_sphere, node_count, node_leaf, planes=None,
                 t_max=F32(1e9), max_steps=None):
    """chord_tpu's trace_bvh (ops/rt.py:388-459) in numpy f32: the
    lock-step skip-pointer scan, at most `max_steps` steps (default
    min(nodes, 384), 1536 over triangles), every 3-term dot summed
    (p0 + p1) + p2, the leaf's t = -(o.n + dn) / (d.n), p = o + t d,
    u = p.n1 + d1."""
    m = node_sphere.shape[0]
    if max_steps is None:
        max_steps = min(m, 1536 if planes is not None else 384)
    i = np.zeros(o.shape[0], np.int32)
    t_best = np.full(o.shape[0], F32(t_max), F32)
    leaf = np.full(o.shape[0], -1, np.int32)
    for _ in range(max_steps):
        active = i < m
        if not active.any():
            break
        ii = np.minimum(i, m - 1)
        cnt, lf = node_count[ii], node_leaf[ii]
        hit, t_in = _ray_sphere_oracle(o, d, node_sphere[ii])
        useful = hit & (t_in < t_best) & active
        is_leaf = lf >= 0
        if planes is not None:
            pc = planes[np.maximum(lf, 0)]
            den = _dot3(d, pc[:, 0:3])
            safe = np.abs(den) > F32(1e-12)
            t_leaf = -(_dot3(o, pc[:, 0:3]) + pc[:, 3]) / \
                np.where(safe, den, F32(1))
            p = o + t_leaf[:, None] * d
            u = _dot3(p, pc[:, 4:7]) + pc[:, 7]
            v = _dot3(p, pc[:, 8:11]) + pc[:, 11]
            take = (useful & is_leaf & safe & (t_leaf > F32(1e-4)) &
                    (u >= 0) & (v >= 0) & (u + v <= 1) & (t_leaf < t_best))
        else:
            t_leaf = t_in
            take = useful & is_leaf & (t_in > F32(1e-4))
        t_best = np.where(take, t_leaf, t_best)
        leaf = np.where(take, lf, leaf)
        i = np.where(active, i + np.where(useful & ~is_leaf, 1, cnt),
                     i).astype(np.int32)
    return t_best, leaf


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_ddgi_ray_table_rounds_as_xla(monkeypatch):
    """DDGI's rays: the Fibonacci set times the frame's rotation (tilt
    1.7), on the host, for frames 0-63; ddgi_update traces exactly that
    table."""
    fib = ddgi.spherical_fibonacci(64)
    for f in range(64):
        assert np.array_equal(ddgi.ray_table(f, 64),
                              _jitter_oracle(fib, f, 1.7)), f
    v0, e1, e2 = (x * F32(0.3) for x in triangles(60, 7))
    bvh, _ = tri_bvh(v0, e1, e2)
    cfg = ddgi.DDGIConfig(cascades=2, probe_dim=(2, 2, 2), rays=16,
                          update_phases=2)
    seen = []
    trace = rt.trace

    @functools.wraps(trace)     # rt.trace counts on the module's function
    def spy(o, d, b, t_max=1e9, max_steps=None):
        seen.append(d.clone())
        return trace(o, d, b, t_max, max_steps)
    monkeypatch.setattr(rt, "trace", spy)
    st = ddgi.DDGIState.empty(cfg, device="cpu")
    one = torch.ones(3)
    for f in (0, 1, 37):
        st = ddgi.ddgi_update(st, bvh, one / 3 ** 0.5, one, one * 0.3,
                              torch.tensor(f, dtype=torch.int32), cfg,
                              frame_index=f)
        want = _jitter_oracle(ddgi.spherical_fibonacci(16), f, 1.7)
        got = seen[-1].numpy()
        assert got.shape == (4, 16, 3)
        assert np.array_equal(got, np.broadcast_to(want, got.shape)), f


def test_ray_sphere_rounds_as_xla():
    """The scan's node test on near-tangent rays: the radius within 1e-6
    relative of the ray's distance from the centre, so hit / miss and the
    entry turn on the last bits of b, c2 and the root."""
    rng = np.random.default_rng(5)
    o = (rng.standard_normal((20000, 3)) * 10).astype(F32)
    d = rng.standard_normal((20000, 3)).astype(F32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    c = (rng.standard_normal((20000, 3)) * 10).astype(F32)
    oc = (o - c).astype(np.float64)
    b = (oc * d).sum(1)
    dist = np.sqrt(np.maximum((oc * oc).sum(1) - b * b, 0.0))
    r = (dist * (1 + rng.uniform(-1e-6, 1e-6, 20000))).astype(F32)
    sph = np.concatenate([c, r[:, None]], 1).astype(F32)
    want_hit, want_t = _ray_sphere_oracle(o, d, sph)
    assert 0.2 < want_hit.mean() < 0.8
    hit, t = rt._ray_sphere(_t(o), _t(d), _t(sph))
    assert np.array_equal(hit.numpy(), want_hit)
    assert np.array_equal(t.numpy(), want_t)


def _edge_rays(v0, e1, e2, m, seed):
    """Rays aimed at points within ~1e-6 of a triangle's edge: half on
    u + v = 1, half on u = 0."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-25, 25, (m, 3))
    k = rng.integers(0, len(v0), m)
    s = rng.uniform(0, 1, m)
    eps = rng.uniform(-1e-6, 1e-6, m)
    far = np.arange(m) < m // 2
    u = np.where(far, s + eps, eps)
    v = np.where(far, 1.0 - s, s)
    a, b, c = (x.astype(np.float64)[k] for x in (v0, e1, e2))
    d = a + u[:, None] * b + v[:, None] * c - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(F32), d.astype(F32)


@pytest.fixture(scope="module")
def soup():
    v0, e1, e2 = triangles(700, 0)
    o1, d1 = tri_rays(v0, e1, e2, 1500, 1)
    o2, d2 = _edge_rays(v0, e1, e2, 1500, 2)
    bvh, _ = tri_bvh(v0, e1, e2)
    return (np.concatenate([o1, o2]), np.concatenate([d1, d2]), bvh)


def test_trace_dense_tri_rounds_as_xla(soup):
    """700 triangles: two 512-triangle chunks; half the rays aimed at an
    edge."""
    o, d, bvh = soup
    planes = bvh.tri_planes.numpy()
    want_t, want_leaf = _dense_tri_oracle(o, d, planes)
    assert (want_leaf >= 0).mean() > 0.5
    t, leaf = rt.trace_dense_tri(_t(o), _t(d), bvh.tri_planes)
    assert np.array_equal(t.numpy(), want_t)
    assert np.array_equal(leaf.numpy(), want_leaf)


@pytest.mark.parametrize("max_steps", [None, 40])
def test_trace_bvh_triangles_round_as_xla(soup, max_steps):
    """The scan over the soup's triangle BVH at its default budget (1,536
    steps: every ray finishes) and at 40 steps (most rays unfinished): t
    and leaf on every ray."""
    o, d, bvh = soup
    want_t, want_leaf = _scan_oracle(
        o, d, bvh.node_sphere.numpy(), bvh.node_count.numpy(),
        bvh.node_leaf.numpy(), bvh.tri_planes.numpy(), max_steps=max_steps)
    t, leaf = rt.trace_bvh(_t(o), _t(d), bvh, max_steps=max_steps)
    assert (want_leaf >= 0).mean() > (0.5 if max_steps is None else 0.05)
    assert np.array_equal(t.numpy(), want_t)
    assert np.array_equal(leaf.numpy(), want_leaf)


@pytest.mark.parametrize("max_steps", [None, 30])
def test_trace_bvh_spheres_round_as_xla(max_steps):
    """The scan over a 700-sphere BVH at its default budget (384 steps)
    and at 30: t and leaf on every ray, the rays that graze a sphere
    included."""
    sph = spheres(700, 0)
    o, d = rays(3000, 1)
    b = rt.build_bvh_numpy(sph)
    bvh = rt.SceneBVH(node_sphere=_t(b["sphere"]), node_count=_t(b["count"]),
                      node_leaf=_t(b["leaf"]), leaf_albedo=torch.ones(700, 3),
                      leaf_emissive=torch.zeros(700, 3),
                      leaf_sphere=_t(sph))
    want_t, want_leaf = _scan_oracle(o, d, b["sphere"], b["count"],
                                     b["leaf"], max_steps=max_steps)
    t, leaf = rt.trace_bvh(_t(o), _t(d), bvh, max_steps=max_steps)
    assert (want_leaf >= 0).mean() > (0.1 if max_steps is None else 0.05)
    assert np.array_equal(t.numpy(), want_t)
    assert np.array_equal(leaf.numpy(), want_leaf)
