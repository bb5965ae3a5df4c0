"""The probe rays and the dense sphere trace round as chord_tpu's compiled
frame does, on every device.

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
(worst window 0.924 at bench size). The oracle here is chord_tpu's
formula in numpy f32, summed and rooted as XLA does.
"""

import numpy as np
import torch

from chord_tpu_torch.ops import rt
from chord_tpu_torch.ops import screen_probe as sp
from chord_tpu_torch.ops._util import sqrt_rn

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
        a, b = F32(f) * F32(2.3999632297286533), F32(f) * F32(1.1)
        ca, sa = F32(np.cos(np.float64(a))), F32(np.sin(np.float64(a)))
        cb, sb = F32(np.cos(np.float64(b))), F32(np.sin(np.float64(b)))
        rz = np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]], F32)
        rx = np.array([[1, 0, 0], [0, cb, -sb], [0, sb, cb]], F32)
        rot = _dot3(rz[:, None, :], rx.T[None])            # rz @ rx
        dirs = _dot3(base[:, None, :], rot[None])          # base @ rot.T
        assert np.array_equal(sp.ray_table(f, 16), dirs)
        dirs = np.broadcast_to(dirs, (2, 3, 16, 3))
        ndot = _dot3(dirs, normal[..., None, :])[..., None]
        want = np.where(ndot < 0, -dirs, dirs)
        for frame in (f, torch.tensor(f, dtype=torch.int32)):
            got = sp.probe_ray_dirs(probes, frame, cfg).numpy()
            assert np.array_equal(got, want)
