"""Seeded inputs for the BVH ray tests, shared by tests/test_torch_rt.py
(the port against chord_tpu on the CPU) and tests/test_torch_cuda.py (the
card against the CPU). Imports no JAX: the GPU machine has none.
tests/test_rt.py's scene: sphere centres uniform in [-20, 20]^3, radii
in [0.2, 1.5]; ray origins uniform in [-25, 25]^3, unit directions.
"""

import ctypes
import ctypes.util

import numpy as np
import torch

from chord_tpu_torch.ops import rt


def libm_sincosf(x):
    """The C library's sinf and cosf of the f32 array x (what chord_tpu's
    XLA calls for an f32 sin or cos on the CPU) -> (sin, cos)."""
    libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    out = []
    for name in ("sinf", "cosf"):
        fn = getattr(libm, name)
        fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
        out.append(np.array([fn(float(v)) for v in np.ravel(x)],
                            np.float32).reshape(np.shape(x)))
    return out


def libm_powf(x, y):
    """The C library's powf of the f32 array x and the f32 y, with XLA's
    CPU flush to zero (DAZ on x, FTZ on the result): what chord_tpu's XLA
    computes for an f32 x ** y with a float y."""
    libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    fn = libm.powf
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float,
                                               ctypes.c_float]
    xs = np.ravel(np.asarray(x, np.float32))
    out = np.array([0.0 if abs(v) < 2.0 ** -126 else fn(float(v), y)
                    for v in xs], np.float32)
    out[np.abs(out) < 2.0 ** -126] = 0.0
    return out.reshape(np.shape(x))


def spheres(n=200, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-20, 20, (n, 3))
    r = rng.uniform(0.2, 1.5, (n, 1))
    return np.concatenate([c, r], 1).astype(np.float32)


def rays(m=256, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-25, 25, (m, 3)).astype(np.float32)
    d = rng.normal(size=(m, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def decided(o, d, sph):
    """Rays whose closest hit no f32 rounding can move -> bool (R,). In
    float64, a ray is left out when the two nearest sphere entries lie
    within 1e-2, or a sphere is grazed (|disc| < 5e-3) or holds the
    origin on its surface (|c2| < 5e-3), in squared scene units: f32
    rounding of the dense path's |o|^2 - 2 o.c + |c|^2 at coordinates
    near 25 is ~4e-4."""
    o64, d64, s64 = (a.astype(np.float64) for a in (o, d, sph))
    oc = o64[:, None, :] - s64[None, :, :3]
    b = (oc * d64[:, None, :]).sum(-1)
    c2 = (oc * oc).sum(-1) - s64[None, :, 3] ** 2
    disc = b * b - c2
    sq = np.sqrt(np.maximum(disc, 0.0))
    t_entry = np.where(c2 < 0.0, 0.0, -b - sq)
    hit = (disc >= 0.0) & ((-b + sq) > 0.0) & (t_entry > 1e-4)
    t = np.sort(np.where(hit, t_entry, np.inf), axis=1)
    with np.errstate(invalid="ignore"):       # inf - inf on misses
        tie = np.isfinite(t[:, 1]) & (t[:, 1] - t[:, 0] < 1e-2)
    edge = ((np.abs(disc) < 5e-3) | (np.abs(c2) < 5e-3)).any(1)
    return ~(tie | edge)


def port_bvh(bvh, sph):
    n = len(sph)
    return rt.SceneBVH(
        node_sphere=torch.from_numpy(bvh["sphere"]),
        node_count=torch.from_numpy(bvh["count"]),
        node_leaf=torch.from_numpy(bvh["leaf"]),
        leaf_albedo=torch.ones((n, 3)), leaf_emissive=torch.zeros((n, 3)),
        leaf_sphere=torch.from_numpy(sph))


def triangles(n=300, seed=0):
    """A triangle soup -> (v0, e1, e2) f32 (n,3) each: centroids uniform
    in [-20, 20]^3, corners up to 2.5 from them."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-20, 20, (n, 1, 3))
    v = (c + rng.uniform(-2.5, 2.5, (n, 3, 3))).astype(np.float32)
    return v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]


def tri_rays(v0, e1, e2, m=512, seed=1):
    """Rays from origins uniform in [-25, 25]^3: half aimed at a random
    point inside a random triangle, half in random directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-25, 25, (m, 3))
    k = rng.integers(0, len(v0), m)
    uv = rng.uniform(0, 1, (m, 2))
    uv = np.where(uv.sum(1, keepdims=True) > 1, 1 - uv, uv)
    target = v0[k] + uv[:, :1] * e1[k] + uv[:, 1:] * e2[k]
    d = np.where(np.arange(m)[:, None] < m // 2, target - o,
                 rng.normal(size=(m, 3)))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def tri_decided(o, d, v0, e1, e2, margin=1e-3):
    """Rays whose closest triangle no f32 rounding can change -> bool
    (R,): in float64 (Moller-Trumbore), a ray is left out when any
    triangle in front of its origin has a barycentric coordinate within
    `margin` of an edge, meets it near-parallel (|det| < 1e-6), or the two
    nearest hits lie within 1e-2."""
    o64, d64 = o.astype(np.float64)[:, None], d.astype(np.float64)[:, None]
    a, b, c = (x.astype(np.float64)[None] for x in (v0, e1, e2))
    p = np.cross(d64, c)
    det = (b * p).sum(-1)
    inv = 1.0 / np.where(np.abs(det) > 1e-30, det, 1.0)
    s = o64 - a
    u = (s * p).sum(-1) * inv
    q = np.cross(s, b)
    v = (d64 * q).sum(-1) * inv
    t = (c * q).sum(-1) * inv
    bary = np.minimum(np.minimum(u, v), 1.0 - u - v)
    front = t > 1e-4
    edge = (front & (np.abs(bary) < margin)).any(1)
    flat = (front & (np.abs(det) < 1e-6)).any(1)
    hit_t = np.sort(np.where(front & (bary >= 0), t, np.inf), axis=1)
    with np.errstate(invalid="ignore"):
        tie = np.isfinite(hit_t[:, 1]) & (hit_t[:, 1] - hit_t[:, 0] < 1e-2)
    return ~(edge | flat | tie)


def tri_bvh(v0, e1, e2):
    """The port's triangle SceneBVH of a soup: bounding spheres about the
    centroid, build_bvh_numpy's nodes, Baldwin-Weber planes (float64,
    rounded once), unit normals -> (SceneBVH, spheres (N,4))."""
    a, b, c = (x.astype(np.float64) for x in (v0, e1, e2))
    center = a + (b + c) / 3.0
    rad = np.maximum(np.linalg.norm(a - center, axis=1),
                     np.maximum(np.linalg.norm(a + b - center, axis=1),
                                np.linalg.norm(a + c - center, axis=1)))
    sph = np.concatenate([center, rad[:, None]], 1).astype(np.float32)
    nrm = np.cross(b, c)
    bvh = port_bvh(rt.build_bvh_numpy(sph), sph)
    return bvh._replace(
        tri_planes=torch.from_numpy(rt._tri_planes_np(a, b, c)),
        leaf_normal=torch.from_numpy(
            (nrm / np.linalg.norm(nrm, axis=1, keepdims=True))
            .astype(np.float32))), sph
