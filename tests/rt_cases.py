"""Seeded inputs for the BVH ray tests, shared by tests/test_torch_rt.py
(the port against chord_tpu on the CPU) and tests/test_torch_cuda.py (the
card against the CPU). Imports no JAX: the GPU machine has none.
tests/test_rt.py's scene: sphere centres uniform in [-20, 20]^3, radii
in [0.2, 1.5]; ray origins uniform in [-25, 25]^3, unit directions.
"""

import numpy as np
import torch

from chord_tpu_torch.ops import rt


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
