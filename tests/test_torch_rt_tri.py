"""The port's triangle-exact BVH leaves (chord_tpu_torch/ops/rt.py,
granularity "triangle") against chord_tpu's ops/rt.py and the float64
Moller-Trumbore oracle, on the CPU.

Inputs: a seeded soup of 300 triangles in [-20, 20]^3 and 512 rays, half
aimed inside a random triangle (tests/rt_cases.py), and the tiny atrium's
root cut (7,256 triangles, under DENSE_TRI_LIMIT).

Tolerances. The scene BVH's node arrays: exact (the same float64 numpy
and the same native builder); planes, spheres, normals and albedo within
1e-6 (the same numpy rounded once; the AP1 conversion is a 3x3 product in
each framework). Traces: leaf ids exact on the rays rt_cases.tri_decided
keeps (no triangle in front with a barycentric within 1e-3 of an edge,
no near-parallel hit, the two nearest hits 1e-2 apart: 506 of 512 at
these seeds); t within 1e-4 relative + 1e-4 absolute of chord_tpu's (the
same f32 formulas, XLA-CPU's FMAs and dot order apart) and within 2e-4
absolute + 1e-4 relative of the float64 oracle (the planes are rounded
to f32: at these seeds the largest difference is 7.5e-5 absolute).
shade_hits: 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chord_tpu.ops import rt as jrt

from chord_tpu_torch import interop
from chord_tpu_torch.ops import rt
from rt_cases import tri_bvh, tri_decided, tri_rays, triangles


def _jax(bvh):
    return jrt.SceneBVH(**{f: None if v is None else jnp.asarray(v.numpy())
                           for f, v in bvh._asdict().items()})


def _oracle(o, d, v0, e1, e2):
    return rt.trace_brute_tri_numpy(*(x.astype(np.float64)
                                      for x in (o, d, v0, e1, e2)))


def _check(got, ref, keep, rtol, atol):
    (t, leaf), (t_ref, leaf_ref) = got, ref
    t, leaf = np.asarray(t), np.asarray(leaf)
    np.testing.assert_array_equal(leaf[keep], np.asarray(leaf_ref)[keep])
    hit = keep & (leaf >= 0)
    np.testing.assert_allclose(t[hit], np.asarray(t_ref)[hit], rtol=rtol,
                               atol=atol)
    return int(hit.sum())


@pytest.fixture(scope="module")
def soup():
    v0, e1, e2 = triangles(300, 0)
    o, d = tri_rays(v0, e1, e2, 512, 1)
    keep = tri_decided(o, d, v0, e1, e2)
    assert keep.sum() >= 0.95 * len(keep)
    bvh, _ = tri_bvh(v0, e1, e2)
    return dict(tris=(v0, e1, e2), rays=(o, d), keep=keep, bvh=bvh)


def test_tri_planes_match(soup):
    v0, e1, e2 = (x.astype(np.float64) for x in soup["tris"])
    np.testing.assert_array_equal(rt._tri_planes_np(v0, e1, e2),
                                  jrt._tri_planes_np(v0, e1, e2))


@pytest.mark.parametrize("chunk", [512, 128])
def test_trace_dense_tri_matches(soup, chunk):
    """Against chord_tpu's trace_dense_tri and the oracle; chunk 128
    spreads the 300 triangles over three chunks, the last padded."""
    o, d = soup["rays"]
    planes = soup["bvh"].tri_planes
    got = rt.trace_dense_tri(torch.from_numpy(o), torch.from_numpy(d),
                             planes, chunk=chunk)
    assert got[1].dtype == torch.int32
    ref = jrt.trace_dense_tri(jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(planes.numpy()), chunk=chunk)
    assert _check(got, ref, soup["keep"], 1e-4, 1e-4) > 200
    assert _check(got, _oracle(o, d, *soup["tris"]), soup["keep"], 1e-4,
                  2e-4) > 200


def test_trace_bvh_triangle_leaves_match(soup):
    """The scan with triangle leaves (its default budget 1536 steps)
    against chord_tpu's and the oracle; a short budget leaves rays
    unfinished as chord_tpu's does."""
    o, d = soup["rays"]
    got = rt.trace_bvh(torch.from_numpy(o), torch.from_numpy(d), soup["bvh"])
    ref = jrt.trace_bvh(jnp.asarray(o), jnp.asarray(d), _jax(soup["bvh"]))
    assert _check(got, ref, soup["keep"], 1e-4, 1e-4) > 200
    assert _check(got, _oracle(o, d, *soup["tris"]), soup["keep"], 1e-4,
                  2e-4) > 200
    short = rt.trace_bvh(torch.from_numpy(o), torch.from_numpy(d),
                         soup["bvh"], max_steps=9)
    ref = jrt.trace_bvh(jnp.asarray(o), jnp.asarray(d), _jax(soup["bvh"]),
                        max_steps=9)
    _check(short, ref, soup["keep"], 1e-4, 1e-4)
    assert ((got[1] >= 0) & (short[1] < 0)).sum() > 0


def test_trace_brute_tri_numpy_matches_chord_tpu(soup):
    o, d = soup["rays"]
    got = rt.trace_brute_tri_numpy(o, d, *soup["tris"])
    ref = jrt.trace_brute_tri_numpy(o, d, *soup["tris"])
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


@pytest.mark.parametrize("n", [rt.DENSE_TRI_LIMIT, rt.DENSE_TRI_LIMIT + 1])
def test_trace_dispatch_triangle(monkeypatch, soup, n):
    """A triangle BVH takes trace_dense_tri up to DENSE_TRI_LIMIT
    triangles with no step budget, the scan above it or with a budget;
    the dense calls count in trace.dense."""
    o, d = soup["rays"]
    bvh = soup["bvh"]
    reps = -(-n // 300)
    bvh = bvh._replace(tri_planes=bvh.tri_planes.repeat(reps, 1)[:n])
    ran = []
    for name in ("trace_dense_tri", "trace_bvh", "trace_dense"):
        fn = getattr(rt, name)
        monkeypatch.setattr(rt, name, lambda *a, _f=fn, _n=name, **k: (
            ran.append(_n), _f(*a, **k))[1])
    calls, dense = rt.trace.calls, rt.trace.dense
    o_t, d_t = torch.from_numpy(o[:32]), torch.from_numpy(d[:32])
    rt.trace(o_t, d_t, bvh)
    rt.trace(o_t, d_t, bvh, max_steps=4)
    want = "trace_dense_tri" if n <= rt.DENSE_TRI_LIMIT else "trace_bvh"
    assert ran == [want, "trace_bvh"]
    assert rt.trace.calls == calls + 2
    assert rt.trace.dense == dense + (want == "trace_dense_tri")


def _atrium():
    from chord_tpu.asset.procedural import build_sponza_like as jax_sponza
    from chord_tpu.rhi.meshlet_scene import build_meshlet_pools as jax_pools
    from chord_tpu.utils.camera import Camera as JCamera

    from chord_tpu_torch.asset.procedural import build_sponza_like
    from chord_tpu_torch.rhi.meshlet_scene import build_meshlet_pools
    from chord_tpu_torch.utils.camera import Camera

    out = []
    for sponza, pools_fn, cam_cls, kw in (
            (jax_sponza, jax_pools, JCamera, {}),
            (build_sponza_like, build_meshlet_pools, Camera,
             {"device": "cpu"})):
        b = sponza(detail=1)
        cam = cam_cls(width=64, height=64)
        cam.position = np.array([-15.0, 4.0, 3.0])
        out.append((pools_fn(b, **kw), b.frame_instances(cam, **kw)))
    (jp, ji), (pp, pi) = out
    return (jrt.build_scene_bvh(jp, ji, granularity="triangle"),
            rt.build_scene_bvh(pp, pi, granularity="triangle"))


@pytest.fixture(scope="module")
def atrium():
    return _atrium()


def test_build_scene_bvh_triangle_matches(atrium):
    ref, got = atrium
    from chord_tpu_torch.native import available
    assert rt.build_scene_bvh.builder == ("native" if available()
                                          else "numpy")
    assert got.tri_planes.shape[0] == 7256 <= rt.DENSE_TRI_LIMIT
    for f in ("node_sphere", "node_count", "node_leaf"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    for f in ("leaf_sphere", "tri_planes", "leaf_normal", "leaf_albedo",
              "leaf_emissive"):
        assert getattr(got, f).dtype == torch.float32, f
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)


def test_triangle_bvh_round_trip_and_shade(atrium):
    """chord_tpu's triangle BVH through interop.bvh_from_numpy: every
    field equal; rays from inside the atrium traced by both packages on it
    (the dense route and the scan) hit the same triangles, and shade_hits
    with the true normals agrees."""
    ref, _ = atrium
    carried = interop.bvh_from_numpy(
        {k: np.asarray(v) for k, v in ref._asdict().items()
         if v is not None}, device="cpu")
    for f in rt.SceneBVH._fields:
        np.testing.assert_array_equal(getattr(carried, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    rng = np.random.default_rng(3)
    o = (np.array([0.0, 4.0, 0.0]) + rng.uniform(-2, 2, (256, 3))
         ).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    t, leaf = rt.trace(to, td, carried)
    jt, jleaf = jrt.trace(jo, jd, ref)
    same = leaf.numpy() == np.asarray(jleaf)
    assert same.mean() >= 0.99 and int((leaf >= 0).sum()) > 80
    ts, leaf_s = rt.trace(to, td, carried, max_steps=1536)
    assert float((leaf_s == leaf).float().mean()) >= 0.99
    sun = jnp.asarray([0.3, 0.8, 0.5]) / np.linalg.norm([0.3, 0.8, 0.5])
    args = (sun, jnp.asarray([8.0, 7.6, 7.0]), jnp.asarray([0.2, 0.25, 0.3]))
    jrad, jconf = jrt.shade_hits(jt, jleaf, jo, jd, ref, *args)
    rad, conf = rt.shade_hits(torch.from_numpy(np.array(jt)),
                              torch.from_numpy(np.array(jleaf)), to, td,
                              carried, *(torch.from_numpy(np.array(a))
                                         for a in args))
    np.testing.assert_allclose(rad.numpy(), np.asarray(jrad), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(conf.numpy(), np.asarray(jconf))
