"""The port's BVH rays (chord_tpu_torch/ops/rt.py) against chord_tpu's
ops/rt.py and the numpy oracle, at tests/test_rt.py's sizes (200 random
spheres, 256 random rays), on the CPU.

Tolerances. BVH builds (numpy and native) and the scene BVH's node arrays:
exact (the same numpy arithmetic, the same native library). Leaf tables:
1e-6 (the AP1 conversion is a 3x3 product in each framework). Traces:
leaf ids equal on every ray; t within 1e-4 relative + 1e-4 absolute of
chord_tpu's (the same f32 formulas; XLA-CPU contracts a*b+c into FMAs and
orders the 3-term dots its own way) and, against the f32 numpy oracle,
within 1e-4 relative for the scan (the direct ray-sphere form, as
tests/test_rt.py) and 1e-3 relative + 1e-3 absolute for the dense path
(|o|^2 - 2 o.c + |c|^2 cancels at scene coordinates near 25, as
tests/test_rt.py's 1e-3 for it). Rays whose closest hit is decided within
rounding are left out of the leaf comparisons by a margin against a
float64 oracle, and counted (rt_cases.decided): a near-tie of the two nearest
entries (within 1e-2), a grazing sphere (|disc| < 5e-3) or an origin on a
sphere (|c2| < 5e-3), in squared scene units (f32 dense rounding there is
~4e-4): 1 of 256 rays at 200 spheres, 5 of 256 at 700 (at these seeds
every ray's leaf agrees even so; the largest t differences, at small t,
are 3.2e-4 relative to chord_tpu's dense path and 5.1e-4 to the oracle).
shade_hits: 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chord_tpu.ops import rt as jrt

from chord_tpu_torch import interop
from chord_tpu_torch.ops import rt
from rt_cases import decided as _decided
from rt_cases import port_bvh as _port_bvh
from rt_cases import rays as _rays
from rt_cases import spheres as _spheres


def _jax_bvh(bvh, sph):
    n = len(sph)
    return jrt.SceneBVH(
        node_sphere=jnp.asarray(bvh["sphere"]),
        node_count=jnp.asarray(bvh["count"]),
        node_leaf=jnp.asarray(bvh["leaf"]),
        leaf_albedo=jnp.ones((n, 3)), leaf_emissive=jnp.zeros((n, 3)),
        leaf_sphere=jnp.asarray(sph))


def _same_hits(got, ref, keep, rtol, atol):
    (t, leaf), (t_ref, leaf_ref) = got, ref
    t, leaf = np.asarray(t), np.asarray(leaf)
    np.testing.assert_array_equal(leaf[keep], np.asarray(leaf_ref)[keep])
    hit = keep & (leaf >= 0)
    np.testing.assert_allclose(t[hit], np.asarray(t_ref)[hit], rtol=rtol,
                               atol=atol)
    return int(hit.sum())


@pytest.mark.parametrize("n,seed", [(100, 0), (200, 0), (150, 3)])
def test_build_bvh_numpy_matches_chord_tpu(n, seed):
    sph = _spheres(n, seed)
    got, ref = rt.build_bvh_numpy(sph), jrt.build_bvh_numpy(sph)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["count"][0] == len(got["count"])
    assert sorted(got["leaf"][got["leaf"] >= 0].tolist()) == list(range(n))


@pytest.mark.parametrize("n,seed", [(150, 3), (200, 0), (875, 5)])
def test_native_bvh_build_matches_chord_tpu(n, seed):
    from chord_tpu.native import available, bvh_build
    if not available():
        pytest.skip("native toolchain unavailable")
    from chord_tpu_torch.native import bvh_build as port_bvh_build
    sph = _spheres(n, seed)
    got, ref = port_bvh_build(sph), bvh_build(sph)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("n,seed", [(200, 0), (700, 11)])
def test_trace_dense_matches(n, seed):
    """The dense path against the oracle and chord_tpu's trace_dense; 700
    leaves fill two 512-leaf chunks, the second with 324 poison rows."""
    sph = _spheres(n, seed)
    o, d = _rays(256, seed + 1)
    keep = _decided(o, d, sph)
    assert keep.sum() >= 0.9 * len(keep), (~keep).sum()
    got = rt.trace_dense(torch.from_numpy(o), torch.from_numpy(d),
                         torch.from_numpy(sph))
    assert got[1].dtype == torch.int32
    ref = jrt.trace_dense(jnp.asarray(o), jnp.asarray(d), jnp.asarray(sph))
    assert _same_hits(got, ref, keep, 1e-4, 1e-4) > 5
    assert _same_hits(got, rt.trace_brute_numpy(o, d, sph), keep, 1e-3,
                      1e-3) > 5
    if n > 512:   # a closest hit in the padded chunk
        assert bool((got[1][torch.from_numpy(keep)] >= 512).any())


@pytest.mark.parametrize("builder", ["numpy", "native"])
def test_trace_bvh_matches(builder):
    sph = _spheres(200)
    o, d = _rays(256)
    keep = _decided(o, d, sph)
    if builder == "native":
        from chord_tpu_torch.native import available, bvh_build
        if not available():
            pytest.skip("native toolchain unavailable")
        bvh = bvh_build(sph)
    else:
        bvh = rt.build_bvh_numpy(sph)
    got = rt.trace_bvh(torch.from_numpy(o), torch.from_numpy(d),
                       _port_bvh(bvh, sph))
    ref = jrt.trace_bvh(jnp.asarray(o), jnp.asarray(d), _jax_bvh(bvh, sph))
    assert _same_hits(got, ref, keep, 1e-4, 1e-4) > 5
    assert _same_hits(got, rt.trace_brute_numpy(o, d, sph), keep, 1e-4,
                      0.0) > 5


@pytest.mark.parametrize("max_steps", [5, 13])
def test_trace_bvh_step_budget_matches(max_steps):
    """With a step budget the scan stops with rays unfinished: they keep
    what they found (a miss, or not the closest), as in chord_tpu. 13 is
    no multiple of the scan's check interval."""
    sph = _spheres(200)
    o, d = _rays(256)
    keep = _decided(o, d, sph)
    bvh = rt.build_bvh_numpy(sph)
    got = rt.trace(torch.from_numpy(o), torch.from_numpy(d),
                   _port_bvh(bvh, sph), max_steps=max_steps)
    ref = jrt.trace(jnp.asarray(o), jnp.asarray(d), _jax_bvh(bvh, sph),
                    max_steps=max_steps)
    _same_hits(got, ref, keep, 1e-4, 1e-4)
    brute = rt.trace_brute_numpy(o, d, sph)[1]
    cut = (brute >= 0) & (got[1].numpy() < 0)
    assert cut.sum() > 0, "the budget cut no ray short"


def test_trace_brute_numpy_matches_chord_tpu():
    sph = _spheres(200)
    o, d = _rays(256)
    got, ref = rt.trace_brute_numpy(o, d, sph), jrt.trace_brute_numpy(o, d,
                                                                      sph)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


@pytest.mark.parametrize("n", [rt.DENSE_LEAF_LIMIT, rt.DENSE_LEAF_LIMIT + 1])
def test_trace_dispatch(monkeypatch, n):
    """trace() takes the dense path up to DENSE_LEAF_LIMIT leaf spheres
    with no step budget, the scan above it or with a budget, and counts
    its calls, its dense calls and its rays; a triangle-exact BVH of as
    many triangles (above DENSE_TRI_LIMIT) takes the scan
    (tests/test_torch_rt_tri.py holds both sides of that limit)."""
    sph = _spheres(n, seed=9)
    o, d = _rays(64, seed=10)
    bvh = _port_bvh(rt.build_bvh_numpy(sph[:8]), sph)   # nodes unused
    ran = []
    for name in ("trace_dense", "trace_bvh"):
        fn = getattr(rt, name)
        monkeypatch.setattr(rt, name, lambda *a, _f=fn, _n=name, **k: (
            ran.append(_n), _f(*a, **k))[1])
    calls, dense, rays = rt.trace.calls, rt.trace.dense, rt.trace.rays
    rt.trace(torch.from_numpy(o), torch.from_numpy(d), bvh)
    rt.trace(torch.from_numpy(o), torch.from_numpy(d), bvh, max_steps=3)
    want = "trace_dense" if n <= rt.DENSE_LEAF_LIMIT else "trace_bvh"
    assert ran == [want, "trace_bvh"]
    assert rt.trace.calls == calls + 2
    assert rt.trace.dense == dense + (want == "trace_dense")
    assert rt.trace.rays == rays + 2 * 64
    rt.trace(torch.from_numpy(o), torch.from_numpy(d),
             bvh._replace(tri_planes=torch.zeros((n, 12))))
    assert ran[-1] == "trace_bvh" and rt.trace.calls == calls + 3


def _scene(granularity):
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
    return (jrt.build_scene_bvh(jp, ji, granularity=granularity),
            rt.build_scene_bvh(pp, pi, granularity=granularity))


@pytest.mark.parametrize("granularity", ["object", "meshlet"])
def test_build_scene_bvh_matches(granularity):
    ref, got = _scene(granularity)
    from chord_tpu_torch.native import available
    assert rt.build_scene_bvh.builder == ("native" if available()
                                          else "numpy")
    for f in ("node_sphere", "node_count", "node_leaf", "leaf_sphere"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    for f in ("leaf_albedo", "leaf_emissive"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    assert got.tri_planes is None and got.leaf_normal is None
    # interop carries chord_tpu's BVH over unchanged
    carried = interop.bvh_from_numpy(
        {k: np.asarray(v) for k, v in ref._asdict().items()
         if v is not None}, device="cpu")
    for f in ("node_sphere", "node_count", "node_leaf", "leaf_albedo",
              "leaf_sphere"):
        np.testing.assert_array_equal(getattr(carried, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    if granularity == "object":
        # rays from the camera into the scene hit, as tests/test_rt.py
        rng = np.random.default_rng(2)
        d = rng.normal(size=(64, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        t, leaf = rt.trace(torch.zeros((64, 3)), torch.from_numpy(d), got)
        assert int((leaf >= 0).sum()) > 0


def test_build_scene_bvh_triangle_raises():
    """An unknown granularity raises; "triangle" (once refused) builds a
    BVH with its planes and normals (tests/test_torch_rt_tri.py holds it
    to chord_tpu's)."""
    from chord_tpu_torch.asset.procedural import build_sponza_like
    from chord_tpu_torch.rhi.meshlet_scene import build_meshlet_pools
    from chord_tpu_torch.utils.camera import Camera

    b = build_sponza_like(detail=1)
    pools = build_meshlet_pools(b, device="cpu")
    inst = b.frame_instances(Camera(64, 64), device="cpu")
    with pytest.raises(ValueError):
        rt.build_scene_bvh(pools, inst, granularity="sphere")
    bvh = rt.build_scene_bvh(pools, inst, granularity="triangle")
    n = bvh.leaf_sphere.shape[0]
    assert tuple(bvh.tri_planes.shape) == (n, 12)
    assert tuple(bvh.leaf_normal.shape) == (n, 3)


@pytest.mark.parametrize("normals", [False, True])
def test_shade_hits_matches(normals):
    rng = np.random.default_rng(4)
    n, r = 50, 300
    alb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    emis = (rng.uniform(0, 1, (n, 3)) * (rng.uniform(size=(n, 1)) < 0.2)
            ).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    t = rng.uniform(0.1, 40, r).astype(np.float32)
    leaf = rng.integers(-1, n, r).astype(np.int32)
    o, d = _rays(r, seed=5)
    sun = np.array([0.3, 0.8, 0.5], np.float32)
    sun /= np.linalg.norm(sun)
    rad_s = np.array([8.0, 7.6, 7.0], np.float32)
    amb = np.array([0.2, 0.25, 0.3], np.float32)
    extra = dict(leaf_normal=nrm) if normals else {}
    got = rt.shade_hits(
        *(torch.from_numpy(a) for a in (t, leaf, o, d)),
        rt.SceneBVH(torch.zeros((1, 4)), torch.ones(1, dtype=torch.int32),
                    torch.zeros(1, dtype=torch.int32), torch.from_numpy(alb),
                    torch.from_numpy(emis),
                    **{k: torch.from_numpy(v) for k, v in extra.items()}),
        *(torch.from_numpy(a) for a in (sun, rad_s, amb)))
    ref = jrt.shade_hits(
        *(jnp.asarray(a) for a in (t, leaf, o, d)),
        jrt.SceneBVH(jnp.zeros((1, 4)), jnp.ones(1, jnp.int32),
                     jnp.zeros(1, jnp.int32), jnp.asarray(alb),
                     jnp.asarray(emis),
                     **{k: jnp.asarray(v) for k, v in extra.items()}),
        *(jnp.asarray(a) for a in (sun, rad_s, amb)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert float(got[1].sum()) < r and float(got[0].max()) > 0.0
