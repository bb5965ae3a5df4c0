"""The specular GI chain and the per-object motion delta against chord_tpu,
bit for bit, on seeded 128x64 inputs.

chord_tpu's bench goldens are its frames compiled without FMA
(XLA_FLAGS=--xla_cpu_max_isa=SSE4_2); the port rounds each f32 operation
as that build does. A subprocess (this file run as a script) jits
chord_tpu's functions under that flag on the same numpy arrays, since the
tier-1 run's XLA keeps FMA:
- the specular chain: the firefly clamp (its edge weights, its 4x4 tile
  mean, on a plane of whole tiles and on one XLA pads), the spatial and
  temporal filters, SSR's march (the border fade, toward_cam), the world
  cache's radiance (its 9-term SH dots), the edge
  weight alone, the frame's specular N.V, the colour-space products
  (the BVH leaves' albedo, the sun's radiance, luminance), and the
  resolve's normal (the normal map's cross products, lax.rsqrt: a root
  and a division rounded to nearest without FMA, where the card's rsqrtf
  is an approximation);
- the short sites: SSAO (its tap's length, dot and radius factor),
  pixel_view_dirs.
The motion delta inv(M) @ M_prev (ops/shading.rigid_delta: OpenBLAS's LU
and triangular solves, XLA's batched dot, each with its fused
multiply-adds) and the float power (ops/_util.powf: the C library's powf
with XLA's flush to zero) round the same under either build, so they are
also held in process, and the power against the C library itself.
Tolerance: none (bit for bit)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chord_tpu_torch.ops import (_util, colorspace, gi, screen_probe,
                                 shading, ssr)
from chord_tpu_torch.renderer import meshlet_frame as mf
from rt_cases import libm_powf

H, W = 64, 128
HERE = os.path.dirname(os.path.abspath(__file__))
NO_FMA = "--xla_cpu_max_isa=SSE4_2"


def rigid_mats(rng, n: int):
    """n seeded rigid (O,4,4) f32 object matrices in chord_tpu's row-vector
    convention (scaled rotation, translation up to +-80) and the previous
    frame's (a tenth moved by up to 0.2)."""
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, a, b, c = q.T
    rot = np.stack([1 - 2 * (b * b + c * c), 2 * (a * b - c * w),
                    2 * (a * c + b * w), 2 * (a * b + c * w),
                    1 - 2 * (a * a + c * c), 2 * (b * c - a * w),
                    2 * (a * c - b * w), 2 * (b * c + a * w),
                    1 - 2 * (a * a + b * b)], -1).reshape(n, 3, 3)
    m = np.zeros((n, 4, 4))
    m[:, :3, :3] = rot * rng.uniform(0.5, 3.0, (n, 1, 1))
    m[:, 3, :3] = rng.uniform(-80, 80, (n, 3))
    m[:, 3, 3] = 1.0
    mp = m.copy()
    moved = rng.random(n) < 0.1
    mp[moved, 3, :3] += rng.uniform(-0.2, 0.2, (int(moved.sum()), 3))
    return m.astype(np.float32), mp.astype(np.float32)


def inputs() -> dict:
    """A seeded plane of a gently curved wall seen from the origin, with
    noisy normals, specular radiance (one firefly), roughness (mirror
    rows), motion, history, depth, last frame's colour, a projection, a
    world cache, and rigid instance matrices."""
    rng = np.random.default_rng(23)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    pos = np.stack([xx * 0.05 - 3.0, np.sin(xx * 0.1) * 0.5 + yy * 0.02,
                    -5.0 - np.cos(yy * 0.07)], -1)
    pos = pos + rng.normal(0, 0.01, pos.shape)
    n = rng.normal(0, 0.1, (H, W, 3)) + [0.0, 0.0, 1.0]
    spec = rng.uniform(0, 2, (H, W, 3))
    spec[5, 7] = 60.0
    rough = rng.uniform(0, 0.6, (H, W))
    rough[:3] = 0.0
    f, near = 1.0 / np.tan(0.5), 0.1
    proj = np.array([[f * H / W, 0, 0, 0], [0, f, 0, 0], [0, 0, 0, -1],
                     [0, 0, near, 0]])
    m, mp = rigid_mats(rng, 875)
    x = dict(pos=pos, nrm=n / np.linalg.norm(n, axis=-1, keepdims=True),
             spec=spec, rough=rough, motion=rng.normal(0, 0.01, (H, W, 2)),
             prev=rng.uniform(0, 2, (H, W, 3)),
             disocc=(rng.random((H, W)) < 0.1) * 1.0,
             depth=rng.uniform(0.01, 0.5, (H, W)),
             color=rng.uniform(0, 1, (H * 8, W * 8, 3)), proj=proj,
             clip_to_tw=np.linalg.inv(proj) + rng.normal(0, 1e-3, (4, 4)),
             cache=rng.normal(0, 1, (2, 8 ** 3, 28)),
             mats=m, mats_prev=mp)
    x["cache"][..., 27] = rng.random((2, 8 ** 3)) > 0.3
    return {k: np.asarray(v, np.float32) for k, v in x.items()}


# chord_tpu's side: each function jitted (run in the subprocess)
def jax_outputs(x: dict) -> dict:
    from chord_tpu.ops import colorspace as jcs
    from chord_tpu.ops import gi as jgi
    from chord_tpu.ops import screen_probe as jsp
    from chord_tpu.ops import ssr as jssr
    from chord_tpu.renderer import meshlet_frame as jmf

    def nov(p, n):     # chord_tpu meshlet_frame.py:1033-1036
        return jnp.clip(jnp.sum(-p / jnp.maximum(jnp.linalg.norm(
            p, axis=-1, keepdims=True), 1e-6) * n, -1), 1e-3, 1.0)

    j = jax.jit
    pos, nrm, rough, spec = x["pos"], x["nrm"], x["rough"], x["spec"]
    cfg = jgi.GIConfig(cascades=2, probe_dim=8, ao_radius=1.5)
    out = dict(
        edge_weight=j(jsp._edge_weight)(pos, nrm, np.roll(pos, 1, 0),
                                        np.roll(nrm, 1, 0)),
        firefly=j(jsp.specular_firefly_clamp)(spec, pos, nrm, rough),
        firefly_padded=j(jsp.specular_firefly_clamp)(
            *(a[:H - 2, :W - 2] for a in (spec, pos, nrm, rough))),
        srgb_to_ap1=j(jcs.srgb_to_acescg)(spec),
        cross=j(jnp.cross)(pos, nrm),
        rsqrt=j(jax.lax.rsqrt)(spec * spec + 1e-6),
        luminance=j(jcs.luminance_ap1)(spec),
        spatial=j(jsp.spatial_filter_specular)(spec, pos, nrm, rough),
        temporal=j(lambda *a: jsp.temporal_specular(
            *a[:4], a[4], disocclusion=a[5]))(
                spec, x["motion"], x["prev"], np.float32(1.0), rough,
                x["disocc"]),
        nov=j(nov)(pos, nrm),
        ssao=j(lambda *a: jgi.ssao(*a, cfg))(x["depth"], pos, nrm),
        view_dirs=j(lambda m: jmf.pixel_view_dirs(H, W, m))(x["clip_to_tw"]),
        delta=j(lambda a, b: jnp.einsum("oij,ojk->oik", jnp.linalg.inv(a),
                                        b))(x["mats"], x["mats_prev"]))
    out["ssr_col"], out["ssr_conf"] = j(lambda *a: jssr.trace(
        *a, jssr.SSRConfig(res_div=8)))(x["depth"], x["color"], pos, nrm,
                                       x["proj"])
    out["radiance"], out["confidence"] = j(lambda *a: jgi.sample_radiance(
        *a, cfg))(x["cache"], pos * 0.3, nrm, np.zeros(3, np.float32))
    return {k: np.asarray(v) for k, v in out.items()}


def port_outputs(x: dict) -> dict:
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    pos, nrm, rough, spec = t["pos"], t["nrm"], t["rough"], t["spec"]
    cfg = gi.GIConfig(cascades=2, probe_dim=8, ao_radius=1.5)
    out = dict(
        edge_weight=screen_probe._edge_weight(
            pos, nrm, torch.roll(pos, 1, 0), torch.roll(nrm, 1, 0)),
        firefly=screen_probe.specular_firefly_clamp(spec, pos, nrm, rough),
        firefly_padded=screen_probe.specular_firefly_clamp(
            *(a[:H - 2, :W - 2] for a in (spec, pos, nrm, rough))),
        srgb_to_ap1=colorspace.srgb_to_acescg(spec),
        cross=shading._cross(pos, nrm),
        rsqrt=_util.rsqrt_rn(spec * spec + 1e-6),
        luminance=colorspace.luminance_ap1(spec),
        spatial=screen_probe.spatial_filter_specular(spec, pos, nrm, rough),
        temporal=screen_probe.temporal_specular(
            spec, t["motion"], t["prev"], torch.tensor(1.0), rough,
            disocclusion=t["disocc"]),
        nov=mf.specular_nov(pos, nrm),
        ssao=gi.ssao(t["depth"], pos, nrm, cfg),
        view_dirs=mf.pixel_view_dirs(H, W, t["clip_to_tw"]),
        delta=shading.rigid_delta(t["mats"], t["mats_prev"]))
    out["ssr_col"], out["ssr_conf"] = ssr.trace(
        t["depth"], t["color"], pos, nrm, t["proj"],
        ssr.SSRConfig(res_div=8))
    out["radiance"], out["confidence"] = gi.sample_radiance(
        t["cache"], pos * 0.3, nrm, torch.zeros(3), cfg)
    return {k: v.numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """chord_tpu's outputs, jitted without FMA in a subprocess."""
    d = tmp_path_factory.mktemp("specular_rounding")
    src, dst = str(d / "in.npz"), str(d / "out.npz")
    x = inputs()
    np.savez(src, **x)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=" ".join([os.environ.get("XLA_FLAGS", ""),
                                   NO_FMA]).strip(),
               PYTHONPATH=os.pathsep.join(
                   [HERE, os.path.dirname(HERE)] +
                   [v for v in [os.environ.get("PYTHONPATH")] if v]))
    subprocess.run([sys.executable, os.path.abspath(__file__), src, dst],
                   env=env, check=True, timeout=600)
    with np.load(dst) as z:
        return x, {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def port(reference):
    return port_outputs(reference[0])


CHAIN = ("edge_weight", "firefly", "firefly_padded", "spatial", "temporal",
         "ssr_col", "ssr_conf", "radiance", "confidence", "nov",
         "srgb_to_ap1", "luminance", "cross", "rsqrt", "ssao", "view_dirs",
         "delta")


@pytest.mark.parametrize("name", CHAIN)
def test_chain_rounds_as_chord_tpu_without_fma(reference, port, name):
    want, got = reference[1][name], port[name]
    assert got.shape == want.shape and got.dtype == want.dtype
    off = got.view(np.int32) != want.view(np.int32)
    assert not off.any(), (int(off.sum()), off.size,
                           float(np.abs(got - want).max()))


def test_the_chain_has_live_values(reference, port):
    """The inputs reach every branch the chain holds: edge weights
    between 0 and 1, SSR hits and misses, cache hits and misses, the
    firefly clipped, mirror rows passed through."""
    w = port["edge_weight"]
    assert 0.05 < float((w > 1e-3).mean()) < 0.999
    conf = port["ssr_conf"]
    assert 0.05 < float((conf > 0).mean()) < 0.95
    assert 0.05 < float(port["confidence"].mean()) < 0.95
    x = reference[0]
    assert port["firefly"][5, 7].max() < x["spec"][5, 7].max() / 4
    np.testing.assert_array_equal(port["firefly"][:3], x["spec"][:3])


def test_motion_delta_rounds_as_jitted_chord_tpu():
    """rigid_delta against chord_tpu's jnp.linalg.inv and einsum jitted
    in this process (LAPACK's LU and solves, the runtime's batched dot:
    the same bits with or without FMA), on rigid matrices and on general
    ones whose pivots move, where torch.linalg.inv and matmul differ."""
    rng = np.random.default_rng(7)
    m, mp = rigid_mats(rng, 875)
    g = (rng.normal(size=(500, 4, 4)) *
         rng.uniform(0.01, 100, (500, 1, 1))).astype(np.float32)
    gp = (g + rng.normal(size=g.shape) * 0.01).astype(np.float32)
    fn = jax.jit(lambda a, b: jnp.einsum("oij,ojk->oik", jnp.linalg.inv(a),
                                         b))
    for a, b in ((m, mp), (g, gp), (g, g)):
        want = np.asarray(fn(a, b))
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        got = shading.rigid_delta(ta, tb).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
        old = torch.matmul(torch.linalg.inv(ta), tb).numpy()
        assert (old != want).mean() > 0.2


def test_motion_delta_is_made_once_a_table():
    """The frame's motion_delta: rigid_delta's value, the same tensor
    again for the same table, made anew for a table changed in place or
    for other tensors."""
    m, mp = (torch.from_numpy(a) for a in rigid_mats(
        np.random.default_rng(3), 16))
    first = shading.motion_delta(m, mp)
    assert torch.equal(first, shading.rigid_delta(m, mp))
    assert shading.motion_delta(m, mp) is first
    mp[0, 3, 0] += 1.0
    moved = shading.motion_delta(m, mp)
    assert moved is not first
    assert torch.equal(moved, shading.rigid_delta(m, mp))
    other = shading.motion_delta(m.clone(), mp)
    assert other is not moved and torch.equal(other, moved)


def _fetch_x(delta, obj, pos, col, vp, vp_prev, width):
    """The specular history fetch's x (temporal_specular's _pixel_history)
    from each candidate's motion: its previous position through its
    object's delta (the resolve's row-vector product), both projected
    (shading._project_xy), in f32 in the frame's order -> (motion x, px)."""
    f = np.float32
    d = delta[obj].reshape(-1, 16)
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    prev = np.stack([x * d[:, 0] + y * d[:, 4] + z * d[:, 8] + d[:, 12],
                     x * d[:, 1] + y * d[:, 5] + z * d[:, 9] + d[:, 13],
                     x * d[:, 2] + y * d[:, 6] + z * d[:, 10] + d[:, 14]], 1)

    def proj(p, m):
        c = p[:, 0:1] * m[0] + p[:, 1:2] * m[1] + p[:, 2:3] * m[2] + m[3]
        wc = np.where(np.abs(c[:, 3:4]) > 1e-8, c[:, 3:4], f(1.0))
        return c[:, :2] / wc
    mx = (proj(pos, vp) - proj(prev, vp_prev))[:, 0]
    return mx, (col.astype(f) + f(0.5)) - mx * f(width) * f(0.5)


def test_history_fetch_follows_chord_tpus_motion_delta():
    """The branch that held all_4k frame 7's window at 0.995136: in frame
    6 the specular history fetch's trunc(x) at plane texel (75, 56) read
    55.0000038 in chord_tpu and 54.9999924 in the port, whose motion came
    through torch.linalg.inv and matmul (tests/bench_parity.py specular
    all_4k 6). Over seeded objects (every one moved), points and columns
    of the 4K specular plane (320 wide), that delta moves some fetches to
    the neighbouring texel; rigid_delta fetches chord_tpu's texel on every
    candidate, and temporal_specular then returns chord_tpu's value where
    the old motion returns another."""
    rng = np.random.default_rng(31)
    m, _ = rigid_mats(rng, 875)
    mp = m.copy()
    mp[:, 3, :3] += rng.uniform(-0.5, 0.5, (875, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b: jnp.einsum(
        "oij,ojk->oik", jnp.linalg.inv(a), b))(m, mp))
    tm, tmp = torch.from_numpy(m), torch.from_numpy(mp)
    got = shading.rigid_delta(tm, tmp).numpy()
    old = torch.matmul(torch.linalg.inv(tm), tmp).numpy()
    f = 1.0 / np.tan(0.5)
    vp = np.array([[f * 9 / 16, 0, 0, 0], [0, f, 0, 0], [0, 0, 0, -1],
                   [0, 0, 0.1, 0]], np.float32)
    vp_prev = vp.copy()
    vp_prev[3] += np.array([0.01, -0.005, 0, 0], np.float32)
    n = 400_000
    obj = rng.integers(0, 875, n)
    pos = np.stack([rng.uniform(-20, 20, n), rng.uniform(-5, 5, n),
                    rng.uniform(-60, -2, n)], 1).astype(np.float32)
    col = rng.integers(0, 320, n)
    xs = {k: _fetch_x(d, obj, pos, col, vp, vp_prev, 320)
          for k, d in (("want", want), ("got", got), ("old", old))}
    np.testing.assert_array_equal(xs["got"][0], xs["want"][0])
    flip = np.trunc(xs["old"][1]) != np.trunc(xs["want"][1])
    assert flip.sum() >= 10, int(flip.sum())
    # those candidates through temporal_specular, one plane row each: a
    # fresh plane whose neighbourhood clamp leaves the history alone, a
    # history whose neighbouring texels differ
    spec = torch.from_numpy(rng.uniform(0.5, 1.5, (1, 320, 3)).astype(
        np.float32))
    prev = 1.0 + 0.01 * (torch.arange(320) % 7).float()[None, :, None] \
        .expand(1, 320, 3).contiguous()
    rough = torch.full((1, 320), 0.4)
    for i in np.nonzero(flip)[0]:
        out = {}
        for name in ("want", "got", "old"):
            motion = torch.zeros((1, 320, 2))
            motion[0, col[i], 0] = float(xs[name][0][i])
            out[name] = screen_probe.temporal_specular(
                spec, motion, prev, torch.tensor(1.0), rough)[0, col[i]]
        assert torch.equal(out["got"], out["want"])
        assert not torch.equal(out["old"], out["want"])


def test_powf_is_the_c_librarys_with_xlas_flush():
    """powf_plain against the C library's powf (DAZ on x, FTZ on the
    result, as XLA's CPU threads run) on seeded bases of every range and
    the edge cases, for the edge weight's 8 and other exponents; and
    against chord_tpu's jitted x ** 8.0."""
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.random(1 << 14), rng.random(1 << 12) ** 40,
                        rng.uniform(1, 200, 1 << 12),
                        [0.0, 1.0, 2.0 ** -126, 1e-45, 1.5e-5, np.inf]]
                       ).astype(np.float32)
    for y in (8.0, 0.5, 2.5, 16.0):
        got = _util.powf_plain(torch.from_numpy(x), y).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      libm_powf(x, y).view(np.int32))
    j = np.asarray(jax.jit(lambda v: v ** 8.0)(x))
    got = _util.powf(torch.from_numpy(x), 8.0).numpy()
    np.testing.assert_array_equal(got.view(np.int32), j.view(np.int32))
    assert (got != (torch.from_numpy(x) ** 8.0).numpy()).any()
    nan = _util.powf_plain(torch.tensor([np.nan, -1.0]), 8.0)
    assert bool(torch.isnan(nan).all())


def test_powf_refuses_what_it_does_not_compute():
    with pytest.raises(ValueError, match="float32"):
        _util.powf_plain(torch.zeros(3, dtype=torch.float64), 8.0)
    for y in (0.0, -1.0, float("inf")):
        with pytest.raises(ValueError, match="y > 0"):
            _util.powf_plain(torch.zeros(3), y)


if __name__ == "__main__":      # the reference's subprocess
    with np.load(sys.argv[1]) as z:
        np.savez(sys.argv[2], **jax_outputs({k: z[k] for k in z.files}))
