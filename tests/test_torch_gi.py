"""The ported SH, env-BRDF LUT and world-cache GI functions against
chord_tpu (chord_tpu/ops/{sh,brdf_lut,gi}.py), on seeded numpy inputs.

Tolerances: integer outputs (probe indices, in-bounds masks, the cell a
point lands in, counts) match exactly. Float outputs: 1e-5 relative plus
1e-6 absolute where each value is a few rounded operations (f32 einsum /
reduction order differs between XLA and PyTorch by an ulp or two); the
BRDF LUT as its test says. The world cache is compared as the share of
cells (a cascade's probe row) that agree within 1e-5, which must be 1.0
here, plus a bound on the rest: a point on a cell edge (floor(g + 0.5))
may land one cell over where XLA-CPU contracts a*b+c into an FMA, and then
a whole probe row differs (none of this test's seeds does; the frame test
allows it).

RTAO (on a triangle soup and a sphere set, with and without the
per-frame azimuth turn, chord_tpu's jitted noise fed to the port): >= 99%
of pixels within 1e-5, every pixel within one ray's weight (a ray that
grazes an edge may hit in one framework only); at these seeds the worst
pixel is 2.7e-5 off (the sphere entry's f32 rounding at small t, divided
by the radius) and no ray flips.

The scatter-add is `index_put_(accumulate=True)`, which on a CUDA tensor
PyTorch routes through a sort and sums each run of equal indices in order,
so the cache does not change from run to run on the card (held there by
tests/test_torch_cuda.py) and sums in the CPU's order.
"""

from collections import namedtuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chord_tpu.ops import brdf_lut as jbrdf
from chord_tpu.ops import gi as jgi
from chord_tpu.ops import sh as jsh

from chord_tpu_torch.ops import brdf_lut, gi, sh

G = namedtuple("G", "position_tw normal valid")
CFG = dict(cascades=2, probe_dim=8)


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def _close(got, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _unit(rng, *shape):
    d = rng.normal(size=shape + (3,)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _cache(rng, cfg):
    c = rng.normal(size=jgi.sh_size(cfg)).astype(np.float32)
    c[..., jgi.NFL] = rng.choice([0.0, 0.0, 1.0, 3.0],
                                 size=c.shape[:2]).astype(np.float32)
    return c


def _cells_agree(got, ref):
    """-> share of probe rows equal within 1e-5, worst |diff|."""
    d = np.abs(got.numpy() - np.asarray(ref))
    rows = (d <= 1e-5 * np.maximum(1.0, np.abs(np.asarray(ref)))).all(-1)
    return rows.mean(), d.max()


# --- sh ----------------------------------------------------------------------

def test_sh_basis_projection_and_eval_match():
    rng = np.random.default_rng(0)
    d = _unit(rng, 32, 16)
    rad = rng.uniform(0, 4, (32, 16, 3)).astype(np.float32)
    w = rng.uniform(0, 1, (32, 16)).astype(np.float32)
    _close(sh.sh_basis(_t(d)), jsh.sh_basis(jnp.asarray(d)))
    for weights in (None, w):
        ref = jsh.project(jnp.asarray(rad), jnp.asarray(d),
                          None if weights is None else jnp.asarray(weights))
        got = sh.project(_t(rad), _t(d),
                         None if weights is None else _t(weights))
        _close(got, ref, atol=1e-5)
    coeffs = rng.normal(size=(32, 9, 3)).astype(np.float32)
    n = _unit(rng, 32)
    _close(sh.eval_radiance(_t(coeffs), _t(n)),
           jsh.eval_radiance(jnp.asarray(coeffs), jnp.asarray(n)), atol=1e-5)
    _close(sh.eval_irradiance(_t(coeffs), _t(n)),
           jsh.eval_irradiance(jnp.asarray(coeffs), jnp.asarray(n)),
           atol=1e-5)


def test_sh_pack_unpack_round_trip():
    """Packing is a reshape and a concatenation: exact, both ways."""
    rng = np.random.default_rng(1)
    coeffs = rng.normal(size=(4, 6, 9, 3)).astype(np.float32)
    n = rng.uniform(0, 64, (4, 6)).astype(np.float32)
    packed = sh.pack(_t(coeffs), _t(n))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jsh.pack(jnp.asarray(coeffs),
                                            jnp.asarray(n))))
    c2, n2 = sh.unpack(packed)
    np.testing.assert_array_equal(c2.numpy(), coeffs)
    np.testing.assert_array_equal(n2.numpy(), n)
    jc, jn = jsh.unpack(jnp.asarray(packed.numpy()))
    np.testing.assert_array_equal(np.asarray(jc), coeffs)
    np.testing.assert_array_equal(np.asarray(jn), n)


# --- brdf_lut ----------------------------------------------------------------

def test_hammersley_matches():
    np.testing.assert_array_equal(brdf_lut._hammersley(64),
                                  jbrdf._hammersley(64))


def test_env_brdf_lut_matches():
    """Against chord_tpu's LUT run op by op (jax.disable_jit) within 1e-6;
    its scanned (compiled) body contracts a*b+c into FMAs, which the
    1/(NoH NoV) factor amplifies in the grazing rows of the smoothest
    column: against that within 1e-3 relative."""
    import jax

    with jax.disable_jit():
        eager = np.asarray(jbrdf.build_env_brdf_lut(16))
    scanned = np.asarray(jbrdf.build_env_brdf_lut(16))
    got = brdf_lut.build_env_brdf_lut(16, device="cpu")
    assert got.shape == eager.shape == (32, 32, 2)
    np.testing.assert_allclose(got.numpy(), eager, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), scanned, rtol=1e-3, atol=2e-5)
    assert float(got.sum(-1).max()) <= 1.0 + 1e-6


def test_env_specular_and_analytic_fit_match():
    rng = np.random.default_rng(2)
    lut = np.asarray(jbrdf.build_env_brdf_lut(16))
    f0 = rng.uniform(0, 1, (24, 40, 3)).astype(np.float32)
    rough = rng.uniform(0, 1, (24, 40)).astype(np.float32)
    nov = rng.uniform(1e-3, 1, (24, 40)).astype(np.float32)
    j = [jnp.asarray(a) for a in (f0, rough, nov)]
    t = [_t(a) for a in (f0, rough, nov)]
    _close(brdf_lut.env_specular(_t(lut), *t),
           jbrdf.env_specular(jnp.asarray(lut), *j))
    _close(brdf_lut.env_specular_analytic(*t),
           jbrdf.env_specular_analytic(*j))


# --- gi ----------------------------------------------------------------------

@pytest.mark.parametrize("cascade", [0, 1, 2])
def test_probe_coords_and_wrap_index_match(cascade):
    rng = np.random.default_rng(3)
    cfg_j, cfg_t = jgi.GIConfig(**CFG), gi.GIConfig(**CFG)
    pos = rng.uniform(-6, 6, (500, 3)).astype(np.float32)
    anchor = np.float32([0.3, -0.2, 0.1])
    g, inb = gi._probe_coords(_t(pos), cascade, cfg_t, _t(anchor))
    jg, jinb = jgi._probe_coords(jnp.asarray(pos), cascade, cfg_j,
                                 jnp.asarray(anchor))
    _close(g, jg, rtol=0, atol=0)
    np.testing.assert_array_equal(inb.numpy(), np.asarray(jinb))
    cell = torch.floor(g + 0.5).to(torch.int32)
    np.testing.assert_array_equal(
        gi._wrap_index(cell, cfg_t).numpy(),
        np.asarray(jgi._wrap_index(jnp.asarray(cell.numpy()), cfg_j)))


def _surfels(rng, n=256):
    pos = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    rad = rng.uniform(0, 2, (n, 3)).astype(np.float32)
    nrm = _unit(rng, n)
    valid = rng.uniform(size=n) < 0.8
    return pos, rad, nrm, valid


@pytest.mark.parametrize("only", [None, 1])
def test_inject_surfels_matches(only):
    rng = np.random.default_rng(4)
    cfg_j, cfg_t = jgi.GIConfig(**CFG), gi.GIConfig(**CFG)
    cache = _cache(rng, cfg_j)
    args = _surfels(rng)
    anchor = np.zeros(3, np.float32)
    ref = jgi.inject_surfels(jnp.asarray(cache),
                             *[jnp.asarray(a) for a in args],
                             jnp.asarray(anchor), cfg_j, only_cascade=only)
    got = gi.inject_surfels(_t(cache), *[_t(a) for a in args], _t(anchor),
                            cfg_t, only_cascade=only)
    share, worst = _cells_agree(got, ref)
    assert share == 1.0, (share, worst)
    # the splat reached probes of every injected cascade
    touched = (got.numpy()[..., jgi.NFL] != cache[..., jgi.NFL]).sum(1)
    assert (touched[[only] if only is not None else [0, 1]] > 0).all()


def test_propagate_matches():
    rng = np.random.default_rng(5)
    cfg_j, cfg_t = jgi.GIConfig(**CFG), gi.GIConfig(**CFG)
    cache = _cache(rng, cfg_j)
    _close(gi.propagate(_t(cache), cfg_t),
           jgi.propagate(jnp.asarray(cache), cfg_j))


@pytest.mark.parametrize("trilinear", [False, True])
def test_sample_irradiance_matches(trilinear):
    rng = np.random.default_rng(6)
    cfg_j = jgi.GIConfig(**CFG, trilinear=trilinear)
    cfg_t = gi.GIConfig(**CFG, trilinear=trilinear)
    cache = _cache(rng, cfg_j)
    pos = rng.uniform(-3, 3, (20, 24, 3)).astype(np.float32)
    nrm = _unit(rng, 20, 24)
    anchor = np.zeros(3, np.float32)
    irr, conf = gi.sample_irradiance(_t(cache), _t(pos), _t(nrm),
                                     _t(anchor), cfg_t)
    jirr, jconf = jgi.sample_irradiance(jnp.asarray(cache), jnp.asarray(pos),
                                        jnp.asarray(nrm), jnp.asarray(anchor),
                                        cfg_j)
    _close(irr, jirr, atol=1e-5)
    _close(conf, jconf)
    assert (conf.numpy() > 0).mean() > 0.2


def test_sample_radiance_matches():
    rng = np.random.default_rng(7)
    cfg_j, cfg_t = jgi.GIConfig(**CFG), gi.GIConfig(**CFG)
    cache = _cache(rng, cfg_j)
    pos = rng.uniform(-3, 3, (20, 24, 3)).astype(np.float32)
    d = _unit(rng, 20, 24)
    anchor = np.zeros(3, np.float32)
    rad, conf = gi.sample_radiance(_t(cache), _t(pos), _t(d), _t(anchor),
                                   cfg_t)
    jrad, jconf = jgi.sample_radiance(jnp.asarray(cache), jnp.asarray(pos),
                                      jnp.asarray(d), jnp.asarray(anchor),
                                      cfg_j)
    _close(rad, jrad, atol=1e-5)
    np.testing.assert_array_equal(conf.numpy(), np.asarray(jconf))
    assert 0.2 < (conf.numpy() > 0).mean() < 1.0


def _gbuf(rng, h=48, w=64):
    """A wavy height field seen from above: positions, normals, a hole."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    z = np.sin(xs * 0.3) * np.cos(ys * 0.2) * 0.6
    pos = np.stack([(xs - w / 2) * 0.08, z - 2.0, (ys - h / 2) * 0.08], -1)
    pos = pos.astype(np.float32)
    nrm = _unit(rng, h, w) * 0.3 + np.float32([0, 1, 0])
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(
        np.float32)
    valid = np.ones((h, w), bool)
    valid[5:12, 40:60] = False
    depth = rng.uniform(0.1, 0.9, (h, w)).astype(np.float32)
    return pos, nrm, valid, depth


def test_ssao_matches():
    rng = np.random.default_rng(8)
    pos, nrm, _, depth = _gbuf(rng)
    for samples in (8, 5):
        cfg_j = jgi.GIConfig(ao_samples=samples)
        cfg_t = gi.GIConfig(ao_samples=samples)
        got = gi.ssao(_t(depth), _t(pos), _t(nrm), cfg_t)
        ref = jgi.ssao(jnp.asarray(depth), jnp.asarray(pos), jnp.asarray(nrm),
                       cfg_j)
        _close(got, ref, atol=1e-5)
        assert 0.0 < float(got.min()) < float(got.max()) <= 1.0


def test_diffuse_gi_matches():
    rng = np.random.default_rng(9)
    cfg_j = jgi.GIConfig(**CFG, sample_res_div=4)
    cfg_t = gi.GIConfig(**CFG, sample_res_div=4)
    cache = _cache(rng, cfg_j)
    pos, nrm, valid, _ = _gbuf(rng)
    anchor = np.zeros(3, np.float32)
    got = gi.diffuse_gi(_t(cache), G(_t(pos), _t(nrm), _t(valid)),
                        _t(anchor), cfg_t)
    ref = jgi.diffuse_gi(jnp.asarray(cache),
                         G(jnp.asarray(pos), jnp.asarray(nrm),
                           jnp.asarray(valid)), jnp.asarray(anchor), cfg_j)
    _close(got, ref, atol=1e-5)
    np.testing.assert_array_equal(gi._down(_t(pos), 4).numpy(),
                                  np.asarray(jgi._down(jnp.asarray(pos), 4)))


@pytest.mark.parametrize("frame", [None, 0, 5, 13])
def test_update_cache_matches(frame):
    """Inject (jittered subsample, one cascade a frame) + propagation; the
    port takes the device counter for the jitter and its host copy for the
    cascade."""
    rng = np.random.default_rng(10 + (frame or 0))
    cfg_j = jgi.GIConfig(**CFG, inject_stride=4)
    cfg_t = gi.GIConfig(**CFG, inject_stride=4)
    cache = _cache(rng, cfg_j)
    pos, nrm, valid, _ = _gbuf(rng)
    pos = pos + np.float32([0.0, 2.0, 0.0])
    lit = rng.uniform(0, 3, pos.shape).astype(np.float32)
    anchor = np.zeros(3, np.float32)
    ref = jgi.update_cache(
        jnp.asarray(cache), G(jnp.asarray(pos), jnp.asarray(nrm),
                              jnp.asarray(valid)), jnp.asarray(lit),
        jnp.asarray(anchor), cfg_j,
        frame_count=None if frame is None else jnp.int32(frame))
    got = gi.update_cache(
        _t(cache), G(_t(pos), _t(nrm), _t(valid)), _t(lit), _t(anchor),
        cfg_t, frame_count=None if frame is None else
        torch.tensor(frame, dtype=torch.int32), frame_index=frame)
    share, worst = _cells_agree(got, ref)
    assert share == 1.0, (share, worst)
    assert not np.array_equal(got.numpy(), cache)


# --- rtao ---------------------------------------------------------------------

def _jitted_ign(frames):
    """chord_tpu's interleaved gradient noise under jit (XLA fuses a*x+b*y
    into an FMA there: eager and jitted noise differ at ~0.35% of
    pixels), in the port's signature."""
    import jax
    from chord_tpu.ops import bluenoise as jbn

    def noise(h, w, frame=0, device=None):
        f = int(frame) if isinstance(frame, torch.Tensor) else frame
        out = jax.jit(jbn.interleaved_gradient_noise, static_argnums=(0, 1))(
            h, w, np.int32(f))
        frames.append(f)
        return torch.from_numpy(np.array(out)).to(device or "cpu")
    return noise


def _ao_scene(kind):
    """A dense scene for 1-unit AO rays -> (port BVH, surface points
    (32,48,3), unit normals): a triangle soup or a sphere set in
    [-6, 6]^3, the points on its triangles (or spheres), normals facing a
    random side."""
    from rt_cases import port_bvh, spheres, tri_bvh, triangles
    rng = np.random.default_rng(21)
    n_pts = 32 * 48
    if kind == "triangle":
        v0, e1, e2 = (x * np.float32(0.3) for x in triangles(400, 7))
        bvh, _ = tri_bvh(v0, e1, e2)
        k = rng.integers(0, len(v0), n_pts)
        uv = rng.uniform(0.05, 0.45, (n_pts, 2))
        pos = v0[k] + uv[:, :1] * e1[k] + uv[:, 1:] * e2[k]
        nrm = bvh.leaf_normal.numpy()[k] * rng.choice([-1, 1], (n_pts, 1))
    else:
        sph = spheres(300, 7)
        sph[:, :3] *= 0.3
        from chord_tpu_torch.ops import rt
        bvh = port_bvh(rt.build_bvh_numpy(sph), sph)
        k = rng.integers(0, len(sph), n_pts)
        nrm = _unit(rng, n_pts)
        pos = sph[k, :3] + nrm * sph[k, 3:]
    return (bvh, pos.reshape(32, 48, 3).astype(np.float32),
            nrm.reshape(32, 48, 3).astype(np.float32))


@pytest.mark.parametrize("kind", ["triangle", "sphere"])
@pytest.mark.parametrize("frame", [None, 3])
def test_rtao_matches(monkeypatch, kind, frame):
    """RTAO on a triangle BVH and a sphere BVH, without the per-frame
    azimuth turn and with it (chord_tpu's jitted noise fed to the port, as
    in its frame): >= 99% of pixels within 1e-5 and the rest within one
    ray's weight (a ray that grazes an edge or a sphere may hit in one
    framework and miss in the other)."""
    import jax
    bvh, pos, nrm = _ao_scene(kind)
    jbvh = jrt_bvh(bvh)
    cfg_j, cfg_t = jgi.GIConfig(), gi.GIConfig()
    frames = []
    monkeypatch.setattr(gi, "interleaved_gradient_noise", _jitted_ign(frames))
    ref = jax.jit(lambda p, n, f: jgi.rtao(p, n, jbvh, cfg_j, frame_index=f)
                  if frame is not None else jgi.rtao(p, n, jbvh, cfg_j))(
        jnp.asarray(pos), jnp.asarray(nrm), jnp.int32(frame or 0))
    got = gi.rtao(_t(pos), _t(nrm), bvh, cfg_t, frame_index=None
                  if frame is None else torch.tensor(frame,
                                                     dtype=torch.int32))
    assert frames == ([] if frame is None else [frame])
    d = np.abs(got.numpy() - np.asarray(ref))
    assert (d <= 1e-5).mean() >= 0.99, (d > 1e-5).mean()
    assert d.max() <= 1.0 / cfg_t.rtao_rays + 1e-5
    assert float(got.min()) < 0.9 and float(got.max()) == 1.0


def jrt_bvh(bvh):
    from chord_tpu.ops import rt as jrt
    return jrt.SceneBVH(**{f: None if v is None else jnp.asarray(v.numpy())
                           for f, v in bvh._asdict().items()})
