"""The ported DDGI probe volumes (chord_tpu_torch/ops/ddgi.py) against
chord_tpu/ops/ddgi.py, on seeded numpy inputs, on the CPU.

Inputs: a small DDGIConfig(cascades=2, probe_dim=(4, 4, 4), rays=16,
update_phases=2) over a triangle soup in [-6, 6]^3 (tests/rt_cases.py;
the rays take the dense triangle route on both sides), frames 0..5, so
every (cascade, phase) slice is updated and the first two again through
the hysteresis; a seeded random state for the samplers.

Tolerances. Direction tables, grid positions, texel indices and the
update's slice: exact. The rotated ray table: 1e-6 (cos / sin of f32
angles, f64 libm rounded against XLA's). The convolution and SH projection: 1e-5 relative +
1e-6 absolute (einsum reduction order). The state after each update:
irradiance, distance moments and SH within 1e-4 relative + 1e-5
absolute on >= 99.9% of values, offsets within 1e-5, weights exact (a
ray that grazes a triangle edge may hit in one framework only, and moves
its probe's texels; none does at this seed). The samplers: 1e-4
relative + 1e-5 absolute (8 probes' products of f32 weights; pow and
sqrt through libm), the confidence exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chord_tpu.ops import ddgi as jddgi
from chord_tpu.ops import rt as jrt
from chord_tpu.rhi.framebuffer import FrameHistory as JHistory

from chord_tpu_torch import interop
from chord_tpu_torch.ops import ddgi
from chord_tpu_torch.rhi.framebuffer import FrameHistory
from rt_cases import tri_bvh, triangles

SMALL = dict(cascades=2, probe_dim=(4, 4, 4), rays=16, update_phases=2)


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def _close(got, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _unit(rng, n):
    d = rng.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def test_direction_tables_and_grid_match():
    for n in (16, 32, 7):
        np.testing.assert_array_equal(ddgi.spherical_fibonacci(n),
                                      jddgi.spherical_fibonacci(n))
    for side in (2, 6, 8):
        np.testing.assert_array_equal(ddgi.octahedral_texel_dirs(side),
                                      jddgi.octahedral_texel_dirs(side))
    for cfg in (SMALL, {}):
        np.testing.assert_array_equal(
            ddgi.probe_grid_positions(ddgi.DDGIConfig(**cfg)),
            jddgi.probe_grid_positions(jddgi.DDGIConfig(**cfg)))
        assert ddgi.probe_count(ddgi.DDGIConfig(**cfg)) == \
            jddgi.probe_count(jddgi.DDGIConfig(**cfg))
    for f in (0, 5, 41):
        # the port's frame ray table: the Fibonacci set times the jitter
        # rotation, built on the host
        want = jddgi.spherical_fibonacci(16) @ np.asarray(
            jddgi._jitter_rotation(jnp.int32(f))).T
        _close(torch.from_numpy(ddgi.ray_table(f, 16)), want, atol=1e-6)


def test_octahedral_texel_index_matches():
    """Unit directions, the axes and both octahedron halves."""
    rng = np.random.default_rng(1)
    d = np.concatenate([_unit(rng, 4000), np.eye(3, dtype=np.float32),
                        -np.eye(3, dtype=np.float32)])
    for side in (2, 6, 8):
        np.testing.assert_array_equal(
            ddgi.octahedral_texel_index(_t(d), side).numpy(),
            np.asarray(jddgi.octahedral_texel_index(jnp.asarray(d), side)))


def test_convolve_and_project_sh_match():
    rng = np.random.default_rng(2)
    cfg_t, cfg_j = ddgi.DDGIConfig(**SMALL), jddgi.DDGIConfig(**SMALL)
    rad = rng.uniform(0, 3, (32, 16, 3)).astype(np.float32)
    dist = rng.uniform(0.1, 4, (32, 16)).astype(np.float32)
    dirs = _unit(rng, 16)
    for dd in (dirs, np.broadcast_to(dirs, (32, 16, 3)).copy()):
        got = ddgi._convolve(_t(rad), _t(dist), _t(dd), cfg_t)
        ref = jddgi._convolve(jnp.asarray(rad), jnp.asarray(dist),
                              jnp.asarray(dd), cfg_j)
        for g, r in zip(got, ref):
            _close(g, r)
    oracle = ddgi.convolve_numpy(rad, dist, dirs, cfg_t)
    for g, r, o in zip(got, oracle, jddgi.convolve_numpy(rad, dist, dirs,
                                                         cfg_j)):
        np.testing.assert_array_equal(r, o)
        _close(g, r, rtol=1e-4, atol=1e-5)
    _close(ddgi._project_sh(got[0], cfg_t),
           jddgi._project_sh(jnp.asarray(got[0].numpy()), cfg_j))


def test_empty_state_and_history_interop():
    """DDGIState.empty: chord_tpu's shapes with and without a config; a
    history with DDGI carries its state through interop, and a history
    without carries the placeholder."""
    for cfg in (None, SMALL, {}):
        got = ddgi.DDGIState.empty(cfg and ddgi.DDGIConfig(**cfg),
                                   device="cpu")
        ref = jddgi.DDGIState.empty(cfg and jddgi.DDGIConfig(**cfg))
        for f in ddgi.DDGIState._fields:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(ref, f)), f)
    jh = JHistory.empty(16, 32, ddgi_cfg=jddgi.DDGIConfig(**SMALL))
    rng = np.random.default_rng(3)
    jh = jh.replace(ddgi=jddgi.DDGIState(*(
        jnp.asarray(rng.normal(size=np.shape(x)).astype(np.float32))
        for x in jh.ddgi)))
    got = FrameHistory.empty(16, 32, ddgi_cfg=ddgi.DDGIConfig(**SMALL),
                             device="cpu")
    arrays = {k: (v if k == "ddgi" else np.asarray(v))
              for k, v in vars(jh).items()}
    for carried in (interop.history_from_numpy(arrays, device="cpu"),
                    interop.history_from_numpy(
                        dict(arrays, ddgi=jh.ddgi._asdict()), device="cpu")):
        for f in ddgi.DDGIState._fields:
            assert getattr(got.ddgi, f).shape == getattr(carried.ddgi,
                                                         f).shape
            np.testing.assert_array_equal(getattr(carried.ddgi, f).numpy(),
                                          np.asarray(getattr(jh.ddgi, f)))
    off = interop.history_from_numpy(
        {k: v for k, v in arrays.items() if k != "ddgi"}, device="cpu")
    assert off.ddgi.irr.shape == (1, 8, 4, 3)


@pytest.fixture(scope="module")
def updates():
    """Frames 0..5 of ddgi_update in both packages from an empty state."""
    v0, e1, e2 = (x * np.float32(0.3) for x in triangles(400, 7))
    bvh, _ = tri_bvh(v0, e1, e2)
    jbvh = jrt.SceneBVH(**{f: None if v is None else jnp.asarray(v.numpy())
                           for f, v in bvh._asdict().items()})
    cfg_t, cfg_j = ddgi.DDGIConfig(**SMALL), jddgi.DDGIConfig(**SMALL)
    sun = np.float32([0.3, 0.8, 0.5]) / np.float32(np.linalg.norm(
        [0.3, 0.8, 0.5]))
    sun_rad = np.float32([8.0, 7.6, 7.0])
    sky = np.float32([0.3, 0.4, 0.6])
    st = ddgi.DDGIState.empty(cfg_t, device="cpu")
    jst = jddgi.DDGIState.empty(cfg_j)
    out = []
    for f in range(6):
        st = ddgi.ddgi_update(st, bvh, _t(sun), _t(sun_rad), _t(sky),
                              torch.tensor(f, dtype=torch.int32), cfg_t,
                              frame_index=f)
        jst = jddgi.ddgi_update(jst, jbvh, jnp.asarray(sun),
                                jnp.asarray(sun_rad), jnp.asarray(sky),
                                jnp.int32(f), cfg_j)
        out.append((st, jst))
    return out


@pytest.mark.parametrize("frame", range(6))
def test_ddgi_update_matches(updates, frame):
    got, ref = updates[frame]
    cfg = ddgi.DDGIConfig(**SMALL)
    c, start, pp = ddgi.update_slice(cfg, frame)
    assert (c, start, pp) == (frame % 2, (frame // 2) % 2 * 32, 32)
    for f in ("irr", "dist", "sh"):
        g, r = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        ok = np.abs(g - r) <= 1e-4 * np.abs(r) + 1e-5
        assert ok.mean() >= 0.999, (f, ok.mean(), np.abs(g - r).max())
    _close(got.offset, ref.offset, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.weight.numpy(), np.asarray(ref.weight))
    w = got.weight.numpy()
    assert w[c, start:start + pp].min() >= 1.0
    if frame == 3:   # every slice traced once
        assert (w > 0).all()
    if frame == 5:   # the first two slices twice, through the hysteresis
        assert w.max() == 2.0
    assert float(got.offset.abs().max()) > 0.0 or frame < 1


def test_ddgi_update_needs_frame_index(updates):
    st, _ = updates[0]
    with pytest.raises(ValueError):
        ddgi.ddgi_update(st, None, None, None, None, torch.tensor(0),
                         ddgi.DDGIConfig(**SMALL))


def _state(rng, cfg):
    c, p = cfg.cascades, ddgi.probe_count(cfg)
    mean = rng.uniform(0.2, 3.0, (c, p, cfg.dist_side ** 2)).astype(
        np.float32)
    return dict(
        irr=rng.uniform(0, 2, (c, p, cfg.irr_side ** 2, 3)).astype(
            np.float32),
        dist=np.stack([mean, mean * mean + rng.uniform(0, 0.5, mean.shape)
                       .astype(np.float32)], -1),
        sh=rng.normal(0.5, 0.3, (c, p, 12)).astype(np.float32),
        offset=rng.uniform(-0.2, 0.2, (c, p, 3)).astype(np.float32),
        weight=rng.choice([0.0, 1.0, 5.0], (c, p)).astype(np.float32))


@pytest.mark.parametrize("mode", ["sh", "oct"])
def test_sample_ddgi_matches(mode):
    """Points in every cascade's reach and beyond, normals in every
    direction, a state with untraced probes."""
    rng = np.random.default_rng(4)
    cfg_t, cfg_j = ddgi.DDGIConfig(**SMALL), jddgi.DDGIConfig(**SMALL)
    arrays = _state(rng, cfg_t)
    st = ddgi.DDGIState(**{k: _t(v) for k, v in arrays.items()})
    jst = jddgi.DDGIState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    pos = rng.uniform(-5, 5, (40, 50, 3)).astype(np.float32)
    nrm = _unit(rng, 2000).reshape(40, 50, 3)
    np.testing.assert_array_equal(
        ddgi._pick_cascade(_t(pos), cfg_t).numpy(),
        np.asarray(jddgi._pick_cascade(jnp.asarray(pos), cfg_j)))
    got = ddgi.sample_ddgi(st, _t(pos), _t(nrm), cfg_t, mode=mode)
    ref = jddgi.sample_ddgi(jst, jnp.asarray(pos), jnp.asarray(nrm), cfg_j,
                            mode=mode)
    assert got[0].shape == (40, 50, 3)
    _close(got[0], ref[0], rtol=1e-4, atol=1e-5)
    _close(got[1], ref[1], rtol=0, atol=0)
    assert 0.0 < float((got[1] > 0).float().mean()) < 1.0


def test_diffuse_ddgi_matches():
    class GB:
        def __init__(self, pos, nrm, valid):
            self.position_tw, self.normal, self.valid = pos, nrm, valid

    rng = np.random.default_rng(5)
    cfg_t = ddgi.DDGIConfig(**SMALL, sample_div=2)
    cfg_j = jddgi.DDGIConfig(**SMALL, sample_div=2)
    arrays = _state(rng, cfg_t)
    pos = rng.uniform(-3, 3, (24, 40, 3)).astype(np.float32)
    nrm = _unit(rng, 960).reshape(24, 40, 3)
    valid = rng.uniform(size=(24, 40)) > 0.2
    got = ddgi.diffuse_ddgi(
        ddgi.DDGIState(**{k: _t(v) for k, v in arrays.items()}),
        GB(_t(pos), _t(nrm), _t(valid)), cfg_t)
    ref = jddgi.diffuse_ddgi(
        jddgi.DDGIState(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        GB(jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(valid)), cfg_j)
    _close(got, ref, rtol=1e-4, atol=1e-5)
