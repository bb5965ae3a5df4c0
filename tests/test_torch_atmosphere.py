"""The port's atmosphere (ops/atmosphere.py) and bilinear upsample
(ops/post.py upsample_linear) against chord_tpu's, on the same inputs.

The LUT builders march in f32 on both sides; XLA contracts a*b+c into FMAs
and evaluates exp/pow/sin its own way, so values agree to a few ulps per
step, accumulated over the march. The relative error of a transmittance
exp(-od) is the absolute error of the optical depth od, which reaches ~30
along grazing rays and carries ~1e-4 of rounding after 40 steps; the
multiscatter and sky-view LUTs inherit it: 3e-4 relative on the LUTs (the
mean error is ~4e-7). The samplers are bilinear
taps of a LUT both packages get identically: 1e-5 relative. The aerial
perspective is closed form: 1e-5 relative. upsample_linear is fixed-weight
lerps: 1e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chord_tpu.ops.atmosphere as jatm
from chord_tpu.ops.post import upsample_linear as jax_upsample_linear

from chord_tpu_torch.ops import atmosphere as atm
from chord_tpu_torch.ops.post import upsample_linear

P, JP = atm.AtmosphereParams(), jatm.AtmosphereParams()
SUN = np.asarray([0.3, 0.8, 0.5], np.float32) / np.float32(
    np.linalg.norm([0.3, 0.8, 0.5]))


def _close(got, ref, rtol=1e-5, atol=1e-7):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def luts():
    jt = jatm.build_transmittance_lut(JP, 40)
    jms = jatm.build_multiscatter_lut(JP, jt, dir_samples=16, steps=12)
    jsky = jatm.build_sky_view_lut(JP, jt, jms, jnp.asarray(SUN))
    t = atm.build_transmittance_lut(P, 40, device="cpu")
    ms = atm.build_multiscatter_lut(P, t, dir_samples=16, steps=12)
    sky = atm.build_sky_view_lut(P, t, ms, torch.from_numpy(SUN))
    return dict(t=(t, jt), ms=(ms, jms), sky=(sky, jsky))


@pytest.mark.parametrize("name, shape", [("t", (64, 256, 3)),
                                         ("ms", (32, 32, 3)),
                                         ("sky", (104, 200, 3))])
def test_luts_match(luts, name, shape):
    got, ref = luts[name]
    assert tuple(got.shape) == shape
    assert float(got.min()) >= 0.0 and float(got.max()) > 0.0
    _close(got, ref, rtol=3e-4)


def _dirs(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:8] = SUN                        # some rays into the sun disk
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_sample_sky_and_sun_disk_match(luts):
    """sample_sky, sun_disk_radiance, sky_ambient_irradiance and
    sample_transmittance on one set of LUTs (chord_tpu's, fed to both)."""
    jt, jsky = luts["t"][1], luts["sky"][1]
    t, sky = (torch.from_numpy(np.array(x)) for x in (jt, jsky))
    d = _dirs(4096, 1)
    _close(atm.sample_sky(sky, torch.from_numpy(d)),
           jatm.sample_sky(jsky, jnp.asarray(d)))
    disk = atm.sun_disk_radiance(P, t, torch.from_numpy(d),
                                 torch.from_numpy(SUN))
    _close(disk, jatm.sun_disk_radiance(JP, jt, jnp.asarray(d),
                                        jnp.asarray(SUN)))
    assert float(disk[:8].min()) > 0.0 and float(disk[8:].max()) == 0.0
    _close(atm.sky_ambient_irradiance(sky),
           jatm.sky_ambient_irradiance(jsky))
    r = np.linspace(6359.0, 6470.0, 64, dtype=np.float32)
    mu = np.linspace(-1.2, 1.2, 64, dtype=np.float32)
    _close(atm.sample_transmittance(t, P, torch.from_numpy(r),
                                    torch.from_numpy(mu)),
           jatm.sample_transmittance(jt, JP, jnp.asarray(r), jnp.asarray(mu)))


@pytest.mark.parametrize("alt_km", [0.2, 3.5])
def test_aerial_perspective_matches(alt_km):
    rng = np.random.default_rng(2)
    dist = rng.uniform(0.0, 4000.0, (32, 64)).astype(np.float32)
    dy = rng.uniform(-1.0, 1.0, (32, 64)).astype(np.float32)
    dy[0, :8] = (0.0, 1e-4, -5e-4, 2e-3, -1.0, 1.0, 0.5, -0.5)
    sky = rng.uniform(0.0, 2.0, (32, 64, 3)).astype(np.float32)
    for view_y in (None, dy):
        got = atm.aerial_perspective(
            P, torch.from_numpy(dist), torch.from_numpy(sky),
            cam_alt_km=torch.tensor(alt_km),
            view_dir_y=None if view_y is None else torch.from_numpy(view_y))
        ref = jatm.aerial_perspective(
            JP, jnp.asarray(dist), jnp.asarray(sky),
            cam_alt_km=jnp.float32(alt_km),
            view_dir_y=None if view_y is None else jnp.asarray(view_y))
        for g, r in zip(got, ref):
            _close(g, r)


@pytest.mark.parametrize("shape, k, out", [((16, 32, 3), 4, (64, 128)),
                                           ((9, 7), 2, (17, 13)),
                                           ((180, 320, 3), 4, (720, 1280))])
def test_upsample_linear_matches(shape, k, out):
    x = np.random.default_rng(3).uniform(0, 4, shape).astype(np.float32)
    got = upsample_linear(torch.from_numpy(x), k, *out)
    assert tuple(got.shape[:2]) == out
    _close(got, jax_upsample_linear(jnp.asarray(x), k, *out), rtol=1e-6,
           atol=1e-6)
