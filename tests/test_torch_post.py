"""Post chain against chord_tpu on seeded numpy inputs: tile reprojection
(K4's plain version vs the Pallas kernel in interpret mode), the tile-mode
TSR upscale, bloom, the exposure histogram + adaptation, the TSR motion
dilation, the disocclusion mask and the tonemap.

Tolerances (f32). Rearrangements (rolls, slices, dilation, histogram
bins, masks) are exact. Sums taken in another order (XLA's reductions and
its fused multiply-adds vs PyTorch's separately rounded ops) allow:
- tile_reproject: 1e-5 absolute on values of O(1) — each output is two
  lerps of inputs in [0, 2]; the tile mean motion (a 4096-term mean) may
  differ in the last bit, which moves a quantised 1/1024 fraction only if
  it sits on a rounding boundary. Its residual to 1e-6 x (1 + max|motion|).
- temporal upscale / bloom: 1e-4 relative to max(|ref|, 1) — chains of
  resample contractions and blur passes over O(1) HDR values.
- exposure: 1e-5 relative.
- tonemap to u8: within 1 level.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chord_tpu.ops import colorspace as jcs
from chord_tpu.ops import post as jpost
from chord_tpu.ops import tile_reproject as jtr

from chord_tpu_torch.ops import colorspace, post, tile_reproject


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    bad = np.abs(got - ref) > rel * np.maximum(np.abs(ref), 1.0)
    assert not bad.any(), (np.abs(got - ref).max(), bad.sum())


def _t(a):
    return torch.from_numpy(np.array(a))


def _field(rng, h, w, scale):
    """Smooth motion field (pixels) with per-pixel noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([np.sin(xx / 37.0) * scale + 0.3 * scale,
                     np.cos(yy / 23.0) * scale - 0.2 * scale], -1)
    return (base + rng.normal(0, 0.3, (h, w, 2))).astype(np.float32)


@pytest.mark.parametrize("h,w,c,scale", [(70, 200, 3, 3.0),
                                         (64, 256, 1, 150.0)])
def test_tile_reproject_matches(h, w, c, scale):
    rng = np.random.default_rng(h * w)
    img = rng.uniform(0, 2, (h, w, c)).astype(np.float32)
    mot = _field(rng, h, w, scale)
    if c == 1:
        img = img[..., 0]
    ref_h, ref_r = jtr.tile_reproject(jnp.asarray(img), jnp.asarray(mot),
                                      interpret=True)
    got_h, got_r = tile_reproject.tile_reproject(_t(img), _t(mot))
    _close(got_h.numpy(), ref_h, 1e-5)
    # the residual is |motion - tile mean|: bounded by the rounding of the
    # 4096-term mean at the motion's magnitude, not the residual's
    d = np.abs(got_r.numpy() - np.asarray(ref_r))
    assert d.max() <= 1e-6 * (1.0 + np.abs(mot).max()), d.max()


def test_temporal_upscale_tile_matches():
    rng = np.random.default_rng(7)
    h, w, ph, pw = 64, 128, 96, 192
    color = rng.uniform(0, 3, (h, w, 3)).astype(np.float32)
    mot = (rng.normal(0, 0.01, (h, w, 2))).astype(np.float32)
    hist = rng.uniform(0, 3, (ph, pw, 3)).astype(np.float32)
    dis = (rng.uniform(0, 1, (h, w)) > 0.8).astype(np.float32)
    jitter = np.array([0.25, -0.375], np.float32)
    for valid in (0.0, 1.0):
        ref = jpost.temporal_upscale(
            jnp.asarray(color), jnp.asarray(mot), jnp.asarray(hist),
            jnp.float32(valid), jnp.asarray(jitter),
            jpost.TSRConfig(mode="tile"), ph, pw,
            disocclusion=jnp.asarray(dis))
        got = post.temporal_upscale(
            _t(color), _t(mot), _t(hist), torch.tensor(valid), _t(jitter),
            post.TSRConfig(mode="tile"), ph, pw, disocclusion=_t(dis))
        _close(got.numpy(), ref, 1e-4)


def test_bloom_matches():
    rng = np.random.default_rng(3)
    hdr = (rng.uniform(0, 1, (90, 170, 3)) ** 4 * 6).astype(np.float32)
    ref = jpost.compute_bloom(jnp.asarray(hdr), jpost.BloomConfig())
    got = post.compute_bloom(_t(hdr), post.BloomConfig())
    _close(got.numpy(), ref, 1e-4)


@pytest.mark.parametrize("fix", [-1.0, 0.7])
def test_exposure_matches(fix):
    rng = np.random.default_rng(5)
    hdr = (rng.uniform(0, 1, (64, 128, 3)) ** 3 * 4).astype(np.float32)
    hdr[:8] = 0.0                          # a black band: bin 0
    cfg = jpost.ExposureConfig(fix_exposure=fix)
    tcfg = post.ExposureConfig(fix_exposure=fix)
    jh = jpost.luminance_histogram(jnp.asarray(hdr), cfg)
    th = post.luminance_histogram(_t(hdr), tcfg)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    for prev in (0.5, 3.0):
        ref = jpost.adapt_exposure(jh, jnp.float32(prev), 1.0 / 60.0, cfg)
        got = post.adapt_exposure(th, torch.tensor(prev), 1.0 / 60.0, tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


def test_tsr_prepare_and_disocclusion_match():
    rng = np.random.default_rng(11)
    h, w = 40, 72
    depth = rng.uniform(0, 1, (h, w)).astype(np.float32)
    depth[rng.uniform(0, 1, (h, w)) < 0.2] = 0.0
    mot = rng.normal(0, 0.02, (h, w, 2)).astype(np.float32)
    ref = jpost.tsr_prepare(jnp.asarray(mot), jnp.asarray(depth))
    np.testing.assert_array_equal(
        post.tsr_prepare(_t(mot), _t(depth)).numpy(), np.asarray(ref))

    pos = np.stack([rng.uniform(-5, 5, (h, w)), rng.uniform(-2, 3, (h, w)),
                    rng.uniform(-20, -2, (h, w))], -1).astype(np.float32)
    f, n = 1.0 / np.tan(0.5), 0.001
    m = np.zeros((4, 4), np.float32)
    m[0, 0], m[1, 1], m[2, 3], m[3, 2] = f * h / w, f, -1.0, n
    # previous depth = the expected reprojected depth, with a hole
    c = pos @ m[:3] + m[3]
    prev = np.zeros((h, w), np.float32)
    xi = np.clip(((c[..., 0] / c[..., 3] * 0.5 + 0.5) * w).astype(int), 0,
                 w - 1)
    yi = np.clip(((0.5 - c[..., 1] / c[..., 3] * 0.5) * h).astype(int), 0,
                 h - 1)
    prev[yi, xi] = c[..., 2] / c[..., 3]
    prev[:, :10] = 0.7
    valid = rng.uniform(0, 1, (h, w)) > 0.1
    for hv in (0.0, 1.0):
        ref = jpost.disocclusion_mask(jnp.asarray(pos), jnp.asarray(valid),
                                      jnp.asarray(prev), jnp.asarray(m),
                                      jnp.float32(hv))
        got = post.disocclusion_mask(_t(pos), _t(valid), _t(prev), _t(m),
                                     torch.tensor(hv))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0.0 < float(got.mean()) < 1.0


def test_resample_helpers_and_tonemap_match():
    rng = np.random.default_rng(13)
    x = rng.uniform(0, 5, (37, 53, 3)).astype(np.float32)
    for k in (2, 4, (3, 2)):
        np.testing.assert_array_equal(post.decimate(_t(x), k).numpy(),
                                      np.asarray(jpost.decimate(
                                          jnp.asarray(x), k)))
        np.testing.assert_array_equal(
            post.upsample_nearest(_t(x), k, 80, 101).numpy(),
            np.asarray(jpost.upsample_nearest(jnp.asarray(x), k, 80, 101)))
    ref = jcs.to_u8(jcs.tonemap_display(jnp.asarray(x), jnp.float32(0.6)))
    got = colorspace.to_u8(colorspace.tonemap_display(_t(x), torch.tensor(0.6)))
    assert got.dtype == torch.uint8
    d = np.abs(got.numpy().astype(int) - np.asarray(ref).astype(int))
    assert d.max() <= 1
