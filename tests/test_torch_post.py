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


def test_tile_reproject_clamps_like_chord_tpu():
    """A history whose size is no multiple of the 32x128 tile, under
    motion of up to ~520 px: sample starts clamp at -MARGIN in both axes
    and at the far edge, where the wrapper's table and the edge rule (the
    kernel's clamped coordinates, the plain version's padded planes) meet
    chord_tpu's padding. History within 1e-5 as above; the residual within
    1e-5 x (1 + max |motion|): the 4096-term tile mean of motion this
    large rounds differently in XLA's and torch's summation orders
    (measured 2.0e-3 at 521 px)."""
    h, w, c, scale = 90, 330, 3, 400.0
    rng = np.random.default_rng(h * w)
    img = rng.uniform(0, 2, (h, w, c)).astype(np.float32)
    mot = _field(rng, h, w, scale)
    m = tile_reproject.MARGIN
    hp, wp = tile_reproject._tiles(h, w)
    tab = tile_reproject._tile_table(_t(mot), hp, wp)[1]
    assert bool((tab[:, 0] == 0).any() and (tab[:, 1] == 0).any())
    assert bool((tab[:, 0] == m + hp - 1).any())
    ref_h, ref_r = jtr.tile_reproject(jnp.asarray(img), jnp.asarray(mot),
                                      interpret=True)
    got_h, got_r = tile_reproject.tile_reproject(_t(img), _t(mot))
    assert got_h.shape == (h, w, c)
    _close(got_h.numpy(), ref_h, 1e-5)
    # the CUDA kernel's index rule (history rows and columns clamped, no
    # padded copy), in numpy, equals the plain version bit for bit
    tb = tab.numpy()
    fy = tb[:, 2].astype(np.float32) * np.float32(1.0 / 1024)
    fx = tb[:, 3].astype(np.float32) * np.float32(1.0 / 1024)
    wt = wp // 128
    want = np.zeros((hp, wp, c), np.float32)
    for t in range(len(tb)):
        ys = np.clip(tb[t, 0] - m + np.arange(33), 0, h - 1)
        xs = np.clip(tb[t, 1] - m + np.arange(129), 0, w - 1)
        win = img[ys][:, xs]                            # (33, 129, c)
        gy, gx = np.float32(1.0) - fy[t], np.float32(1.0) - fx[t]
        top = gy * win[:-1, :-1] + fy[t] * win[1:, :-1]
        bot = gy * win[:-1, 1:] + fy[t] * win[1:, 1:]
        ty, tx = divmod(t, wt)
        want[ty * 32:ty * 32 + 32, tx * 128:tx * 128 + 128] = (
            gx * top + fx[t] * bot)
    np.testing.assert_array_equal(
        tile_reproject.reproject_tiles_plain(_t(img), tab).numpy(),
        want[:h, :w])
    d = np.abs(got_r.numpy() - np.asarray(ref_r))
    assert d.max() <= 1e-5 * (1.0 + np.abs(mot).max()), d.max()

@pytest.mark.parametrize("h,w,c,scale", [(70, 200, 3, 3.0),
                                         (90, 330, 3, 400.0)])
def test_tile_reproject_library_yardstick(h, w, c, scale):
    """chip_smoke's library yardstick for K4 (a border-clamped bilinear
    grid_sample on a grid built from the tile table) computes K4's
    function: the plain version within 1e-6 x max(h, w), the rounding of
    the grid's normalised coordinates (~2^-23 of the extent, a few times)
    times the history's slope (values in [0, 2])."""
    import chip_smoke

    rng = np.random.default_rng(h * w)
    img = _t(rng.uniform(0, 2, (h, w, c)).astype(np.float32))
    mot = _t(_field(rng, h, w, scale))
    hp, wp = tile_reproject._tiles(h, w)
    tab = tile_reproject._tile_table(mot, hp, wp)[1]
    got = chip_smoke.library_call("tile_reproject", (img, tab))()
    assert got.shape == (1, c, h, w)
    ref = tile_reproject.reproject_tiles_plain(img, tab)
    d = (got[0].permute(1, 2, 0) - ref).abs().max().item()
    assert d <= 1e-6 * max(h, w), d


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


@pytest.mark.parametrize("bilinear", [True, False])
def test_temporal_resolve_gather_matches(bilinear):
    """Gather-mode TSR at render size (the flat frame's): history fetched
    from its bf16 copy at each pixel's previous position (off screen
    included), clamped, blended, sharpened; with a disocclusion mask and
    with invalid history. Tolerance 1e-4 relative to max(|ref|, 1): the
    bilinear weights and the blend in another rounding (bf16 texels
    convert exactly); a fetch whose coordinate sits on a texel boundary
    may take the neighbour texel in nearest mode, so >= 99.9% of values."""
    rng = np.random.default_rng(9)
    h, w = 48, 96
    color = rng.uniform(0, 4, (h, w, 3)).astype(np.float32)
    hist = rng.uniform(0, 4, (h, w, 3)).astype(np.float32)
    mot = (_field(rng, h, w, 4.0) / np.array([w * 0.5, -h * 0.5],
                                              np.float32)).astype(np.float32)
    dis = (rng.uniform(size=(h, w)) < 0.1).astype(np.float32)
    for valid, d in ((1.0, None), (1.0, dis), (0.0, None)):
        cfg = dict(mode="gather", bilinear_history=bilinear)
        args = (color, mot, hist, np.float32(valid))
        ref = np.asarray(jpost.temporal_resolve(
            *map(jnp.asarray, args), jpost.TSRConfig(**cfg),
            disocclusion=None if d is None else jnp.asarray(d)))
        got = post.temporal_resolve(
            *map(_t, args), post.TSRConfig(**cfg),
            disocclusion=None if d is None else _t(d)).numpy()
        bad = np.abs(got - ref) > 1e-4 * np.maximum(np.abs(ref), 1.0)
        assert bad.mean() <= 1e-3, (valid, np.abs(got - ref).max())
    assert post.TSRConfig().mode == jpost.TSRConfig().mode == "gather"



@pytest.mark.parametrize("mode", ["global", "tile"])
def test_temporal_resolve_reprojecting_modes_match(mode):
    """TSR at render size in the two reprojecting modes (global: the
    history shifted by the mean motion, rolled by device-side indices;
    tile: K4), with a disocclusion mask and with invalid history.
    Tolerance 1e-4 relative to max(|ref|, 1), as the tile upscale: the
    mean motion is an 8192-term f32 sum in another order, which moves the
    bilinear fraction by ulps. The motion's mean (about 2.60 px right and
    0.18 px up) lies far from a whole pixel, so those ulps cannot move its
    floor, which would shift the whole history by a pixel."""
    rng = np.random.default_rng(17)
    h, w = 64, 128
    color = rng.uniform(0, 3, (h, w, 3)).astype(np.float32)
    hist = rng.uniform(0, 3, (h, w, 3)).astype(np.float32)
    mot = (_field(rng, h, w, 3.0) / np.array([w * 0.5, -h * 0.5],
                                              np.float32)).astype(np.float32)
    dis = (rng.uniform(size=(h, w)) < 0.15).astype(np.float32)
    for valid, d in ((1.0, None), (1.0, dis), (0.0, dis)):
        args = (color, mot, hist, np.float32(valid))
        ref = jpost.temporal_resolve(
            *map(jnp.asarray, args), jpost.TSRConfig(mode=mode),
            disocclusion=None if d is None else jnp.asarray(d))
        got = post.temporal_resolve(
            *map(_t, args), post.TSRConfig(mode=mode),
            disocclusion=None if d is None else _t(d))
        _close(got.numpy(), ref, 1e-4)


@pytest.mark.parametrize("mode", ["gather", "global"])
def test_temporal_upscale_gather_and_global_match(mode):
    """The render->post TSR in gather mode (colour, motion and the
    disocclusion mask sampled bilinearly at each post pixel's jittered
    render position, the history from its bf16 copy) and global mode (the
    linear resample, the global resolve at post res, the nearest-upsampled
    restart of disoccluded pixels), with valid and invalid history.
    Tolerance 1e-4 relative to max(|ref|, 1): resample contractions and
    the blend in another rounding (bf16 texels convert exactly)."""
    rng = np.random.default_rng(19)
    h, w, ph, pw = 64, 128, 96, 192
    color = rng.uniform(0, 3, (h, w, 3)).astype(np.float32)
    mot = (rng.normal(0.01, 0.01, (h, w, 2))).astype(np.float32)
    hist = rng.uniform(0, 3, (ph, pw, 3)).astype(np.float32)
    dis = (rng.uniform(0, 1, (h, w)) > 0.8).astype(np.float32)
    jitter = np.array([0.25, -0.375], np.float32)
    for valid in (0.0, 1.0):
        ref = jpost.temporal_upscale(
            jnp.asarray(color), jnp.asarray(mot), jnp.asarray(hist),
            jnp.float32(valid), jnp.asarray(jitter),
            jpost.TSRConfig(mode=mode), ph, pw,
            disocclusion=jnp.asarray(dis))
        got = post.temporal_upscale(
            _t(color), _t(mot), _t(hist), torch.tensor(valid), _t(jitter),
            post.TSRConfig(mode=mode), ph, pw, disocclusion=_t(dis))
        _close(got.numpy(), ref, 1e-4)


def test_hdr10_output_and_transfer_functions_match():
    """tonemap_display's HDR10 branch (the film curve, AP1 -> Rec.2020,
    the PQ encode of a 1000-nit peak), pq_oetf over 0..12000 nits (past
    the 10000-nit clamp) and srgb_eotf: pow in another rounding, within
    2e-5 absolute on [0, 1] signals; the u8 HDR10 image within 1 level.
    An unknown output raises ValueError, as in chord_tpu."""
    rng = np.random.default_rng(23)
    x = rng.uniform(0, 5, (37, 53, 3)).astype(np.float32)
    ref = jcs.tonemap_display(jnp.asarray(x), jnp.float32(0.6), "hdr10")
    got = colorspace.tonemap_display(_t(x), torch.tensor(0.6), "hdr10")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)
    d = np.abs(colorspace.to_u8(got).numpy().astype(int) -
               np.asarray(jcs.to_u8(ref)).astype(int))
    assert d.max() <= 1
    nits = rng.uniform(0, 12000, 4096).astype(np.float32)
    np.testing.assert_allclose(colorspace.pq_oetf(_t(nits)).numpy(),
                               np.asarray(jcs.pq_oetf(jnp.asarray(nits))),
                               atol=2e-5)
    enc = rng.uniform(0, 1, 4096).astype(np.float32)
    np.testing.assert_allclose(colorspace.srgb_eotf(_t(enc)).numpy(),
                               np.asarray(jcs.srgb_eotf(jnp.asarray(enc))),
                               atol=2e-5)
    np.testing.assert_array_equal(colorspace.AP1_TO_REC2020,
                                  jcs.AP1_TO_REC2020)
    with pytest.raises(ValueError):
        colorspace.tonemap_display(_t(x), torch.tensor(0.6), "srgb16")
