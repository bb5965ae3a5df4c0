"""K5's plain version (the port's paged texture sampler on the CPU) against
chord_tpu's Pallas `paged_sample` in interpret mode, with its palette
coverage output.

The inputs cover raw and block-compressed pools, bilinear and nearest
taps, every mip of the 256² bench pool down to the 1x1 tail (and mips out
of range, which clamp), untextured channels (layer -1), u and v that wrap
and go negative, and a wrap seam inside one block; and bilinear
footprints that read one, two and four 4x4 blocks of a compressed page,
across the 31-texel tile seam (test_torch_paged_footprint). uv is
coherent within each 8x128 block, so chord_tpu's K-page palette covers
every pixel; the test asserts that before comparing.

Tolerances: nearest returns a stored texel, so it is exact. Bilinear
rounds an f32 filter of four u8 texels to u8: XLA's CPU backend contracts
the filter sum into FMAs, which moves a value that lies on a .5 boundary
by one level, so >= 99.9% must be exact and none may differ by more than
one level.

Where chord_tpu's palette MISSES (incoherent uv at the frame's block_h 16
and its 16 / 10 pages), a texel takes the single-page fallback mip or,
past the block's C+4 fallback pages, the entry's average colour. The
port computes the same function: test_palette_miss_matches_chord_tpu
holds it to chord_tpu bit for bit, coverage included, on inputs where
all three cases occur.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chord_tpu.ops import paged_texture as jpt

from chord_tpu_torch.asset.procedural import bench_texture_pool
from chord_tpu_torch.ops import paged_texture as pt
from paged_palette_cases import MISS_CASES, miss_inputs
from test_torch_paged_footprint import footprint_inputs

BH = 8                 # chord_tpu's palette block height for these inputs


@pytest.fixture(scope="module")
def pool():
    tp = bench_texture_pool()
    return tp, tp.u8()


def _packed(pool_raw, tp, compress):
    pages, meta, n_mips = pt.pack_paged_pool(pool_raw, tp.mip_sizes,
                                             tp.mip_offsets, compress)
    return pages, meta, n_mips


def _coherent_inputs(seed=0):
    """9 blocks of 8 rows; block i samples mip i over <= 2x2 page tiles."""
    rng = np.random.default_rng(seed)
    h, w = 8 * 9, 128
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    blk = (yy // BH).astype(np.int32)
    u0 = (-2.37 + 0.31 * blk).astype(np.float32)
    v0 = (3.71 - 0.53 * blk).astype(np.float32)
    u0[blk == 3] = 0.95            # a wrap seam inside block 3
    uv = np.stack([u0 + xx * (0.1 / w), v0 + (yy % BH) * 0.0013], -1)
    mip = blk.copy()
    mip[0, :5] = -1                # clamps to 0
    mip[-1, :5] = 12               # clamps to the 1x1 tail
    layers = np.stack([(blk * 5 + 1) % 12, (blk * 7 + 4) % 12])
    layers[1][(xx.astype(np.int32) % 7) == 0] = -1
    layers[0][:, :3] = -1
    return (layers.astype(np.int32), uv.astype(np.float32),
            mip.astype(np.int32))


def _matches_chord_tpu(pool, compress, bilinear, inputs):
    tp, raw = pool
    pages, meta, n_mips = _packed(raw, tp, compress)
    layers, uv, mip = inputs
    ref, cov = jpt.paged_sample(
        jnp.asarray(pages), jnp.asarray(meta), n_mips, tp.mip_sizes,
        jnp.asarray(layers), jnp.asarray(uv), jnp.asarray(mip),
        bilinear=bilinear, block_h=BH, k_pages=8, with_coverage=True)
    assert bool(np.asarray(cov).all()), "the reference palette must cover"
    packed = pt.paged_sample(torch.from_numpy(pages), torch.from_numpy(meta),
                             n_mips, tp.mip_sizes, torch.from_numpy(layers),
                             torch.from_numpy(uv), torch.from_numpy(mip),
                             bilinear=bilinear, block_h=BH, k_pages=8)
    assert packed.dtype == torch.int32 and packed.shape == layers.shape
    got = pt.unpack_rgba(packed).numpy()
    ref = np.asarray(ref)
    assert (got[layers < 0] == 1.0).all()
    levels = np.abs(np.rint(got * 255) - np.rint(ref * 255))
    if bilinear:
        assert (levels == 0).mean() >= 0.999 and levels.max() <= 1, \
            ((levels > 0).mean(), levels.max())
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("bilinear", [True, False])
def test_paged_sample_matches_chord_tpu(pool, compress, bilinear):
    _matches_chord_tpu(pool, compress, bilinear, _coherent_inputs())


@pytest.mark.parametrize("compress", [False, True])
def test_footprints_match_chord_tpu(pool, compress):
    """Bilinear footprints straddling a block edge in x, in y and in both,
    and the tile seam of multi-tile mips."""
    _matches_chord_tpu(pool, compress, True, footprint_inputs())


@pytest.mark.parametrize("c,k,compress,bilinear,h,w", MISS_CASES)
def test_palette_miss_matches_chord_tpu(pool, c, k, compress, bilinear, h, w):
    tp, raw = pool
    pages, meta, n_mips = _packed(raw, tp, compress)
    layers, uv, mip = miss_inputs(c, h, w, seed=c * 10 + h)
    ref, cov = jpt.paged_sample(
        jnp.asarray(pages), jnp.asarray(meta), n_mips, tp.mip_sizes,
        jnp.asarray(layers), jnp.asarray(uv), jnp.asarray(mip),
        bilinear=bilinear, block_h=16, k_pages=k, with_coverage=True)
    args = [torch.from_numpy(a) for a in (pages, meta)] + [
        n_mips, tp.mip_sizes] + [torch.from_numpy(a)
                                 for a in (layers, uv, mip)]
    packed, got_cov = pt.paged_sample(*args, bilinear=bilinear, block_h=16,
                                      k_pages=k, with_coverage=True)
    np.testing.assert_array_equal(got_cov.numpy(), np.asarray(cov))
    got = np.rint(pt.unpack_rgba(packed).numpy() * 255)
    np.testing.assert_array_equal(got, np.rint(np.asarray(ref) * 255))
    hit, fb = pt.palette_shares(*args, bilinear=bilinear, block_h=16,
                                k_pages=k)
    assert 0.1 < hit < 0.9 and fb > 0.01 and hit + fb < 0.95, (hit, fb)
