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
from paged_palette_cases import EDGE_CASES, MISS_CASES, edge_case, miss_inputs
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


# --- the palette rule on the page-id edge cases ----------------------------------

SPAN = 4096     # ids the CUDA kernel's bitmap covers from a block's smallest
                # (csrc/paged_texture.cu kSpan); beyond it, its second route


def _edge_args(case):
    return [torch.from_numpy(case["pages"]), torch.from_numpy(case["meta"]),
            case["n_mips"], case["mip_sizes"]] + [
        torch.from_numpy(case[k]) for k in ("layers", "uv", "mip")]


def _brute_served(ids, k):
    """The palette rule block by block in numpy: of each (16,128) block's
    ids below BIG (all channels), the k smallest distinct are served."""
    out = np.zeros(ids.shape, bool)
    for y in range(0, ids.shape[1], 16):
        for x in range(0, ids.shape[2], 128):
            blk = ids[:, y:y + 16, x:x + 128]
            live = np.unique(blk[blk < pt.BIG])
            if live.size:
                thr = live[min(k, live.size) - 1]
                out[:, y:y + 16, x:x + 128] = (blk < pt.BIG) & (blk <= thr)
    return out


def _served_calls(monkeypatch, case, bilinear):
    """(ids, k, served) of the plain version's two _served calls on the
    case: the palette's, then the fallback's (ids BIG where not asked)."""
    calls, orig = [], pt._served

    def rec(ids, block_h, k):
        out = orig(ids, block_h, k)
        calls.append((ids.numpy().copy(), k, out.numpy()))
        return out

    monkeypatch.setattr(pt, "_served", rec)
    pt.paged_sample_plain(*_edge_args(case), bilinear=bilinear, block_h=16,
                          k_pages=case["k_pages"], with_coverage=True)
    assert len(calls) == 2
    return calls


def _blocks(ids):
    """Per (16,128) block: the sorted distinct ids below BIG."""
    return [np.unique(b[b < pt.BIG]) for y in range(0, ids.shape[1], 16)
            for x in range(0, ids.shape[2], 128)
            for b in [ids[:, y:y + 16, x:x + 128]]]


@pytest.mark.parametrize("bilinear", [True, False])
@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_served_matches_brute_force(monkeypatch, name, bilinear):
    """`_served` (the palette and the fallback pages) against the per-block
    rule written out in numpy, on the page-id edge cases."""
    for ids, k, got in _served_calls(monkeypatch, edge_case(name), bilinear):
        np.testing.assert_array_equal(got, _brute_served(ids, k))


def test_edge_cases_reach_their_routes(monkeypatch):
    """Each edge case holds the blocks its docstring names."""
    runs = {name: _served_calls(monkeypatch, edge_case(name), True)
            for name in EDGE_CASES}
    near = lambda b: int((b - b[0] < SPAN).sum())       # inside the bitmap
    k_ex = [b.size for b in _blocks(runs["k_exact"][0][0])]
    assert 16 in k_ex and 17 in k_ex and 0 in k_ex, k_ex
    beyond = _blocks(runs["beyond_n_pages"][0][0])
    inside = [int(((b >= 0) & (b < 64)).sum()) for b in beyond]
    assert any(i < 10 and (b >= 64).any() for i, b in zip(inside, beyond))
    assert any(i > 10 and (b >= 64).any() for i, b in zip(inside, beyond))
    assert any((b < 0).any() for b in beyond) and any(i == 0 for i in inside)
    case = edge_case("negative_base")
    ids = runs["negative_base"][0][0]
    assert (ids[case["layers"] >= 0] >= pt.BIG).any() and (ids < 0).any()
    assert runs["negative_base"][1][2].any()
    wide = _blocks(runs["wide_pool"][0][0])
    assert any(near(b) < 16 <= b.size for b in wide)
    assert any(near(b) < b.size < 16 for b in wide)
    assert any(near(b) >= 16 and b[-1] - b[0] >= SPAN for b in wide)
    fb = _blocks(runs["wide_pool"][1][0])
    assert any(near(b) < min(b.size, 8) for b in fb if b.size)
    layers = edge_case("untextured_edges")["layers"]
    assert layers.shape[1] % 16 and layers.shape[2] % 128
    assert 0 in [b.size for b in _blocks(runs["untextured_edges"][0][0])]


def test_ids_beyond_the_pool_match_chord_tpu():
    """Ids at or above n_pages and below 0, compared before the clamp: the
    port against chord_tpu on the beyond_n_pages case (C=1, K=10, raw,
    nearest), coverage included."""
    case = edge_case("beyond_n_pages")
    ref, cov = jpt.paged_sample(
        *[jnp.asarray(case[k]) for k in ("pages", "meta")], case["n_mips"],
        case["mip_sizes"], *[jnp.asarray(case[k])
                             for k in ("layers", "uv", "mip")],
        bilinear=False, block_h=16, k_pages=case["k_pages"],
        with_coverage=True)
    packed, got_cov = pt.paged_sample(
        *_edge_args(case), bilinear=False, block_h=16,
        k_pages=case["k_pages"], with_coverage=True)
    np.testing.assert_array_equal(got_cov.numpy(), np.asarray(cov))
    np.testing.assert_array_equal(np.rint(pt.unpack_rgba(packed).numpy() * 255),
                                  np.rint(np.asarray(ref) * 255))
