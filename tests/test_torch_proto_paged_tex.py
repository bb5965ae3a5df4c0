"""The port's paged-texture prototype (kernel K10's plain version in
chord_tpu_torch/ops/proto_paged_tex.py and the tool around it) against
chord_tpu's tools/proto_paged_tex.py.

chord_tpu's tool calls pallas_call without `interpret=`; here its module's
`pl` is replaced, for each test, by a shim whose pallas_call runs in
interpret mode. Tolerance: none, every output is an integer (packed RGBA
texels, average colours, -1, coverage flags) and must match exactly.
Inputs keep lm in [-1, entries): past the last entry the reference reads
an undefined page (see the header of chord_tpu_torch/csrc/proto_paged_tex.cu).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.experimental import pallas as pl

import tools.proto_paged_tex as jtool

from chord_tpu_torch.ops import proto_paged_tex as sampler
from chord_tpu_torch.tools import proto_paged_tex as tool
from proto_palette_cases import BIG, sampler_inputs, tile_cases


class _InterpretPallas:
    """jax.experimental.pallas with pallas_call in interpret mode."""

    pallas_call = staticmethod(functools.partial(pl.pallas_call,
                                                 interpret=True))

    def __getattr__(self, name):
        return getattr(pl, name)


@pytest.fixture
def jax_sample(monkeypatch):
    monkeypatch.setattr(jtool, "pl", _InterpretPallas())
    return jtool.paged_sample


def _images(rng, sizes=(256, 128, 64, 32, 16, 8, 4, 2, 1), layers=4):
    return [rng.integers(0, 255, (s, s, 4)).astype(np.uint8)
            for _ in range(layers) for s in sizes]


def _pool(rng):
    pool, meta = tool.build_tiled_pool(_images(rng))
    return pool, meta, 36


def test_build_tiled_pool_matches():
    """The tool's 36 entries plus sizes that are not a multiple of 32."""
    images = _images(np.random.default_rng(0))
    images += _images(np.random.default_rng(1), sizes=(48, 5), layers=1)
    pool, meta = tool.build_tiled_pool(images)
    jpool, jmeta = jtool.build_tiled_pool(images)
    assert pool.dtype == np.int32 and meta.dtype == np.int32
    np.testing.assert_array_equal(pool, np.asarray(jpool))
    np.testing.assert_array_equal(meta, np.asarray(jmeta))


def _random_field(rng, h, w, entries):
    """Random uv in [-2, 3) (negative and past-one coordinates), random
    entries and untextured pixels: many tiles per block, partial
    coverage."""
    u = rng.uniform(-2, 3, (h, w)).astype(np.float32)
    v = rng.uniform(-2, 3, (h, w)).astype(np.float32)
    lm = rng.integers(-1, entries, (h, w)).astype(np.int32)
    return u, v, lm


def _tool_field(h, w):
    """A crop of the tool's coherent field (the 1056x1920 frame's first
    h rows and w columns: the untextured strip and a layer boundary)."""
    yy, xx = np.mgrid[0:1056, 0:1920].astype(np.float32)
    u = (xx / 1920 * 3.1) % 1.0
    v = (yy / 1056 * 1.7) % 1.0
    layer = ((xx // 480) % 4).astype(np.int32)
    lm = layer * 9 + 2
    lm[:, :64] = -1
    return (np.ascontiguousarray(a[:h, :w]) for a in (u, v, lm))


def _few_and_many(rng):
    """Two blocks: the left one asks for 3 distinct tiles (fewer than K),
    the right one for 10 (more than K), both with some negative uv."""
    u = np.zeros((32, 256), np.float32)
    v = np.zeros((32, 256), np.float32)
    lm = np.zeros((32, 256), np.int32)      # entry 0: 256^2, 8x8 tiles
    tiles_l = [(0, 0), (3, 5), (7, 7)]
    tiles_r = [(i % 8, (3 * i) % 8) for i in range(10)]
    for half, tiles in ((0, tiles_l), (1, tiles_r)):
        pick = rng.integers(0, len(tiles), (32, 128))
        tx = np.asarray([t[0] for t in tiles])[pick]
        ty = np.asarray([t[1] for t in tiles])[pick]
        fx = rng.uniform(0, 1, (32, 128))
        fy = rng.uniform(0, 1, (32, 128))
        cols = slice(128 * half, 128 * (half + 1))
        u[:, cols] = (tx + fx) / 8 - 1.0     # one period below: negative
        v[:, cols] = (ty + fy) / 8
    lm[5, 5] = -1
    return u, v, lm


def _inputs(case, rng):
    if case == "random":
        return _random_field(rng, 64, 256, 36)
    if case == "tool_field":
        return _tool_field(64, 512)
    return _few_and_many(rng)


@pytest.mark.parametrize("case", ["random", "tool_field", "few_and_many"])
def test_paged_sample_plain_matches(jax_sample, case):
    rng = np.random.default_rng(3)
    pool, meta, _ = _pool(rng)
    u, v, lm = _inputs(case, rng)
    ref_out, ref_cov = (np.asarray(a) for a in jax_sample(
        jnp.asarray(pool), jnp.asarray(meta), jnp.asarray(u), jnp.asarray(v),
        jnp.asarray(lm)))
    out, cov = sampler.paged_sample(*(torch.from_numpy(a) for a in
                                      (pool, meta, u, v, lm)))
    assert out.dtype == torch.int32 and cov.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref_out)
    np.testing.assert_array_equal(cov.numpy(), ref_cov)
    if case == "random":
        assert 0.0 < ref_cov[lm >= 0].mean() < 1.0    # partial coverage
    if case == "few_and_many":
        assert ref_cov[:, :128].all()                 # 3 tiles: all served
        assert 0.0 < ref_cov[:, 128:].mean() < 1.0    # 10 tiles: six served


@pytest.mark.parametrize("case", ["random", "tool_field", "few_and_many"])
def test_texel_index_is_what_is_served(case):
    """The plain version's texel_index (what chip_smoke counts in K10's
    bound) holds one pool index per served pixel, and the pool there holds
    the texel the pixel got; the tool forwards to the same sampler."""
    rng = np.random.default_rng(3)
    pool, meta, _ = _pool(rng)
    args = [torch.from_numpy(a) for a in (pool, meta, *_inputs(case, rng))]
    texels = []
    out, cov = sampler.paged_sample_plain(*args, texel_index=texels)
    served = (cov > 0) & (args[4] >= 0)
    assert len(texels) == 1 and texels[0].numel() == int(served.sum())
    assert torch.equal(args[0].reshape(-1)[texels[0]], out[served])
    for a, b in zip(tool.paged_sample(*args), (out, cov)):
        assert torch.equal(a, b)


def test_paged_sample_rejects_bad_shapes():
    pool, meta, _ = _pool(np.random.default_rng(0))
    pool, meta = torch.from_numpy(pool), torch.from_numpy(meta)
    u = torch.zeros((32, 128))
    lm = torch.zeros((32, 128), dtype=torch.int32)
    for bad in (dict(u=torch.zeros((16, 128)), v=torch.zeros((16, 128)),
                     lm=lm[:16]),
                dict(u=torch.zeros((32, 64)), v=torch.zeros((32, 64)),
                     lm=lm[:, :64]),
                dict(lm=lm.float()), dict(pool=pool[:12]),
                dict(meta=meta[:3])):
        a = dict(pool=pool, meta=meta, u=u, v=u, lm=lm)
        a.update(bad)
        with pytest.raises(ValueError):
            tool.paged_sample(**a)


def test_tool_main_on_the_cpu(capsys):
    """The port's tool at its full size (1056x1920, 360-tile pool) on the
    CPU: every covered pixel equals the numpy oracle."""
    res = tool.main(device="cpu")
    assert res["hw"] == (1056, 1920)
    assert res["pool_shape"] == (2880, 128) and res["pool_bytes"] == 1474560
    assert res["match"] == 1.0
    assert 0.0 < res["covered"] <= 1.0
    assert res["untextured_ok"]
    assert "exact-match among covered: 100.000%" in capsys.readouterr().out


# --- the kernel's two-level palette (sampler.palette) ----------------------

def _amin_rounds(tile):
    """The plain version's K rounds over whole (BH, BW) blocks of an (H, W)
    tile field (paged_sample_plain) -> (blocks, K): each round's id."""
    tile_b = sampler._blocks(torch.as_tensor(tile, dtype=torch.int64))
    remaining, out = tile_b, []
    for _ in range(sampler.K):
        cur = remaining.amin(1, keepdim=True)
        out.append(cur)
        remaining = torch.where(tile_b == cur, BIG, remaining)
    return torch.cat(out, 1)


def _check_palette(tile):
    """The two-level palette serves, block by block, the ids below BIG
    that the plain rounds serve: in ascending order, each once, then BIG."""
    pal = sampler.palette(torch.as_tensor(tile, dtype=torch.int64))
    rounds = _amin_rounds(tile)
    assert pal.shape == rounds.shape
    for p, r in zip(pal.tolist(), rounds.tolist()):
        served = [t for t in r if t < BIG]
        assert [t for t in p if t < BIG] == served
        assert p == served + [BIG] * (sampler.K - len(served))
        assert served == sorted(set(served))
    return pal


@pytest.mark.parametrize("case", sorted(tile_cases(np.random.default_rng(0))))
def test_palette_rule_matches_plain_rounds(case):
    """Blocks asking for 1, 6, 7 and over 100 distinct tiles, duplicates
    across warps, each warp one tile, untextured blocks, ids that clamp
    (negative, past the pool) or reach BIG."""
    tiles = tile_cases(np.random.default_rng(0))[case]
    pal = _check_palette(tiles)
    n = [len({t for t in blk if t < BIG}) for blk in
         sampler._blocks(torch.as_tensor(tiles)).tolist()]
    want = {"one_tile": 1, "six_tiles": 6, "seven_tiles": 7,
            "untextured": 0}.get(case)
    if want is not None:
        assert n == [want] * len(n)
    if case == "many_tiles":
        assert min(n) > 100
    if case == "clamped_ids":
        assert pal[0, :3].lt(0).all() and pal[0, 3:].ge(1000).all()
        assert pal[1].ge(1000).all() and pal[2].ge(BIG - 50).all()
        assert pal[3].tolist() == [3, 250] + [BIG] * 4
    if case == "one_per_warp":       # each warp holds one palette id
        assert all(v == 16 for v in n)


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), alphabet=st.integers(1, 300),
       untextured=st.floats(0.0, 1.0), lo=st.integers(-500, 2000))
def test_palette_rule_random_fields(seed, alphabet, untextured, lo):
    """Random 64x256 fields of `alphabet` ids from `lo` (ids may be
    negative), a share of them BIG, some at or above BIG."""
    rng = np.random.default_rng(seed)
    tiles = rng.integers(lo, lo + alphabet, (64, 256))
    tiles[rng.uniform(size=tiles.shape) < untextured] = BIG
    tiles[rng.uniform(size=tiles.shape) < 0.01] = BIG + 7
    _check_palette(tiles)


@pytest.mark.parametrize("case", sorted(tile_cases(np.random.default_rng(0))))
def test_palette_is_what_the_plain_sampler_serves(case):
    """Through the sampler's inputs: tile_slot gives back the case's ids,
    and paged_sample_plain serves exactly the textured pixels whose tile
    is in their block's two-level palette, each with its page clamped to
    the pool."""
    rng = np.random.default_rng(1)
    tiles = tile_cases(np.random.default_rng(0))[case]
    args = [torch.from_numpy(a) for a in sampler_inputs(tiles, rng)]
    pool, meta, u, v, lm = args
    tile, slot, _ = sampler.tile_slot(meta, u, v, lm)
    assert torch.equal(tile.long(), torch.from_numpy(tiles))
    out, cov = sampler.paged_sample_plain(*args)
    pal = sampler.palette(tile)                       # (blocks, K)
    h, w = tile.shape
    in_pal = (sampler._blocks(tile)[:, :, None] == pal[:, None, :]).any(2)
    served = sampler._unblocks(in_pal, h, w) & (tile < BIG)
    assert torch.equal(cov.bool(), served | (lm < 0))
    page = torch.clamp(tile, 0, pool.shape[0] // 8 - 1).long()
    texel = pool.reshape(-1)[page * 1024 + slot]
    assert torch.equal(out[served], texel[served])
    assert torch.equal(out[lm < 0], torch.full_like(out[lm < 0], -1))
