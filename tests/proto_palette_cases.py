"""Inputs for the palette rule of the proto sampler (kernel K10), shared by
tests/test_torch_proto_paged_tex.py (on the CPU) and tests/test_torch_cuda.py
(kernel against plain version on the card); imports no JAX.

`tile_cases` gives (H, W) tile-id fields: pixel blocks asking for 1, 6, 7
and more than 100 distinct tiles, duplicates across the kernel's warps,
all-BIG (untextured) blocks, and ids that clamp (negative, at or past the
pool's tiles) or reach BIG. `sampler_inputs` turns such a field into the
sampler's (pool, meta, u, v, lm): meta entries whose first tile is 0, a
negative id, one past the pool and just below BIG, each 16x16 tiles of
32x32 texels, and u, v at texel centres of the wanted tile.
"""

import numpy as np

from chord_tpu_torch.ops import proto_paged_tex as pt

BIG = pt.BIG
SPAN = 256                                # tiles of one meta entry (16x16)
# first tile of meta entries 0-3: in range, negative, past the pool, and
# straddling BIG (its last 56 tiles lie at or above BIG)
BASES = (0, -300, 1000, BIG - 200)


def _block_grid(f, by=2, bx=2):
    """A (32*by, 128*bx) field, block (i, j) = f(i, j) of shape (32, 128)."""
    return np.block([[f(i, j) for j in range(bx)] for i in range(by)])


def tile_cases(rng) -> dict:
    """{name: (H, W) int64 tile ids}: ids are taken from BASES[e] + [0,
    SPAN) so sampler_inputs can realise them, or BIG (untextured)."""
    def pick(ids, shape=(32, 128)):
        return rng.choice(np.asarray(ids), shape)

    cases = {}
    cases["one_tile"] = _block_grid(lambda i, j: np.full((32, 128), 17 + i + j))
    cases["six_tiles"] = _block_grid(lambda i, j: pick(np.arange(6) * 7 + i))
    cases["seven_tiles"] = _block_grid(lambda i, j: pick(np.arange(7) * 5 + j))
    cases["many_tiles"] = _block_grid(lambda i, j: rng.integers(0, SPAN,
                                                                (32, 128)))

    def across_warps(i, j):
        # warp w (rows w and w + 16) asks for tiles w..w+7: every id below
        # 16 + 7 appears in several warps, each warp's list differs
        b = np.zeros((32, 128), np.int64)
        for w in range(16):
            for r in (w, w + 16):
                b[r] = rng.integers(w, w + 8, 128) + 40 * i
        return b
    cases["dup_across_warps"] = _block_grid(across_warps)

    def one_per_warp(i, j):
        # each warp asks for one tile only; the 16 warps' tiles differ, and
        # the block's six smallest sit in six different warps
        b = np.zeros((32, 128), np.int64)
        for w, t in enumerate(rng.permutation(16) * 3 + j):
            b[w] = b[w + 16] = t
        return b
    cases["one_per_warp"] = _block_grid(one_per_warp)
    cases["untextured"] = np.full((64, 256), BIG, np.int64)

    negative = BASES[1] + np.arange(0, SPAN, 37)
    past_pool = BASES[2] + np.arange(0, SPAN, 41)
    near_big = BASES[3] + np.arange(150, SPAN, 9)     # 6 below BIG, 6 above

    def clamped(i, j):
        # negative ids, ids past the pool and ids at or above BIG, with
        # untextured pixels: block (0, 0) serves 3 negative ids and 3 past
        # the pool, (0, 1) 6 past the pool, (1, 0) the 6 just below BIG,
        # (1, 1) the two in-range ids, every id above BIG left out
        ids = [[np.concatenate([negative[:3], past_pool, near_big, [BIG]]),
                np.concatenate([past_pool, near_big])],
               [np.concatenate([near_big, [BIG]]),
                np.concatenate([near_big[6:], [BIG, 3, 250]])]][i][j]
        return pick(ids)
    cases["clamped_ids"] = _block_grid(clamped)

    def partly_untextured(i, j):
        b = pick(np.arange(9) * 11 + i)
        b[rng.uniform(size=b.shape) < 0.5] = BIG
        return b
    cases["partly_untextured"] = _block_grid(partly_untextured)
    return cases


def sampler_inputs(tiles, rng, n_tiles: int = 300):
    """A tile-id field -> the sampler's numpy inputs (pool (n_tiles*8,
    128), meta (4, 128), u, v (H, W) f32, lm (H, W) i32) whose tile ids
    (ops/proto_paged_tex.tile_slot) are `tiles`: the id's entry e (the
    BASES[e] it lies above), u and v at the centre of a random texel of
    tile id - BASES[e]; BIG -> lm = -1."""
    h, w = tiles.shape
    pool = rng.integers(-2**31, 2**31, (n_tiles * 8, 128)).astype(np.int32)
    meta = np.zeros((4, 128), np.int32)
    meta[0, :4] = BASES
    meta[1, :4] = 16                              # tiles per row
    meta[2, :4] = 16 * pt.TILE                    # size 512
    meta[3] = rng.integers(-2**31, 2**31, 128)    # average colours
    lm = np.full((h, w), -1, np.int32)
    local = np.zeros((h, w), np.int64)
    for e in range(4):
        inside = (tiles >= BASES[e]) & (tiles < BASES[e] + SPAN) & \
            (tiles != BIG)
        lm[inside] = e
        local[inside] = tiles[inside] - BASES[e]
    size = 16 * pt.TILE
    x = (local % 16) * pt.TILE + rng.integers(0, pt.TILE, (h, w))
    y = (local // 16) * pt.TILE + rng.integers(0, pt.TILE, (h, w))
    # (x + 0.5) / 512 is exact in f32, and so is its product with 512
    u = ((x + 0.5) / size).astype(np.float32)
    v = ((y + 0.5) / size).astype(np.float32)
    return pool, meta, u, v, lm
