"""Inputs for the page palette of kernel K5 (the paged texture sampler),
shared by tests/test_torch_paged_texture.py (the port against chord_tpu on
the CPU) and tests/test_torch_cuda.py (kernel against plain version on the
card); imports no JAX.

`miss_inputs` gives (layers, uv, mip) where, in every (16,128) block, the
palette serves some texels, the fallback mip serves some of the missed
ones and the rest take the average colour. MISS_CASES are the frame's two
palettes (C=4 with 16 pages, C=1 with 10) over raw and compressed pools,
bilinear and nearest, at sizes that are and are not whole blocks.

`edge_case(name)` gives the page-id edge cases of the palette (EDGE_CASES:
exactly K and K + 1 distinct ids in a block, ids at or above n_pages and
below 0, ids at or above BIG, a pool wider than the CUDA kernel's bitmap
with ids far apart in one block, untextured and partial blocks, a mip
too large for the kernel's FP32-pipe conversions), each a
dict of the sampler's arguments on a synthetic pool; chip_smoke.py runs
them on the card too.
"""

import numpy as np

# (C, k_pages, compress, bilinear, H, W)
MISS_CASES = [(4, 16, False, True, 16, 128), (4, 16, True, False, 20, 200),
              (1, 10, True, True, 20, 200), (1, 10, False, False, 16, 256)]


def miss_inputs(c, h, w, seed):
    """Per 128-column block: columns [0, 64) sample one mip of layers
    0..C-1 coherently (the lowest page ids: palette hits), columns
    [64, 128) random uv, mips 0..8 and layers 4..11 (misses; their
    fallback pages, 8 layers x mips 4..8 of the 256² bench pool, overflow
    the C+4 fallback slots, so the average colour shows); some texels
    untextured, some mips out of range."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    coherent = (xx % 128) < 64
    uv = np.stack([0.37 + xx * 0.0011, -1.21 + yy * 0.0017], -1)
    uv = np.where(coherent[..., None], uv, rng.uniform(-2, 2, (h, w, 2)))
    mip = np.where(coherent, (yy // 16 + 1) % 6,
                   rng.integers(0, 9, (h, w))).astype(np.int32)
    mip[0, 70:74] = -1             # clamps to 0
    mip[-1, 90:94] = 12            # clamps to the 1x1 tail
    layers = np.where(coherent[None], np.arange(c)[:, None, None],
                      rng.integers(4, 12, (c, h, w)))
    layers[rng.random((c, h, w)) < 0.05] = -1
    return (layers.astype(np.int32), uv.astype(np.float32),
            mip.astype(np.int32))


# --- page-id edge cases ---------------------------------------------------------
#
# Synthetic pools whose meta places each entry's page id where a case wants
# it: 48 layers of a 64² texture (mips 64 .. 1; the fallback mip is 2, of
# size 16; mips 0 and 1 span 3x3 and 2x2 page tiles, so their ids add the
# footprint's tile), random page words and average colours. Each case names
# per (16,128) block the layers its channels draw from and the mips its
# pixels draw from (None: the block is untextured); 3% of the texels are
# untextured everywhere.

EDGE_SIZES = (64, 32, 16, 8, 4, 2, 1)
EDGE_LAYERS = 48
BIG = 1 << 30


def _edge_case(c, k, compress, h, w, n_pages, base, blocks, seed,
               sizes=EDGE_SIZES):
    """base(layer, mip) -> the entry's page id; blocks(by, bx) -> (layers
    or None, mips)."""
    rng = np.random.default_rng(seed)
    n_mips = len(sizes)
    e_pad = -(-EDGE_LAYERS * n_mips // 128) * 128
    meta = np.zeros((3 if compress else 2, e_pad), np.int64)
    for layer in range(EDGE_LAYERS):
        for m in range(n_mips):
            meta[0, layer * n_mips + m] = base(layer, m)
    meta[1] = rng.integers(-2 ** 31, 2 ** 31, e_pad)
    rows = 2 if compress else 8
    pages = rng.integers(-2 ** 31, 2 ** 31, (n_pages * rows, 128))
    layers = np.full((c, h, w), -1, np.int64)
    mip = np.zeros((h, w), np.int64)
    for by in range(-(-h // 16)):
        for bx in range(-(-w // 128)):
            lay, mips = blocks(by, bx)
            sl = (slice(16 * by, 16 * by + 16), slice(128 * bx, 128 * bx + 128))
            mip[sl] = rng.choice(mips, mip[sl].shape)
            if lay is not None:
                layers[(slice(None),) + sl] = rng.choice(
                    lay, layers[(slice(None),) + sl].shape)
    layers[rng.random(layers.shape) < 0.03] = -1
    uv = rng.uniform(-2, 2, (h, w, 2))
    return dict(pages=pages.astype(np.int32), meta=meta.astype(np.int32),
                n_mips=n_mips, mip_sizes=sizes,
                layers=layers.astype(np.int32), uv=uv.astype(np.float32),
                mip=mip.astype(np.int32), k_pages=k)


def _k_exact():
    """C=4, K=16, compressed: blocks with exactly K distinct ids (16 layers
    at one mip; 8 layers at two), K + 1 and K + 2, an untextured block and
    a tiled block whose ids overlap the next layers' (the fallback)."""
    sets = {(0, 0): (list(range(16)), [2]), (0, 1): (list(range(17)), [2]),
            (0, 2): (list(range(8)), [2, 3]), (1, 0): (list(range(9)), [2, 3]),
            (1, 1): (None, [0]), (1, 2): (list(range(4)), [0, 1])}
    return _edge_case(4, 16, True, 32, 384, 400, lambda l, m: 7 * l + m,
                      lambda by, bx: sets[by, bx], seed=11)


def _beyond_n_pages():
    """C=1, K=10, raw: layers 0-19 hold ids inside the 64-page pool, 20-47
    ids at or above it (compared before the clamp); blocks with fewer than
    K ids in range (4 in, 20 beyond), with more (15 in, 6 beyond), negative
    ids (layers 40-47) below both, and every id beyond."""
    def base(layer, m):
        if layer < 20:
            return 3 * layer + (m > 2)
        if layer < 40:
            return 64 + 5 * layer + m
        return -9 * layer - m

    sets = {(0, 0): (list(range(4)) + list(range(20, 40)), [2, 4]),
            (0, 1): (list(range(15)) + list(range(20, 26)), [2]),
            (1, 0): (list(range(40, 48)) + list(range(3)) + [30, 31], [0, 2]),
            (1, 1): (list(range(20, 40)), [1, 5])}
    return _edge_case(1, 10, False, 32, 256, 64, base,
                      lambda by, bx: sets[by, bx], seed=12)


def _negative_base():
    """C=2, K=16, compressed: negative bases in meta (with the tiles of
    mips 0 and 1 added), ids beyond the pool, and ids at or above BIG (no
    page: those texels take the fallback or the average colour)."""
    def base(layer, m):
        if layer % 8 == 7:
            return BIG + layer
        return -200 + 11 * layer + m if layer < 24 else 150 + 3 * layer + m

    sets = {(0, 0): (list(range(0, 24, 2)) + [7, 15], [0, 1, 2]),
            (0, 1): (list(range(12, 40)), [0, 2, 3]),
            (1, 0): ([7, 15, 23, 31], [0, 2]),
            (1, 1): (list(range(0, 48, 3)), [1, 3])}
    return _edge_case(2, 16, True, 32, 256, 128, base,
                      lambda by, bx: sets[by, bx], seed=13)


def _wide_pool():
    """C=4, K=16, compressed, a 10,000-page pool, wider than the kernel's
    4,096-id bitmap, with ids far apart in one block: 6 ids near 0 and 16
    beyond 7,000 (the bitmap from the block's smallest id holds fewer than
    K, the rest come from beyond it); 21 near 0 and 8 beyond (the bitmap
    alone holds K); one id near -1,000,000, one at 0 and one beyond 7,000
    (fewer than K in all); and, under tiled mips, fallback pages (mip 2)
    from 540 to 8,460."""
    def base(layer, m):
        if layer == 30:
            return -1_000_000 + m
        return 180 * layer if m == 2 else 230 * layer + m

    sets = {(0, 0): ([0, 1, 2] + list(range(40, 48)), [2, 3]),
            (0, 1): (list(range(21)) + list(range(40, 48)), [2]),
            (1, 0): ([30, 0, 41], [2]),
            (1, 1): ([3, 9, 17, 26, 37, 44, 47], [0, 1])}
    return _edge_case(4, 16, True, 32, 256, 10_000, base,
                      lambda by, bx: sets[by, bx], seed=14)


def _untextured_edges():
    """C=3, K=16, raw, at 40x300: partial blocks at the right and bottom
    edge, untextured blocks, and blocks of one layer."""
    sets = lambda by, bx: ((None, [0]) if (by + bx) % 3 == 1 else
                           ([by * 3 + bx], [0, 1, 2]) if bx == 2 else
                           (list(range(10 * by, 10 * by + 12)), [0, 1, 2, 6]))
    return _edge_case(3, 16, False, 40, 300, 360, lambda l, m: 7 * l + m,
                      sets, seed=15)


def _huge_mip():
    """C=2, K=16, compressed: a mip table whose first mip is 3,000,000
    texels a side (96,775 page tiles a row: tile ids wrap in int32, as
    they do in both versions), so the CUDA kernel takes its general
    float-to-int conversions (kSmall false) in the tap math."""
    sizes = (3_000_000, 16, 4, 1)
    sets = {(0, 0): (list(range(6)), [0, 1]), (0, 1): (list(range(40)), [0])}
    return _edge_case(2, 16, True, 16, 256, 64, lambda l, m: 5 * l + m,
                      lambda by, bx: sets[by, bx], seed=16, sizes=sizes)


EDGE_CASES = {"k_exact": _k_exact, "beyond_n_pages": _beyond_n_pages,
              "negative_base": _negative_base, "wide_pool": _wide_pool,
              "untextured_edges": _untextured_edges, "huge_mip": _huge_mip}


def edge_case(name):
    """-> dict(pages, meta, n_mips, mip_sizes, layers, uv, mip, k_pages) of
    numpy arrays (the sampler's arguments but `bilinear` and `block_h`)."""
    return EDGE_CASES[name]()
