"""Inputs for the page palette of kernel K5 (the paged texture sampler),
shared by tests/test_torch_paged_texture.py (the port against chord_tpu on
the CPU) and tests/test_torch_cuda.py (kernel against plain version on the
card); imports no JAX.

`miss_inputs` gives (layers, uv, mip) where, in every (16,128) block, the
palette serves some texels, the fallback mip serves some of the missed
ones and the rest take the average colour. MISS_CASES are the frame's two
palettes (C=4 with 16 pages, C=1 with 10) over raw and compressed pools,
bilinear and nearest, at sizes that are and are not whole blocks.
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
