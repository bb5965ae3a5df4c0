"""Bilinear footprints of the paged texture sampler (K5) on every block case.

A compressed page stores 4x4-texel blocks, so a bilinear 2x2 footprint
reads one block, two (it straddles a block edge in x or in y) or four (in
both); K5's CUDA kernel loads each distinct block once. `footprint_inputs`
places uv so that all of these occur, together with the 31-texel tile seam
of multi-tile mips (where the footprint moves to the next page and its
apron) and the clamped right and bottom edge. uv is coherent within each
8x128 block, so chord_tpu's page palette covers every pixel: the same
inputs are held against chord_tpu in test_torch_paged_texture.py and
against the CUDA kernel, at tolerance 0, in test_torch_cuda.py.

Here, without chord_tpu: the inputs reach every case, the plain version
equals the full-pool bilinear oracle on raw pages (exactly, as the kernel
rounds), and the compressed decode ramp gives integers in [0, 255] (the
kernel feeds decoded texels to the filter as floats, which is exact only
because of that).
"""

import numpy as np
import pytest
import torch

from chord_tpu_torch.asset.procedural import bench_texture_pool
from chord_tpu_torch.ops import paged_texture as pt
from chord_tpu_torch.ops import texture as to

BH, BW = 8, 128
# one 8x128 block each: (mip, texel x at the left / right pixel, texel y at
# the top row, texel y step a row, integer shift of u and v (wrap))
BLOCKS = [
    (0, 1.0, 17.0, 2.0, 0.01, 0),      # x straddles; no y straddle
    (0, 1.0, 17.0, 4.0, 0.01, -2),     # y straddles, alone and with x
    (0, 24.0, 40.0, 30.0, 0.3, 1),     # the x and y tile seam at 31
    (1, 60.0, 76.0, 66.0, 0.02, 0),    # interior tile of a 5-tile mip
    (1, 120.0, 127.99, 126.0, 0.25, 3),  # the clamped right / bottom edge
    (0, 88.0, 96.0, 89.6, 0.05, -1),   # straddles beside the seam at 93
]


def footprint_inputs():
    """-> (layers (2,H,W) i32, uv (H,W,2) f32, mip (H,W) i32), numpy."""
    sizes = bench_texture_pool().mip_sizes
    h, w = BH * len(BLOCKS), BW
    uv = np.zeros((h, w, 2), np.float32)
    mip = np.zeros((h, w), np.int32)
    xx = np.arange(w, dtype=np.float64) / (w - 1)
    for i, (m, x0, x1, y0, dy, shift) in enumerate(BLOCKS):
        s = float(sizes[m])
        rows = slice(BH * i, BH * (i + 1))
        y = y0 + dy * np.arange(BH)
        uv[rows, :, 0] = shift + (x0 + (x1 - x0) * xx)[None, :] / s
        uv[rows, :, 1] = shift + y[:, None] / s
        mip[rows] = m
    blk = np.arange(h)[:, None] // BH + np.zeros((1, w), np.int64)
    layers = np.stack([(blk * 5 + 1) % 12, (blk * 7 + 4) % 12])
    layers[1][:, ::9] = -1
    return layers.astype(np.int32), uv, mip


def footprint_cases(uv, mip, sizes):
    """Per pixel, as K5 computes it: whether the footprint straddles a
    block edge in x (dx) and in y (dy), and its page tile (tx, ty)."""
    size = np.asarray(sizes)[mip].astype(np.float32)
    out = []
    for c in (0, 1):
        t = uv[..., c] - np.floor(uv[..., c])
        p = t * size
        b0f = np.floor(p - np.float32(0.5))
        b0 = np.clip(b0f, 0, size - 1).astype(np.int64)
        b1 = np.clip(b0f + 1, 0, size - 1).astype(np.int64)
        tile = np.floor((b0 + np.float32(0.5)) * np.float32(1 / 31)).astype(
            np.int64)
        s0, s1 = b0 - 31 * tile, b1 - 31 * tile
        out += [(s0 >> 2) != (s1 >> 2), tile]
    dx, tx, dy, ty = out
    return dx, dy, tx, ty


def test_inputs_reach_every_block_case():
    layers, uv, mip = footprint_inputs()
    dx, dy, tx, ty = footprint_cases(uv, mip, bench_texture_pool().mip_sizes)
    n = {"one block": (~dx & ~dy).sum(), "x": (dx & ~dy).sum(),
         "y": (~dx & dy).sum(), "x and y": (dx & dy).sum()}
    assert all(v >= 20 for v in n.values()), n
    # the tile seam: neighbouring pixels of one block on different pages
    assert (tx[:, 1:] != tx[:, :-1]).any() and (ty[1:] != ty[:-1]).any()
    assert (tx > 1).any() and (ty > 1).any()    # beyond the first tiles


def test_plain_matches_full_pool_oracle():
    """Raw pages: every channel equals bilinear over the full pool, rounded
    as the kernel rounds (layer -1 -> -1)."""
    tp = bench_texture_pool()
    raw = tp.u8()
    pages, meta, n_mips = pt.pack_paged_pool(raw, tp.mip_sizes,
                                             tp.mip_offsets)
    layers, uv, mip = footprint_inputs()
    got = pt.paged_sample(torch.from_numpy(pages), torch.from_numpy(meta),
                          n_mips, tp.mip_sizes, torch.from_numpy(layers),
                          torch.from_numpy(uv), torch.from_numpy(mip))
    got = np.rint(pt.unpack_rgba(got).numpy() * 255)
    for c in range(layers.shape[0]):
        filt = to.sample_pool(torch.from_numpy(raw.astype(np.float32)),
                              tp.mip_sizes, tp.mip_offsets,
                              torch.from_numpy(np.maximum(layers[c], 0)),
                              torch.from_numpy(uv), torch.from_numpy(mip))
        oracle = torch.clamp(filt + 0.5, 0.0, 255.0).to(torch.int32).numpy()
        live = layers[c] >= 0
        np.testing.assert_array_equal(got[c][live], oracle[live])
        assert (got[c][~live] == 255).all()


@pytest.mark.parametrize("sel", [0, 1, 2, 3])
def test_decode_ramp_is_u8(sel):
    """floor((a*(3-sel) + b*sel) * (1/3) + 0.5), rounded at each step in
    f32, is an integer in [0, 255] for all endpoint bytes a, b."""
    a = np.arange(256, dtype=np.float32)[:, None]
    b = np.arange(256, dtype=np.float32)[None, :]
    s = np.float32(sel)
    v = np.floor((a * (np.float32(3.0) - s) + b * s) * np.float32(1.0 / 3.0)
                 + np.float32(0.5))
    assert v.dtype == np.float32
    assert v.min() >= 0 and v.max() <= 255 and (v == np.rint(v)).all()


@pytest.mark.parametrize("sel", [0, 1, 2, 3])
def test_decode_ramp_integer_form(sel):
    """The plain version's ramp (_fetch_plain's f32 arithmetic) equals
    (a*(3-sel) + b*sel + 1) // 3 in integers for all endpoint bytes a, b:
    the form K5 decodes a staged page's ramp in (levels 0 and 3 are the
    endpoints themselves)."""
    a = torch.arange(256, dtype=torch.int64)[:, None].expand(256, 256)
    b = torch.arange(256, dtype=torch.int64)[None, :].expand(256, 256)
    s = torch.full((256, 256), float(sel))
    plain = torch.floor((a.float() * (3.0 - s) + b.float() * s) * (1.0 / 3.0)
                        + 0.5).long()
    assert torch.equal(plain, (a * (3 - sel) + b * sel + 1) // 3)
    if sel in (0, 3):
        assert torch.equal(plain, a if sel == 0 else b)
