"""Paged virtual-texture sampler (port of chord_tpu/ops/paged_texture.py).

Host half (numpy, bit-exact with chord_tpu): every (layer, mip) image is
cut into 32x32-texel PAGES with a one-texel apron (31 usable texels per
axis; row/column 31 repeats the neighbour's first texel), so a bilinear
2x2 footprint never crosses a page. A raw page is 1024 RGBA8-packed int32
texels (8 rows of 128); a block-compressed page (`compress_page`) is two
rows of 128: per 4x4 block two RGBA8 endpoints and sixteen 2-bit
selectors into a 4-point ramp. `meta` maps entry = layer * n_mips + mip
to the entry's first page; a 3-row meta marks the compressed format.

Device half, kernel K5:

    paged_sample   CUDA kernel csrc/paged_texture.cu (CUDA tensors) or
                   paged_sample_plain (CPU tensors)

Replaces chord_tpu/ops/paged_texture.py::_paged_kernel (:251, called by
paged_sample :442) and computes its function: per (block_h,128) pixel
block only the k_pages smallest distinct page ids of the block's
(channel, pixel)s are served (the palette; the frame uses block_h 16 and
16 pages for the fused maps, 10 for one map, as chord_tpu/ops/texture.py).
A texel whose page misses reads the single-page fallback mip if its page
is among the block's C+4 smallest distinct fallback pages, else the
entry's average colour. The palette decides the value, so the port keeps
it; on the GPU a block stages its served compressed pages in shared
memory (selector words and ramp colours), as chord_tpu stages each served
page, and reads raw pages from L2.

The wrapper returns the packed (C,H,W) int32 texels; `unpack_rgba` turns
them into f32 RGBA in PyTorch, as chord_tpu unpacks outside its kernel.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import _cuda
from ._util import f2i

TILE = 32          # stored page edge (texels)
USABLE = 31        # usable texels per axis (1-texel apron)
MAX_MIPS = 16      # mip table size the kernel takes by value
BIG = 1 << 30      # the palette's "no page" id


# --- host half (numpy) -----------------------------------------------------

def _pca_axis(d: np.ndarray) -> np.ndarray:
    """Dominant axis of centred block texels via power iteration.
    d: (B, 16, 4) -> (B, 4) unit axes (zero blocks -> arbitrary unit)."""
    cov = np.einsum("bti,btj->bij", d, d)
    v = np.ones((d.shape[0], 4), np.float64)
    for _ in range(8):
        v = np.einsum("bij,bj->bi", cov, v)
        n = np.linalg.norm(v, axis=1, keepdims=True)
        v = np.where(n > 1e-12, v / np.maximum(n, 1e-12), 1.0)
    return v


def _decode_palette(e0: np.ndarray, e1: np.ndarray) -> np.ndarray:
    """The kernel's exact 4-point decode ramp in f32.
    e0/e1: (B, 4) u8-valued -> (B, 4 levels, 4 ch) u8-valued f32."""
    a = e0.astype(np.float32)[:, None, :]
    b = e1.astype(np.float32)[:, None, :]
    k = np.arange(4, dtype=np.float32)[None, :, None]
    ramp = (a * (np.float32(3.0) - k) + b * k).astype(np.float32)
    return np.floor(ramp * np.float32(1.0 / 3.0) + np.float32(0.5))


def compress_page(img32: np.ndarray) -> np.ndarray:
    """(32,32,4) u8 apron page -> (2,128) u32 block-compressed page.

    Per 4x4 block: two RGBA8 endpoints on the block's principal colour
    axis and 16 2-bit selectors, chosen nearest-of-4 against the quantised
    ramp the decoder applies. Layout: row 0 lanes [0,64) endpoint 0 per
    block, lanes [64,128) endpoint 1; row 1 lanes [0,64) the selector word
    (texel t = (sy%4)*4 + sx%4 at bits 2t), lanes [64,128) zero."""
    blocks = (img32.reshape(8, 4, 8, 4, 4).transpose(0, 2, 1, 3, 4)
              .reshape(64, 16, 4).astype(np.float64))
    mean = blocks.mean(1, keepdims=True)
    d = blocks - mean
    axis = _pca_axis(d)
    proj = np.einsum("bti,bi->bt", d, axis)
    pmin = proj.min(1)
    pmax = proj.max(1)
    e0 = np.clip(np.round(mean[:, 0] + axis * pmin[:, None]), 0, 255)
    e1 = np.clip(np.round(mean[:, 0] + axis * pmax[:, None]), 0, 255)
    pal = _decode_palette(e0, e1)                        # (64,4,4)
    err = ((blocks[:, :, None, :] - pal[:, None, :, :]) ** 2).sum(-1)
    sel = err.argmin(-1).astype(np.uint32)               # (64,16)
    e0u = e0.astype(np.uint32)
    e1u = e1.astype(np.uint32)
    pack = lambda e: (e[:, 0] | (e[:, 1] << 8) | (e[:, 2] << 16) |
                      (e[:, 3] << 24))
    selw = (sel << (2 * np.arange(16, dtype=np.uint32))[None]).sum(
        1, dtype=np.uint32)
    out = np.zeros((2, 128), np.uint32)
    out[0, :64] = pack(e0u)
    out[0, 64:] = pack(e1u)
    out[1, :64] = selw
    return out


def decompress_page(comp: np.ndarray) -> np.ndarray:
    """Host decode of one page: (2,128) u32 -> (32,32,4) u8."""
    e0w = comp[0, :64]
    e1w = comp[0, 64:]
    selw = comp[1, :64]
    unpack = lambda w: np.stack([(w >> s) & 255 for s in (0, 8, 16, 24)],
                                -1).astype(np.float64)
    pal = _decode_palette(unpack(e0w), unpack(e1w))      # (64,4,4)
    t = np.arange(16, dtype=np.uint32)
    sel = (selw[:, None] >> (2 * t)[None]) & 3           # (64,16)
    tex = pal[np.arange(64)[:, None], sel]               # (64,16,4)
    return (tex.reshape(8, 8, 4, 4, 4).transpose(0, 2, 1, 3, 4)
            .reshape(32, 32, 4).astype(np.uint8))


def pack_paged_pool(pool_u8: np.ndarray, mip_sizes: Sequence[int],
                    mip_offsets: Sequence[int], compress: bool = False
                    ) -> Tuple[np.ndarray, np.ndarray, int]:
    """(L, total, 4) u8 flat-mip stack -> (pages (N*8,128) i32,
    meta (2, E_pad) i32 [page base | avg RGBA8], n_mips), numpy.

    With compress=True pages are (2,128) compressed units and meta grows a
    third (zero) row that marks the format. Entry id = layer * n_mips +
    mip; pages are stored entry-major."""
    n_layers = pool_u8.shape[0]
    n_mips = len(mip_sizes)
    entries = n_layers * n_mips
    e_pad = max((entries + 127) // 128 * 128, 128)
    base = np.zeros(e_pad, np.int32)
    avg = np.zeros(e_pad, np.uint32)
    pages: List[np.ndarray] = []
    for layer in range(n_layers):
        for m, (s, off) in enumerate(zip(mip_sizes, mip_offsets)):
            img = pool_u8[layer, off:off + s * s].reshape(s, s, 4)
            packed = (img[..., 0].astype(np.uint32) |
                      (img[..., 1].astype(np.uint32) << 8) |
                      (img[..., 2].astype(np.uint32) << 16) |
                      (img[..., 3].astype(np.uint32) << 24))
            e = layer * n_mips + m
            base[e] = len(pages)
            a = img.reshape(-1, 4).mean(0).astype(np.uint32)
            avg[e] = a[0] | (a[1] << 8) | (a[2] << 16) | (a[3] << 24)
            tcnt = _tiles(s)
            # clamped apron sampling (taps clamp to s-1, as sample_pool)
            idx = np.minimum(np.arange(TILE), s - 1)
            for ty in range(tcnt):
                gy = np.minimum(ty * USABLE + idx, s - 1)
                for tx in range(tcnt):
                    gx = np.minimum(tx * USABLE + idx, s - 1)
                    page = packed[np.ix_(gy, gx)]
                    if compress:
                        rgba = np.stack(
                            [(page >> sh) & 255 for sh in (0, 8, 16, 24)],
                            -1).astype(np.uint8)
                        pages.append(compress_page(rgba))
                    else:
                        pages.append(page.reshape(8, 128))
    rows = 2 if compress else 8
    if not pages:
        pages.append(np.zeros((rows, 128), np.uint32))
    pages_np = np.concatenate(pages, 0).astype(np.uint32).view(np.int32)
    meta_rows = [base, avg.view(np.int32)]
    if compress:
        meta_rows.append(np.zeros(e_pad, np.int32))   # format marker row
    return pages_np, np.stack(meta_rows), n_mips


def _tiles(s: int) -> int:
    return 1 if s <= USABLE else -(-s // USABLE)


def paged_pool_bytes(tex_pool_shape, mip_sizes, compress=False) -> int:
    """Pages footprint in bytes for a (L, total, 4) pool."""
    per_layer = sum(_tiles(s) ** 2 for s in mip_sizes)
    page_bytes = 2 * 128 * 4 if compress else TILE * TILE * 4
    return tex_pool_shape[0] * per_layer * page_bytes


# --- K5: the plain version ---------------------------------------------------

def _clampi(x: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """clip(x, 0, hi) for int32 tensors."""
    return torch.minimum(torch.clamp_min(x, 0), hi)


def _fetch_plain(pages: torch.Tensor, page: torch.Tensor, slot: torch.Tensor,
                 compressed: bool) -> torch.Tensor:
    """Packed RGBA8 texel at `slot` (= sy*32 + sx) of `page`; a compressed
    page decodes the texel's 4x4 block as csrc/paged_texture.cu does."""
    flat = pages.reshape(-1)
    if not compressed:
        return flat[page.long() * (TILE * TILE) + slot.long()]
    sy, sx = slot >> 5, slot & 31
    base = page.long() * 256 + ((sy >> 2) * 8 + (sx >> 2)).long()
    e0, e1, sw = flat[base], flat[base + 64], flat[base + 128]
    t = (sy & 3) * 4 + (sx & 3)
    sel = ((sw >> (2 * t)) & 3).float()
    out = torch.zeros_like(e0, dtype=torch.int64)
    for sh in (0, 8, 16, 24):
        a = ((e0 >> sh) & 255).float()
        b = ((e1 >> sh) & 255).float()
        val = torch.floor((a * (3.0 - sel) + b * sel) * (1.0 / 3.0) + 0.5)
        out = out | (val.to(torch.int64) << sh)
    return _wrap_i32(out)


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a u32 bit pattern -> int32 with the same bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def _channels(p: torch.Tensor) -> List[torch.Tensor]:
    return [((p >> sh) & 255).float() for sh in (0, 8, 16, 24)]


def _tap_slots(uv: torch.Tensor, size: torch.Tensor, tcnt, bilinear: bool):
    """The tap math of one mip per pixel: u wraps, taps clamp to `size`,
    the footprint's page tile is floor((b + .5) / 31) (tcnt tiles a row;
    None: the page is the mip's only one, slots unshifted) -> (tile, slots,
    fx, fy)."""
    sf = size.float()
    u, v = uv[..., 0], uv[..., 1]
    x = (u - torch.floor(u)) * sf
    y = (v - torch.floor(v)) * sf
    fx = fy = None
    if bilinear:
        x0f = torch.floor(x - 0.5)
        y0f = torch.floor(y - 0.5)
        fx = x - 0.5 - x0f
        fy = y - 0.5 - y0f
    else:
        x0f = torch.floor(x)
        y0f = torch.floor(y)
    x0, y0 = f2i(x0f), f2i(y0f)
    smax = size - 1
    bx0, by0 = _clampi(x0, smax), _clampi(y0, smax)
    bx1, by1 = _clampi(x0 + 1, smax), _clampi(y0 + 1, smax)
    tile = torch.zeros_like(bx0)
    if tcnt is not None:
        tx = f2i((bx0.float() + 0.5) * (1.0 / USABLE))
        ty = f2i((by0.float() + 0.5) * (1.0 / USABLE))
        bx0, bx1 = bx0 - tx * USABLE, bx1 - tx * USABLE
        by0, by1 = by0 - ty * USABLE, by1 - ty * USABLE
        tile = ty * tcnt + tx
    if bilinear:
        slots = (by0 * TILE + bx0, by0 * TILE + bx1,
                 by1 * TILE + bx0, by1 * TILE + bx1)
    else:
        slots = (by0 * TILE + bx0,)
    return tile, slots, fx, fy


def _filter(pages, page, slots, fx, fy, compressed):
    """Packed RGBA8 sample of `page` (C,H,W) at the shared `slots`:
    bilinear filters the four taps in f32 left to right and rounds to u8,
    nearest returns the texel as stored."""
    taps = [_fetch_plain(pages, page, s[None].expand_as(page), compressed)
            for s in slots]
    if fx is None:
        return taps[0]
    c00, c01, c10, c11 = (_channels(t) for t in taps)
    out = torch.zeros(page.shape, dtype=torch.int64, device=page.device)
    for i, sh in enumerate((0, 8, 16, 24)):
        val = (c00[i] * (1 - fx) * (1 - fy) + c01[i] * fx * (1 - fy) +
               c10[i] * (1 - fx) * fy + c11[i] * fx * fy)
        ch = f2i(torch.clamp(val + 0.5, 0.0, 255.0))
        out = out | (ch.to(torch.int64) << sh)
    return _wrap_i32(out)


def _served(ids: torch.Tensor, block_h: int, k: int) -> torch.Tensor:
    """The palette rule: per (block_h,128) pixel block of (C,H,W) `ids`
    (blocks aligned at the origin, all C channels together), the k
    smallest distinct ids below BIG are served -> (C,H,W) bool."""
    c, h, w = ids.shape
    hp, wp = -(-h // block_h) * block_h, -(-w // 128) * 128
    key = torch.full((c, hp, wp), BIG, dtype=torch.int64, device=ids.device)
    key[:, :h, :w] = torch.clamp_max(ids.long(), BIG)
    nby, nbx = hp // block_h, wp // 128
    blocks = (key.reshape(c, nby, block_h, nbx, 128)
              .permute(1, 3, 0, 2, 4).reshape(nby * nbx, -1))
    srt = torch.sort(blocks, dim=1).values
    new = torch.ones_like(srt, dtype=torch.bool)
    new[:, 1:] = srt[:, 1:] != srt[:, :-1]
    rank = torch.cumsum(new.long(), dim=1)
    lowest = torch.iinfo(torch.int64).min
    thr = torch.where((rank <= k) & (srt < BIG), srt,
                      torch.full_like(srt, lowest)).amax(dim=1)
    thr = thr.reshape(nby, 1, nbx, 1).expand(nby, block_h, nbx, 128)
    thr = thr.reshape(hp, wp)[:h, :w]
    return (ids.long() <= thr[None]) & (ids.long() < BIG)


def fallback_mip(mip_sizes: Sequence[int], n_mips: int) -> int:
    """The first mip that fits one page (size <= 16), else the last: the
    mip a palette miss falls back to (never finer than the one asked)."""
    return next((m for m, s in enumerate(mip_sizes) if s <= 16), n_mips - 1)


def _palette(pages, meta, n_mips, mip_sizes, layers, uv, mip, bilinear,
             block_h, k_pages):
    """The per-(channel, pixel) cases of K5 -> (entry, page, served,
    fallback page, fallback served, main taps, fallback taps)."""
    dev = layers.device
    compressed = meta.shape[0] == 3
    n_pages = pages.shape[0] // (2 if compressed else 8)
    e_pad = meta.shape[1]
    sizes_l = [int(s) for s in mip_sizes[:n_mips]]
    fb_idx = fallback_mip(mip_sizes, n_mips)
    if int(mip_sizes[fb_idx]) > TILE:
        raise ValueError(f"the fallback mip ({mip_sizes[fb_idx]}) must fit "
                         "one page")
    m = torch.clamp(mip, 0, n_mips - 1).long()
    size = torch.tensor(sizes_l, dtype=torch.int32, device=dev)[m]
    tcnt = torch.tensor([_tiles(s) for s in sizes_l], dtype=torch.int32,
                        device=dev)[m]
    main = _tap_slots(uv, size, tcnt, bilinear)
    fb_m = torch.clamp_min(m, fb_idx)
    fb_size = torch.tensor([int(s) for s in mip_sizes], dtype=torch.int32,
                           device=dev)[fb_m]
    fall = _tap_slots(uv, fb_size, None, bilinear)

    textured = layers >= 0
    entry = torch.clamp(layers * n_mips + m.to(torch.int32)[None], 0,
                        e_pad - 1)
    ids = meta[0][entry.long()] + main[0][None]
    big = torch.full_like(ids, BIG)
    served = _served(torch.where(textured, ids, big), block_h, k_pages)
    fb_entry = torch.clamp(layers * n_mips + fb_m.to(torch.int32)[None], 0,
                           e_pad - 1)
    fb_ids = meta[0][fb_entry.long()]
    fb_served = _served(torch.where(textured & ~served, fb_ids, big),
                        block_h, layers.shape[0] + 4)
    page = torch.clamp(ids, 0, n_pages - 1)
    fb_page = torch.clamp(fb_ids, 0, n_pages - 1)
    return entry, page, served, fb_page, fb_served, main, fall


def paged_sample_plain(pages: torch.Tensor, meta: torch.Tensor, n_mips: int,
                       mip_sizes: Sequence[int], layers: torch.Tensor,
                       uv: torch.Tensor, mip: torch.Tensor,
                       bilinear: bool = True, block_h: int = 16,
                       k_pages: int = 16, with_coverage: bool = False):
    """Plain PyTorch version of kernel K5 -> (C,H,W) int32 packed RGBA8
    (-1, i.e. 1.0 after unpacking, where layer < 0); with_coverage also
    (C,H,W) bool, True where the palette served the texel or layer < 0.

    Per pixel (shared by the C channels): u wraps, taps clamp to the mip's
    size, the tap footprint's page tile is floor((b + .5) / 31) and the
    slots index the 32x32 apron page; per channel the page id is
    meta[0][layer * n_mips + mip] + tile. Per (block_h,128) block only
    the k_pages smallest distinct ids are served (the palette): those
    texels are filtered from their page (bilinear: four taps in f32,
    rounded to u8; nearest: the texel as stored). A missed texel reads the
    single-page fallback mip max(mip, fallback_mip) (entry page, no tile,
    taps at its size) if its page is among the C+4 smallest distinct
    fallback pages of the block's missed texels, else the entry's average
    colour meta[1]."""
    entry, page, served, fb_page, fb_served, main, fall = _palette(
        pages, meta, n_mips, mip_sizes, layers, uv, mip, bilinear, block_h,
        k_pages)
    compressed = meta.shape[0] == 3
    full = _filter(pages, page, main[1], main[2], main[3], compressed)
    coarse = _filter(pages, fb_page, fall[1], fall[2], fall[3], compressed)
    avg = meta[1][entry.long()]
    packed = torch.where(served, full, torch.where(fb_served, coarse, avg))
    untextured = layers < 0
    packed = torch.where(untextured, torch.full_like(packed, -1), packed)
    if with_coverage:
        return packed, served | untextured
    return packed


def palette_shares(pages, meta, n_mips, mip_sizes, layers, uv, mip,
                   bilinear=True, block_h=16, k_pages=16
                   ) -> Tuple[float, float]:
    """(palette hit share, fallback share) of the textured (channel, pixel)s
    of a K5 call; the rest took the average colour."""
    _, _, served, _, fb_served, _, _ = _palette(
        pages, meta, n_mips, mip_sizes, layers, uv, mip, bilinear, block_h,
        k_pages)
    n = max(int((layers >= 0).sum()), 1)
    return int(served.sum()) / n, int(fb_served.sum()) / n


# --- K5: the CUDA kernel's wrapper --------------------------------------------

class _MipTable(ctypes.Structure):
    """Edge size of each mip, passed to the kernel by value."""
    _fields_ = [("size", ctypes.c_int * MAX_MIPS)]


def paged_sample(pages: torch.Tensor, meta: torch.Tensor, n_mips: int,
                 mip_sizes: Sequence[int], layers: torch.Tensor,
                 uv: torch.Tensor, mip: torch.Tensor,
                 bilinear: bool = True, block_h: int = 16,
                 k_pages: int = 16, with_coverage: bool = False):
    """Kernel K5: (C,H,W) i32 layers (-1 = untextured) + (H,W,2) f32 uv +
    (H,W) i32 mip -> (C,H,W) i32 packed RGBA8 texels from the paged pool
    (raw or block-compressed, told apart by meta's row count), served
    through a k_pages palette per (block_h,128) block as
    paged_sample_plain says; with_coverage also (C,H,W) bool. The kernel
    takes block_h 16, C in [1, 4] and k_pages in [1, 16]. CPU tensors ->
    paged_sample_plain."""
    if not layers.is_cuda:
        return paged_sample_plain(pages, meta, n_mips, mip_sizes, layers,
                                  uv, mip, bilinear, block_h, k_pages,
                                  with_coverage)
    c, h, w = layers.shape
    if meta.dim() != 2 or meta.shape[0] not in (2, 3):
        raise ValueError(f"meta must be (2|3, E) (got {tuple(meta.shape)})")
    compressed = meta.shape[0] == 3
    rows = 2 if compressed else 8
    if pages.dim() != 2 or pages.shape[1] != 128 or pages.shape[0] % rows:
        raise ValueError(f"pages must be (N*{rows}, 128) "
                         f"(got {tuple(pages.shape)})")
    if not 1 <= n_mips <= min(MAX_MIPS, len(mip_sizes)):
        raise ValueError(f"n_mips={n_mips} must lie in [1, "
                         f"{min(MAX_MIPS, len(mip_sizes))}]")
    if block_h != 16 or not 1 <= c <= 4 or not 1 <= k_pages <= 16:
        raise ValueError(f"the kernel takes block_h 16, C in [1, 4] and "
                         f"k_pages in [1, 16] (got {block_h}, {c}, "
                         f"{k_pages})")
    fb_idx = fallback_mip(mip_sizes, n_mips)
    if fb_idx >= MAX_MIPS or int(mip_sizes[fb_idx]) > TILE:
        raise ValueError(f"the fallback mip ({mip_sizes[fb_idx]}) must fit "
                         "one page")
    _cuda.check(pages, "pages", torch.int32)
    _cuda.check(meta, "meta", torch.int32)
    _cuda.check(layers, "layers", torch.int32, (c, h, w))
    _cuda.check(uv, "uv", torch.float32, (h, w, 2))
    _cuda.check(mip, "mip", torch.int32, (h, w))
    table = _MipTable()
    for i, size in enumerate(mip_sizes[:MAX_MIPS]):
        table.size[i] = int(size)
    out = torch.empty((c, h, w), dtype=torch.int32, device=layers.device)
    cov = torch.empty_like(out) if with_coverage else None
    _cuda.launch("chord_paged_sample", _cuda.ptr(pages),
                 _cuda.cint(pages.shape[0] // rows), _cuda.ptr(meta),
                 _cuda.cint(meta.shape[1]), _cuda.ptr(layers), _cuda.cint(c),
                 _cuda.ptr(uv), _cuda.ptr(mip), _cuda.cint(h), _cuda.cint(w),
                 table, _cuda.cint(n_mips), _cuda.cint(fb_idx),
                 _cuda.cint(k_pages), _cuda.cint(int(bilinear)),
                 _cuda.cint(int(compressed)), _cuda.ptr(out), _cuda.ptr(cov),
                 _cuda.stream())
    paged_sample.launches += 1
    if with_coverage:
        return out, cov > 0
    return out


paged_sample.launches = 0


def unpack_rgba(packed: torch.Tensor) -> torch.Tensor:
    """(C,H,W) packed RGBA8 -> (C,H,W,4) f32 in [0,1]."""
    return torch.stack(_channels(packed), dim=-1) * (1.0 / 255.0)
