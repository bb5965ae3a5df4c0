"""Palette paged sampler of the paged-texture prototype (kernel K10).

Pool layout: every (layer, mip) image is cut into 32x32-texel tiles of
packed RGBA, 1024 int32 per tile (slot = (y%32)*32 + x%32), stored as an
(n_tiles*8, 128) int32 array. Per (32,128) pixel block the sampler serves
only the K=6 smallest distinct tiles the block needs; pixels beyond them
get the entry's average colour, and the `cov` output says which pixels
were served.

    paged_sample   CUDA kernel csrc/proto_paged_tex.cu (CUDA tensors) or
                   paged_sample_plain (CPU tensors)
    palette        the kernel's two-level palette rule, for the tests

Replaces tools/proto_paged_tex.py::paged_sample_kernel (:70). The palette
is kept (unlike kernel K5's port): the prototype measures what it covers.
The tool around it is chord_tpu_torch/tools/proto_paged_tex.py.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _cuda
from ._util import f2i

TILE = 32           # texel tile edge
K = 6               # distinct tiles per pixel block
BH = 32             # pixel rows per block: distinct-tile scope
BW = 128            # pixel columns per block
BIG = 1 << 30       # tile id of an untextured pixel
WARPS = 16          # warps of a kernel block: warp w takes block rows w and
                    # w + 16 (csrc/proto_paged_tex.cu)


def _check_shapes(pool, meta, u, v, lm) -> None:
    """The shapes and dtypes both versions take (ValueError otherwise)."""
    if u.dim() != 2 or u.shape[0] % BH or u.shape[1] % BW:
        raise ValueError(f"u must be (H, W) with H % {BH} == 0 and W % {BW} "
                         f"== 0 (got {tuple(u.shape)})")
    for name, t, dtype in (("u", u, torch.float32), ("v", v, torch.float32),
                           ("lm", lm, torch.int32)):
        if t.dtype != dtype or t.shape != u.shape:
            raise ValueError(f"{name} must be {dtype} of shape "
                             f"{tuple(u.shape)} (got {t.dtype} "
                             f"{tuple(t.shape)})")
    if (pool.dtype != torch.int32 or pool.dim() != 2 or pool.shape[1] != 128
            or pool.shape[0] % 8 or pool.shape[0] == 0):
        raise ValueError(f"pool must be (n_tiles*8, 128) int32 with n_tiles "
                         f">= 1 (got {pool.dtype} {tuple(pool.shape)})")
    if meta.dtype != torch.int32 or tuple(meta.shape) != (4, 128):
        raise ValueError(f"meta must be (4, 128) int32 (got {meta.dtype} "
                         f"{tuple(meta.shape)})")


def _blocks(x: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (H/BH * W/BW, BH*BW), one row per pixel block."""
    h, w = x.shape
    return (x.reshape(h // BH, BH, w // BW, BW).permute(0, 2, 1, 3)
            .reshape(-1, BH * BW))


def _unblocks(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return (x.reshape(h // BH, w // BW, BH, BW).permute(0, 2, 1, 3)
            .reshape(h, w))


def tile_slot(meta: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
              lm: torch.Tensor):
    """Each pixel's tile id (BIG where lm < 0), slot in the tile and the
    entry's average colour -> three (H, W) int32 tensors."""
    lmc = torch.clamp(lm, 0, 127).long()
    base, tiles_x, size, avg = (meta[i][lmc] for i in range(4))
    sf = size.to(torch.float32)

    def texel_coord(x):
        t = f2i(torch.remainder(x, 1.0) * sf)
        return torch.minimum(torch.clamp_min(t, 0), size - 1)

    xt, yt = texel_coord(u), texel_coord(v)
    tile = base + torch.div(yt, TILE, rounding_mode="floor") * tiles_x + \
        torch.div(xt, TILE, rounding_mode="floor")
    slot = torch.remainder(yt, TILE) * TILE + torch.remainder(xt, TILE)
    return torch.where(lm < 0, BIG, tile), slot, avg


def smallest_distinct(ids: torch.Tensor, k: int = K) -> torch.Tensor:
    """(n, m) int -> (n, k): the k smallest distinct ids of each row, ids
    at or above BIG taken as BIG, padded with BIG (k rounds of a min, each
    taking the round's id out, as a warp of the kernel does)."""
    rem = torch.clamp_max(ids, BIG)
    out = []
    for _ in range(k):
        cur = rem.amin(1, keepdim=True)
        out.append(cur)
        rem = torch.where(rem == cur, BIG, rem)
    return torch.cat(out, 1)


def palette(tile: torch.Tensor) -> torch.Tensor:
    """The kernel's palette of (H, W) tile ids -> (blocks, K), blocks in
    row-major order of the (BH, BW) pixel blocks: each warp's K smallest
    distinct ids (rows w and w + WARPS of the block), then the K smallest
    distinct of the WARPS lists. The K smallest distinct ids of a union
    are among the union of each part's, so the ids below BIG are those the
    plain version's K rounds over the whole block serve."""
    h, w = tile.shape
    per_warp = (tile.reshape(h // BH, BH // WARPS, WARPS, w // BW, BW)
                .permute(0, 3, 2, 1, 4).reshape(-1, BH // WARPS * BW))
    cand = smallest_distinct(per_warp).reshape(-1, WARPS * K)
    return smallest_distinct(cand)


def paged_sample_plain(pool: torch.Tensor, meta: torch.Tensor,
                       u: torch.Tensor, v: torch.Tensor, lm: torch.Tensor,
                       texel_index: Optional[list] = None):
    """Plain version of kernel K10 -> (out, cov), (H, W) int32 each: the
    packed texel where the block's palette holds the pixel's tile, else
    the entry's average colour, -1 where lm < 0; cov 1 where served or
    lm < 0. Pages are read at clamp(id, 0, n_tiles-1). `texel_index`,
    when given, receives the flat pool index of every served pixel's texel
    (what the sampler must read)."""
    _check_shapes(pool, meta, u, v, lm)
    h, w = u.shape
    n_tiles = pool.shape[0] // 8
    tile, slot, avg = tile_slot(meta, u, v, lm)

    tile_b, slot_b = _blocks(tile), _blocks(slot).long()
    remaining = tile_b
    pages = pool.reshape(n_tiles, TILE * TILE)
    out = torch.zeros_like(tile_b)
    covered = torch.zeros_like(tile_b, dtype=torch.bool)
    for _ in range(K):
        cur = remaining.amin(1, keepdim=True)              # (blocks, 1)
        page = pages[torch.clamp(cur[:, 0], 0, n_tiles - 1).long()]
        hit = tile_b == cur
        out = torch.where(hit, torch.gather(page, 1, slot_b), out)
        covered = covered | hit
        remaining = torch.where(hit, BIG, remaining)
    covered = _unblocks(covered & (tile_b < BIG), h, w)
    if texel_index is not None:
        page = torch.clamp(tile, 0, n_tiles - 1).long()
        texel_index.append((page * (TILE * TILE) + slot)[covered])
    out = torch.where(covered, _unblocks(out, h, w), avg)
    out = torch.where(lm < 0, -1, out)
    return out, (covered | (lm < 0)).to(torch.int32)


def paged_sample(pool: torch.Tensor, meta: torch.Tensor, u: torch.Tensor,
                 v: torch.Tensor, lm: torch.Tensor):
    """Kernel K10: pool (n_tiles*8, 128) i32, meta (4, 128) i32, u, v
    (H, W) f32, lm (H, W) i32 entry index (-1: untextured), H % 32 == 0,
    W % 128 == 0 -> (out, cov) (H, W) i32. CPU tensors ->
    paged_sample_plain."""
    if not u.is_cuda:
        return paged_sample_plain(pool, meta, u, v, lm)
    _check_shapes(pool, meta, u, v, lm)
    h, w = u.shape
    _cuda.check(pool, "pool", torch.int32)
    _cuda.check(meta, "meta", torch.int32, (4, 128))
    _cuda.check(u, "u", torch.float32, (h, w))
    _cuda.check(v, "v", torch.float32, (h, w))
    _cuda.check(lm, "lm", torch.int32, (h, w))
    out = torch.empty((h, w), dtype=torch.int32, device=u.device)
    cov = torch.empty_like(out)
    p = _cuda.ptr
    _cuda.launch("chord_proto_paged_sample", p(pool),
                 _cuda.cint(pool.shape[0] // 8), p(meta), p(u), p(v), p(lm),
                 _cuda.cint(h), _cuda.cint(w), p(out), p(cov),
                 _cuda.stream())
    paged_sample.launches += 1
    return out, cov


paged_sample.launches = 0
