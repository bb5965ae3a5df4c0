"""Tiled software visibility-buffer rasterizer (port of
chord_tpu/ops/raster.py: RasterConfig, TriangleSetup, `_sub_bounds`,
`bin_windows` and `raster_queue`).

Triangles come grouped in WINDOWS of 128 (one meshlet draw); the
mesh-shader kernel (ops/mesh_shader.py) writes each window's
homogeneous (Olano-Greer) edge, depth and attribute planes. `bin_windows`
turns windows into a work queue of (tile, window) pairs sorted by screen
tile; `raster_queue` rasterizes it with kernel K1:

    raster_tiles  CUDA kernel csrc/raster.cu (CUDA tensors) or
                  raster_tiles_plain (CPU tensors)

Replaces chord_tpu/ops/raster.py::_raster_tile_kernel (:488, with
_raster_subwindow_body :632). Per screen tile the kernel walks the tile's
pairs; per window it walks S subwindows of 128/S triangles, each within
its own row bounds (rounded out to `rp`-row groups exactly as the Pallas
row packing does). Per pixel a group's result is its max depth, the max
payload among the triangles at that depth (signed int32 compare) and the
elementwise max of their attributes; it replaces the accumulator when its
depth is greater, or equal with a larger payload. The result is the
lexicographic max over (depth, payload) per pixel and does not depend on
pair order — which is what lets the plain version vectorise over pairs.

Reverse-Z: larger depth wins. Visibility is (slot+1):25 | tri:7, carried
as int32 bit patterns.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from . import _cuda
from ._util import bits_f32

WINDOW = 128   # triangles per window == meshlet max tris
COEF_ROWS = 32  # coefficient lanes per triangle (see ops/mesh_shader.py)
NEG = -3e38     # attribute fill of a group without a winner


class RasterConfig(NamedTuple):
    """Static raster parameters (chord_tpu RasterConfig, same fields)."""

    width: int
    height: int
    tile_h: int = 120
    tile_w: int = 128
    pair_capacity: int = 8192
    small_ky: int = 4
    small_kx: int = 2
    big_capacity: int = 256
    subtiles: bool = False   # chord_tpu sub-tile lane packing: not ported
    bricks: bool = False     # chord_tpu brick layout: not ported
    with_attrs: bool = False
    sub_s: int = 4
    z_clip: bool = False
    rp: int = 0              # rows per row group (0 = sub_s)

    @property
    def coef_rows(self) -> int:
        return 32 if self.with_attrs else 16

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile_w)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile_h)

    @property
    def n_tiles(self) -> int:
        return self.tiles_x * self.tiles_y


@dataclass
class TriangleSetup:
    """Per-window raster state (see ops/mesh_shader.py for the lanes).

    coefT is triangle-major ((D+1)*128, 32) int32 bit patterns; window D
    is the poison window that slack queue entries point at."""

    coefT: torch.Tensor          # ((D+1)*128, 32) i32
    window_bbox: torch.Tensor    # (4, D) i32 [x0,y0,x1,y1] inclusive
    window_valid: torch.Tensor   # (D,) bool
    valid: torch.Tensor          # (D*128,) bool per triangle
    sub_bounds: Optional[torch.Tensor] = None   # (4, (D+1)*S) i32

    @property
    def num_windows(self) -> int:
        return self.window_valid.shape[0]


def _sub_bounds(iy0, iy1, ix0, ix1, d: int, s: int) -> torch.Tensor:
    """Per-subwindow [y0,y1,x0,x1] over groups of 128/s consecutive
    triangles (+ s poison entries for the slack window): (4, (d+1)*s)."""
    cs = WINDOW // s
    dev = iy0.device
    red = lambda v, op: getattr(v.reshape(d, s, cs), op)(dim=2).reshape(-1)
    pois_lo = torch.full((s,), 1 << 29, dtype=torch.int32, device=dev)
    pois_hi = torch.full((s,), -1, dtype=torch.int32, device=dev)
    return torch.stack([
        torch.cat([red(iy0, "amin").to(torch.int32), pois_lo]),
        torch.cat([red(iy1, "amax").to(torch.int32), pois_hi]),
        torch.cat([red(ix0, "amin").to(torch.int32), pois_lo]),
        torch.cat([red(ix1, "amax").to(torch.int32), pois_hi])], dim=0)


class WorkQueue(NamedTuple):
    """Tile-grouped window lists: sorted pair array + per-tile segments."""

    pair_win: torch.Tensor    # (P,) i32 window ids sorted by tile; slack -> D
    starts: torch.Tensor      # (n_tiles,) i32
    counts: torch.Tensor      # (n_tiles,) i32
    n_pairs: torch.Tensor     # () i32
    overflow: torch.Tensor    # () i32 dropped pairs


def bin_windows(setup: TriangleSetup, config: RasterConfig,
                tile_keep: Optional[torch.Tensor] = None) -> WorkQueue:
    """Windows -> (tile, window) work queue sorted by tile. Small windows
    expand to small_ky x small_kx candidate tiles, tile-spanning windows
    take the bounded big path; every dropped pair is counted in
    `overflow`. `tile_keep` ((n_tiles,) bool) drops the pairs of masked
    tiles. Keys sort stably (chord_tpu's key-value sort leaves the order of
    equal keys to the backend; the raster result does not depend on it)."""
    c = config
    d = setup.num_windows
    dev = setup.coefT.device
    i32 = dict(dtype=torch.int32, device=dev)
    bx0, by0, bx1, by1 = (setup.window_bbox[i] for i in range(4))
    tx0 = bx0 // c.tile_w
    ty0 = by0 // c.tile_h
    tx1 = bx1 // c.tile_w
    ty1 = by1 // c.tile_h
    span_x = tx1 - tx0 + 1
    span_y = ty1 - ty0 + 1
    ok = setup.window_valid & (bx1 >= bx0)
    small = ok & (span_x <= c.small_kx) & (span_y <= c.small_ky)
    big = ok & ~small
    invalid = torch.tensor(c.n_tiles, **i32)

    win_ids = torch.arange(d, **i32)
    keys_l, vals_l = [], []
    for ky in range(c.small_ky):
        for kx in range(c.small_kx):
            tyk = ty0 + ky
            txk = tx0 + kx
            hit = small & (tyk <= ty1) & (txk <= tx1)
            keys_l.append(torch.where(hit, tyk * c.tiles_x + txk, invalid))
            vals_l.append(win_ids)

    # big path: compact big windows (stable) to a fixed list, expand
    # against every tile; windows past big_capacity count as overflow
    big_i = big.to(torch.int32)
    n_big = big_i.sum().to(torch.int32)
    order = torch.sort(1 - big_i, stable=True).indices
    nt_sorted = torch.where(big, span_x * span_y, 0).to(torch.int32)[order]
    big_overflow = (nt_sorted.sum() - nt_sorted[:c.big_capacity].sum()
                    ).to(torch.int32)
    big_sorted = win_ids[order]
    if big_sorted.shape[0] < c.big_capacity:
        big_sorted = torch.cat([big_sorted, torch.zeros(
            c.big_capacity - big_sorted.shape[0], **i32)])
    have = torch.arange(c.big_capacity, **i32) < torch.clamp(
        n_big, max=c.big_capacity)
    zero = torch.zeros((), **i32)
    bl = torch.where(have, big_sorted[:c.big_capacity], zero)
    blong = bl.long()
    btx0 = torch.where(have, tx0[blong], c.tiles_x + 1)
    bty0 = torch.where(have, ty0[blong], c.tiles_y + 1)
    btx1 = torch.where(have, tx1[blong], -1)
    bty1 = torch.where(have, ty1[blong], -1)
    tile_ix = torch.arange(c.n_tiles, **i32)[None, :].expand(
        c.big_capacity, c.n_tiles)
    ttx = tile_ix % c.tiles_x
    tty = tile_ix // c.tiles_x
    overlap = ((ttx >= btx0[:, None]) & (ttx <= btx1[:, None]) &
               (tty >= bty0[:, None]) & (tty <= bty1[:, None]))
    keys_l.append(torch.where(overlap, tile_ix, invalid).reshape(-1))
    vals_l.append(bl[:, None].expand(c.big_capacity, c.n_tiles).reshape(-1))

    keys = torch.cat(keys_l)
    vals = torch.cat(vals_l)
    if tile_keep is not None:
        keep = tile_keep[torch.clamp(keys, max=c.n_tiles - 1).long()]
        keys = torch.where(keep, keys, invalid)
    keys_s, order = torch.sort(keys, stable=True)
    vals_s = vals[order]

    total = (keys_s < c.n_tiles).to(torch.int32).sum().to(torch.int32)
    cap = c.pair_capacity
    if keys_s.shape[0] < cap:
        pad = cap - keys_s.shape[0]
        keys_s = torch.cat([keys_s, torch.full((pad,), c.n_tiles, **i32)])
        vals_s = torch.cat([vals_s, torch.full((pad,), d, **i32)])
    n_pairs = torch.clamp(total, max=cap)
    overflow = torch.clamp_min(total - cap, 0) + big_overflow

    pk = keys_s[:cap].contiguous()
    pv = vals_s[:cap]
    live = torch.arange(cap, **i32) < n_pairs
    pair_win = torch.where(live, pv, torch.tensor(d, **i32))
    tile_ids = torch.arange(c.n_tiles, **i32)
    starts = torch.clamp(torch.searchsorted(pk, tile_ids, out_int32=True),
                         max=cap)
    ends = torch.minimum(torch.searchsorted(pk, tile_ids, right=True,
                                            out_int32=True), n_pairs)
    counts = torch.clamp_min(ends - starts, 0)
    return WorkQueue(pair_win=pair_win, starts=starts, counts=counts,
                     n_pairs=n_pairs, overflow=overflow)


def _check_config(c: RasterConfig) -> None:
    if c.subtiles:
        raise NotImplementedError("RasterConfig.subtiles: the sub-tile "
                                  "raster (K8) is not ported")
    if c.bricks:
        raise NotImplementedError("RasterConfig.bricks: the brick-layout "
                                  "raster (K7) is not ported")
    if c.tile_w != WINDOW:
        raise ValueError(f"tile_w={c.tile_w}: the raster kernel needs 128")
    if c.tile_h % 8 != 0 or c.tile_h % c.sub_s != 0:
        raise ValueError(f"tile_h={c.tile_h} must be a multiple of 8 and "
                         f"of sub_s={c.sub_s} (set via r.raster.tileH)")
    if c.rp and (c.tile_h % c.rp != 0 or c.rp % 8 != 0):
        raise ValueError(f"rp={c.rp} must divide tile_h={c.tile_h} and be a "
                         f"multiple of 8 (set via r.raster.rp)")


def raster_queue(queue: WorkQueue, setup: TriangleSetup, config: RasterConfig,
                 seeds: Optional[Sequence[torch.Tensor]] = None,
                 zclip: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """Rasterize the work queue -> render targets cropped to (H,W):
    (depth f32 reverse-Z, vis i32 bits[, nx, ny, nz, u, v f32]).

    `seeds` (same layout) carries an earlier phase's targets through a
    re-raster (two-phase occlusion); `zclip` (needs config.z_clip) is an
    (H,W) reverse-Z plane: fragments at or nearer than it are rejected."""
    c = config
    _check_config(c)
    h_pad = c.tiles_y * c.tile_h
    w_pad = c.tiles_x * c.tile_w
    n_rt = 2 + (5 if c.with_attrs else 0)
    dev = setup.coefT.device

    def padded(x, dtype, fill=0.0):
        if x is None:
            return torch.full((h_pad, w_pad), fill, dtype=dtype, device=dev)
        out = torch.full((h_pad, w_pad), fill, dtype=dtype, device=dev)
        out[:x.shape[0], :x.shape[1]] = x.to(dtype)
        return out

    seeds = list(seeds or []) + [None] * n_rt
    seed_planes = [padded(seeds[0], torch.float32),
                   padded(seeds[1], torch.int32, 0)]
    seed_planes += [padded(seeds[2 + k], torch.float32)
                    for k in range(n_rt - 2)]
    zq = None
    if c.z_clip:
        # default +3e38 = clip nothing (every fragment is nearer)
        zq = padded(zclip, torch.float32, 3e38)
    if (setup.sub_bounds is not None and
            setup.sub_bounds.shape[1] == (setup.num_windows + 1) * c.sub_s):
        sb = setup.sub_bounds
    else:   # whole-window bounds replicated per subwindow
        rep = lambda v, pois: torch.cat(
            [torch.repeat_interleave(v, c.sub_s),
             torch.full((c.sub_s,), pois, dtype=torch.int32, device=dev)])
        wb = setup.window_bbox
        sb = torch.stack([rep(wb[1], 1), rep(wb[3], -1),
                          rep(wb[0], 1), rep(wb[2], -1)], 0)
    outs = raster_tiles(queue.pair_win, queue.starts, queue.counts,
                        sb.contiguous(), setup.coefT, seed_planes, zq, c)
    return tuple(o[:c.height, :c.width] for o in outs)


# --- K1: the plain version --------------------------------------------------

def _groups(pair_win, starts, counts, sb, c: RasterConfig):
    """Enumerate the (pair, subwindow) groups the kernel visits and their
    row ranges (rounded out to rp-row groups) -> per-group tensors."""
    dev = pair_win.device
    s_cnt = c.sub_s
    rp = c.rp or s_cnt
    n_tiles = counts.shape[0]
    cnt = counts.long()
    tile_of = torch.repeat_interleave(torch.arange(n_tiles, device=dev), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    j = torch.arange(tile_of.numel(), device=dev) - first[tile_of]
    win = pair_win.long()[starts.long()[tile_of] + j]
    g_tile = torch.repeat_interleave(tile_of, s_cnt)
    g_win = torch.repeat_interleave(win, s_cnt)
    g_s = torch.arange(s_cnt, device=dev).repeat(win.numel())
    base = g_win * s_cnt + g_s
    py0 = (g_tile // c.tiles_x) * c.tile_h
    px0 = (g_tile % c.tiles_x) * c.tile_w
    y0 = torch.clamp(sb[0].long()[base] - py0, 0, c.tile_h)
    y1 = torch.clamp(sb[1].long()[base] + 1 - py0, 0, c.tile_h)
    xok = (sb[3].long()[base] >= px0) & (sb[2].long()[base] < px0 + c.tile_w)
    y1 = torch.where(xok, y1, torch.zeros_like(y1))
    keep = y1 > y0
    y0, y1 = y0[keep], y1[keep]
    r0 = (y0 // rp) * rp
    r1 = ((y1 + rp - 1) // rp) * rp
    return (g_win[keep], g_s[keep], py0[keep], px0[keep], r0, r1 - r0)


def raster_tiles_plain(pair_win, starts, counts, sub_bounds, coefT,
                       seeds: List[torch.Tensor], zclip, c: RasterConfig,
                       chunk: int = 8192) -> List[torch.Tensor]:
    """Plain PyTorch version of kernel K1 (same inputs and outputs as
    `raster_tiles`; outputs are the padded (h_pad, w_pad) planes)."""
    dev = coefT.device
    n_attr = 5 if c.with_attrs else 0
    s_cnt = c.sub_s
    cs = WINDOW // s_cnt
    h_pad, w_pad = seeds[0].shape
    g_win, g_s, py0, px0, r0, nrows = _groups(pair_win, starts, counts,
                                              sub_bounds, c)
    n_items = int(nrows.sum())
    it_g = torch.repeat_interleave(torch.arange(g_win.numel(), device=dev),
                                   nrows)
    it_row = (r0[it_g] + torch.arange(n_items, device=dev) -
              (torch.cumsum(nrows, 0) - nrows)[it_g])
    lane = torch.arange(c.tile_w, device=dev)
    tri = torch.arange(cs, device=dev)

    acc_key = ((seeds[0].contiguous().view(torch.int32).long() << 32) |
               (seeds[1].long() + 2 ** 31)).reshape(-1)
    acc = [p.reshape(-1).clone() for p in seeds]
    for lo in range(0, n_items, chunk):
        g = it_g[lo:lo + chunk]
        row_abs = py0[g] + it_row[lo:lo + chunk]             # (I,)
        rows = ((g_win[g] * WINDOW + g_s[g] * cs)[:, None] + tri[None, :])
        co = coefT[rows]                                     # (I,cs,32) i32
        cf = bits_f32(co)
        px = (px0[g][:, None] + lane[None, :]).to(torch.float32)[:, None, :]
        yf = row_abs.to(torch.float32)[:, None, None]
        col = lambda k: cf[:, :, k:k + 1]
        pl = [col(k) * px + (col(5 + k) * yf + col(10 + k)) for k in range(5)]
        l0, l1, l2, zn, zd = pl
        covered = ((l0 >= 0.0) & (l1 >= 0.0) & (l2 >= 0.0) & (zd > 0.0) &
                   (zn > 0.0) & (zn <= zd))
        one = torch.ones((), device=dev)
        cand = torch.where(covered, zn / torch.where(covered, zd, one),
                           torch.zeros((), device=dev))
        pix = row_abs[:, None] * w_pad + px0[g][:, None] + lane[None, :]
        if zclip is not None:
            zc = zclip.reshape(-1)[pix][:, None, :]
            cand = torch.where(cand < zc, cand, torch.zeros((), device=dev))
        best = cand.amax(dim=1)                              # (I,TW)
        winner = (cand == best[:, None, :]) & (cand > 0.0)
        pay = co[:, :, 15:16]
        pay_sel = torch.where(winner, pay, torch.zeros((), dtype=torch.int32,
                                                       device=dev)).amax(dim=1)
        sels = []
        if n_attr:
            inv_s = 1.0 / torch.where(covered, l0 + l1 + l2, one)
            for k in range(n_attr):
                val = (col(16 + 3 * k) * px +
                       (col(17 + 3 * k) * yf + col(18 + 3 * k))) * inv_s
                sels.append(torch.where(winner, val, torch.full(
                    (), NEG, device=dev)).amax(dim=1))
        key = ((best.contiguous().view(torch.int32).long() << 32) |
               (pay_sel.long() + 2 ** 31))
        # lexicographic max within the chunk, then against the accumulator
        # (strictly greater replaces: the accumulator wins ties, as the
        # kernel's in-order merge does)
        pix = pix.reshape(-1)
        key = key.reshape(-1)
        cmax = torch.full_like(acc_key, torch.iinfo(torch.int64).min)
        cmax.scatter_reduce_(0, pix, key, "amax", include_self=True)
        take = (key == cmax[pix]) & (key > acc_key[pix])
        tp = pix[take]
        acc_key[tp] = key[take]
        acc[0][tp] = best.reshape(-1)[take]
        acc[1][tp] = pay_sel.reshape(-1)[take]
        for k in range(n_attr):
            acc[2 + k][tp] = sels[k].reshape(-1)[take]
    return [a.reshape(h_pad, w_pad) for a in acc]


# --- K1: the wrapper -------------------------------------------------------

def raster_tiles(pair_win, starts, counts, sub_bounds, coefT,
                 seeds: List[torch.Tensor], zclip, c: RasterConfig
                 ) -> List[torch.Tensor]:
    """Kernel K1: rasterize the work queue into padded render targets.
    CPU tensors -> raster_tiles_plain; CUDA tensors -> csrc/raster.cu."""
    if not coefT.is_cuda:
        return raster_tiles_plain(pair_win, starts, counts, sub_bounds,
                                  coefT, seeds, zclip, c)
    _check_config(c)
    n_attr = 5 if c.with_attrs else 0
    h_pad, w_pad = c.tiles_y * c.tile_h, c.tiles_x * c.tile_w
    n_tiles = c.n_tiles
    d1 = coefT.shape[0] // WINDOW
    chk = _cuda.check
    chk(pair_win, "pair_win", torch.int32)
    chk(starts, "starts", torch.int32, (n_tiles,))
    chk(counts, "counts", torch.int32, (n_tiles,))
    chk(sub_bounds, "sub_bounds", torch.int32, (4, d1 * c.sub_s))
    chk(coefT, "coefT", torch.int32, (d1 * WINDOW, COEF_ROWS))
    chk(seeds[0], "seed depth", torch.float32, (h_pad, w_pad))
    chk(seeds[1], "seed vis", torch.int32, (h_pad, w_pad))
    dev = coefT.device
    seed_attr = (torch.stack(seeds[2:2 + n_attr]).contiguous()
                 if n_attr else None)
    if zclip is not None:
        chk(zclip, "zclip", torch.float32, (h_pad, w_pad))
    depth = torch.empty((h_pad, w_pad), dtype=torch.float32, device=dev)
    vis = torch.empty((h_pad, w_pad), dtype=torch.int32, device=dev)
    attr = (torch.empty((n_attr, h_pad, w_pad), dtype=torch.float32,
                        device=dev) if n_attr else None)
    ci = _cuda.cint
    p = _cuda.ptr
    _cuda.launch("chord_raster_tiles",
                 p(pair_win), p(starts), p(counts), p(sub_bounds),
                 ci(sub_bounds.shape[1]), p(coefT),
                 p(seeds[0]), p(seeds[1]), p(seed_attr), p(zclip),
                 p(depth), p(vis), p(attr),
                 ci(n_tiles), ci(c.tiles_x), ci(c.tile_h), ci(w_pad),
                 ci(c.sub_s), ci(c.rp or c.sub_s), ci(n_attr),
                 _cuda.stream())
    raster_tiles.launches += 1
    return [depth, vis] + ([attr[k] for k in range(n_attr)] if n_attr
                           else [])


raster_tiles.launches = 0
