"""Tiled software visibility-buffer rasterizer (port of
chord_tpu/ops/raster.py: RasterConfig, TriangleSetup, `setup_triangles`,
`_sub_bounds`, `bin_windows`, `raster_queue`, `rasterize`, `SubtileQueue`,
`bin_windows_subtile` and `raster_queue_subtile`).

Triangles come grouped in WINDOWS of 128 (one meshlet draw, or 128
consecutive triangles of the flat pools). The mesh-shader kernel
(ops/mesh_shader.py) or `setup_triangles` writes each window's
homogeneous (Olano-Greer) edge, depth and attribute planes. `bin_windows`
turns windows into a work queue of (tile, window) pairs sorted by screen
tile; `raster_queue` rasterizes it with kernel K1, or K7 in brick mode;
`bin_windows_subtile` groups 32-px sub-tile pairs into rounds of four
windows per tile, which `raster_queue_subtile` rasterizes with K8:

    raster_tiles    K1  csrc/raster.cu          raster_tiles_plain
    raster_bricks   K7  csrc/raster_bricks.cu   raster_bricks_plain
    raster_subtile  K8  csrc/raster_subtile.cu  raster_subtile_plain

Each wrapper launches its CUDA kernel on CUDA tensors and runs its plain
PyTorch version on CPU tensors.

K1 replaces chord_tpu/ops/raster.py::_raster_tile_kernel (:488, with
_raster_subwindow_body :632). Per screen tile the kernel walks the tile's
pairs; per window it walks S subwindows of 128/S triangles, each within
its own row bounds (rounded out to `rp`-row groups exactly as the Pallas
row packing does). Per pixel a group's result is its max depth, the max
payload among the triangles at that depth (signed int32 compare) and the
elementwise max of their attributes; it replaces the accumulator when its
depth is greater, or equal with a larger payload. The result is the
lexicographic max over (depth, payload) per pixel and does not depend on
pair order — which is what lets the plain versions vectorise over pairs.

K7 (`_raster_tile_kernel_bricks` :740) visits, per subwindow, only the
32-px x-bricks its x range overlaps, in row groups of 4*S, and evaluates
the planes in its own association (see `_eval_items`): a pixel on an edge
to within an ulp may differ from K1. K8 (`_raster_tile_kernel_st` :1233)
evaluates each round's four windows, one per 32-px sub-tile, over all 128
triangles per pixel group, on the rows of the round's union y range. The
TPU layouts (brick-packed planes, lane-grouped coefficient columns) are
not reproduced: every plane is linear (h_pad, w_pad).

K1, K7 and K8 split a tile among blocks of 32 columns x a band of
K1_BAND / K7_BAND / K8_BAND rows (K7's block holds one brick and lists
only its visits); a block walks, in queue order, the visits whose rows
meet its band (`band_split`), so every pixel sees the plain versions'
visits in their order.

Reverse-Z: larger depth wins. Visibility is (slot+1):25 | tri:7 on the
meshlet frame and triangle+1 on the flat frame, carried as int32 bit
patterns.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from . import _cuda
from ._util import bits_f32, bits_i32, f2i

WINDOW = 128   # triangles per window == meshlet max tris
COEF_ROWS = 32  # coefficient lanes per triangle (see ops/mesh_shader.py)
NEG = -3e38     # attribute fill of a group without a winner
BRICK_W = 32    # K7's x-brick width (px)
BRICK_H = 4     # K7's brick height (rows per brick row)
SUB_TILES = 4   # K8's 32-px sub-tiles per 128-px tile
K1_BAND = 2     # rows of a K1 block (csrc/raster.cu kRows)
K7_BAND = 8     # rows of a K7 block (csrc/raster_bricks.cu kBand)
K8_BAND = 8     # rows of a K8 block (csrc/raster_subtile.cu kBand)
WARP_ROWS = 2   # rows a K1 / K7 / K8 thread holds and its warp culls on
CULL_MAX = 1e29  # coefficients the cull trusts (csrc/raster_core.cuh)
EPS_W = 1e-6    # a vertex with w at or below this is behind the eye


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
    subtiles: bool = False   # rasterize(): sub-tile rounds (K8)
    bricks: bool = False     # raster_queue(): x-brick row loop (K7)
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

    coefT is triangle-major ((D+1)*128, 32) int32 bit patterns, with and
    without attributes (lanes 16-31 are zero without them); window D is
    the poison window that slack queue entries point at."""

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


# --- flat triangle setup -----------------------------------------------------

def _poison_row(dev) -> torch.Tensor:
    """An invalid triangle's lanes: coverage poisoned (λ c = -1, a = b = 0,
    so every λ < 0), payload 0."""
    row = torch.zeros(COEF_ROWS, dtype=torch.float32, device=dev)
    row[10:13] = -1.0
    return bits_i32(row)


def setup_triangles(clip: torch.Tensor, indices: torch.Tensor,
                    tri_valid: torch.Tensor, payload: torch.Tensor,
                    config: RasterConfig, backface_cull: bool = True,
                    attrs: Optional[torch.Tensor] = None) -> TriangleSetup:
    """Clip positions (V,4) of triangles (T,3) (T a multiple of 128) ->
    homogeneous coverage / depth planes (chord_tpu raster.py:185-352), in
    chord_tpu's order of operations. No near clipping: triangles crossing
    the eye plane get the full-screen bbox and rasterize through the
    cofactor form. `attrs` (V,5) = (nx, ny, nz, u, v) fills the attribute
    planes (with config.with_attrs); `payload` (T,) int32 bits."""
    w, h = config.width, config.height
    fw, fh = float(w), float(h)
    t = indices.shape[0]
    if t % WINDOW:
        raise ValueError(f"triangle count {t} is not a multiple of {WINDOW}")
    d = t // WINDOW
    dev = clip.device
    idx = indices.long()

    def vertex(k):
        v = clip[idx[:, k]]
        X = (v[:, 0] * 0.5 + v[:, 3] * 0.5) * fw
        Y = (v[:, 3] * 0.5 - v[:, 1] * 0.5) * fh     # y down
        ww, z = v[:, 3], v[:, 2]
        # per-vertex scale keeps the cofactors in a sane f32 range
        s = 1.0 / torch.maximum(torch.maximum(X.abs(), Y.abs()),
                                torch.clamp_min(ww.abs(), EPS_W))
        return X * s, Y * s, ww * s, z * s

    X0, Y0, w0, z0 = vertex(0)
    X1, Y1, w1, z1 = vertex(1)
    X2, Y2, w2, z2 = vertex(2)

    def cross3(ax, ay, aw, bx, by, bw):
        return (ay * bw - aw * by, aw * bx - ax * bw, ax * by - ay * bx)

    l0 = cross3(X1, Y1, w1, X2, Y2, w2)
    l1 = cross3(X2, Y2, w2, X0, Y0, w0)
    l2 = cross3(X0, Y0, w0, X1, Y1, w1)
    det = X0 * l0[0] + Y0 * l0[1] + w0 * l0[2]
    # CCW front faces come out with det < 0 in the y-down fold
    flip = torch.where(det < 0.0, -1.0, 1.0)
    front = (det < 0.0) if backface_cull else (det != 0.0)
    l0 = tuple(flip * x for x in l0)
    l1 = tuple(flip * x for x in l1)
    l2 = tuple(flip * x for x in l2)
    N = tuple(l0[i] * z0 + l1[i] * z1 + l2[i] * z2 for i in range(3))
    D = tuple(l0[i] * w0 + l1[i] * w1 + l2[i] * w2 for i in range(3))

    def center(f):   # sample at pixel centres: fold the +0.5 into c
        return (f[0], f[1], f[2] + 0.5 * f[0] + 0.5 * f[1])

    l0, l1, l2, N, D = center(l0), center(l1), center(l2), center(N), \
        center(D)

    one = torch.ones((), device=dev)
    zero = torch.zeros((), device=dev)
    all_front = (w0 > EPS_W) & (w1 > EPS_W) & (w2 > EPS_W)
    iw = [1.0 / torch.where(all_front, ww, one) for ww in (w0, w1, w2)]
    xs = torch.stack([X0 * iw[0], X1 * iw[1], X2 * iw[2]], 0)
    ys = torch.stack([Y0 * iw[0], Y1 * iw[1], Y2 * iw[2]], 0)
    xmin = torch.where(all_front, xs.amin(0), zero)
    xmax = torch.where(all_front, xs.amax(0), torch.full((), fw, device=dev))
    ymin = torch.where(all_front, ys.amin(0), zero)
    ymax = torch.where(all_front, ys.amax(0), torch.full((), fh, device=dev))
    ix0 = torch.clamp(f2i(torch.floor(xmin)), 0, w - 1)
    ix1 = torch.clamp(f2i(torch.ceil(xmax)), 0, w - 1)
    iy0 = torch.clamp(f2i(torch.floor(ymin)), 0, h - 1)
    iy1 = torch.clamp(f2i(torch.ceil(ymax)), 0, h - 1)
    onscreen = (xmax >= 0) & (xmin < fw) & (ymax >= 0) & (ymin < fh)
    # small-primitive cull: the bbox encloses no pixel centre
    covers_center = (~all_front) | (
        (torch.ceil(xmin - 0.5) <= torch.floor(xmax - 0.5)) &
        (torch.ceil(ymin - 0.5) <= torch.floor(ymax - 0.5)))
    # a triangle entirely behind the eye never covers (D <= 0)
    any_front = (w0 > EPS_W) | (w1 > EPS_W) | (w2 > EPS_W)
    valid = (tri_valid & front & (det != 0.0) & onscreen & covers_center &
             any_front)

    pay = torch.where(valid, payload.to(torch.int32),
                      torch.zeros((), dtype=torch.int32, device=dev))
    lanes = [l0[0], l1[0], l2[0], N[0], D[0], l0[1], l1[1], l2[1], N[1],
             D[1], l0[2], l1[2], l2[2], N[2], D[2]]
    rows = [bits_i32(x) for x in lanes] + [pay]
    if config.with_attrs:
        if attrs is None or attrs.shape[1] != 5:
            raise ValueError("with_attrs needs (V,5) attributes "
                             "(nx, ny, nz, u, v)")
        a0, a1, a2 = (attrs[idx[:, k]] for k in range(3))
        for k in range(5):
            for comp in range(3):
                rows.append(bits_i32(a0[:, k] * l0[comp] + a1[:, k] *
                                     l1[comp] + a2[:, k] * l2[comp]))
    rows += [torch.zeros_like(pay)] * (COEF_ROWS - len(rows))
    poison = _poison_row(dev)
    coefT = torch.where(valid[:, None], torch.stack(rows, dim=1),
                        poison[None, :])
    coefT = torch.cat([coefT, poison[None, :].expand(WINDOW, COEF_ROWS)])

    big = torch.full((), 1 << 29, dtype=torch.int32, device=dev)
    neg1 = torch.full((), -1, dtype=torch.int32, device=dev)
    lo = lambda v: torch.where(valid, v, big)
    hi = lambda v: torch.where(valid, v, neg1)
    win = lambda v: v.reshape(d, WINDOW)
    window_bbox = torch.stack([win(lo(ix0)).amin(1), win(lo(iy0)).amin(1),
                               win(hi(ix1)).amax(1), win(hi(iy1)).amax(1)])
    return TriangleSetup(
        coefT=coefT.contiguous(), window_bbox=window_bbox,
        window_valid=win(valid).any(1), valid=valid,
        sub_bounds=_sub_bounds(lo(iy0), hi(iy1), lo(ix0), hi(ix1), d,
                               config.sub_s))


def rasterize(clip: torch.Tensor, indices: torch.Tensor,
              tri_valid: torch.Tensor, payload: torch.Tensor,
              config: RasterConfig, backface_cull: bool = True,
              seeds: Optional[Sequence[torch.Tensor]] = None,
              attrs: Optional[torch.Tensor] = None,
              zclip: Optional[torch.Tensor] = None):
    """Clip positions -> (depth, vis[, nx, ny, nz, u, v], stats): pad the
    triangles to a multiple of 128, set them up, bin and rasterize them
    (chord_tpu raster.py:1040-1086). config.subtiles takes the sub-tile
    rounds (K8), which take no `zclip` (ignored there, as in chord_tpu);
    otherwise raster_queue (K1, or K7 with config.bricks)."""
    pad = (-indices.shape[0]) % WINDOW
    if pad:
        z = lambda x, shape: torch.cat([x, torch.zeros(
            shape, dtype=x.dtype, device=x.device)])
        indices = z(indices, (pad, 3))
        tri_valid = z(tri_valid, (pad,))
        payload = z(payload, (pad,))
    setup = setup_triangles(clip, indices, tri_valid, payload, config,
                            backface_cull=backface_cull, attrs=attrs)
    if config.subtiles:
        queue = bin_windows_subtile(setup, config)
        rts = raster_queue_subtile(queue, setup, config, seeds=seeds)
    else:
        queue = bin_windows(setup, config)
        rts = raster_queue(queue, setup, config, seeds=seeds, zclip=zclip)
    stats = {"bin_overflow": queue.overflow,
             "drawn_tris": setup.valid.to(torch.int32).sum().to(torch.int32),
             "binned_pairs": queue.n_pairs}
    return (*rts, stats)


# --- the sub-tile work queue -------------------------------------------------

class SubtileQueue(NamedTuple):
    """Rounds of 4 windows per screen tile, one per 32-px sub-tile."""

    gwin: torch.Tensor        # (r_cap*4,) i32 window per (round, sub-tile);
                              # empty slots -> the poison window D
    starts: torch.Tensor      # (n_tiles,) i32 first round of each tile
    counts: torch.Tensor      # (n_tiles,) i32 rounds of each tile
    y0r: torch.Tensor         # (r_cap,) i32 union y range of each round
    y1r: torch.Tensor         # (r_cap,) i32 (y1r < y0r: no rows)
    n_pairs: torch.Tensor     # () i32 binned (sub-tile, window) pairs
    overflow: torch.Tensor    # () i32 dropped pairs


def bin_windows_subtile(setup: TriangleSetup, config: RasterConfig
                        ) -> SubtileQueue:
    """Bin windows at 32-px sub-tile granularity and group each tile's
    pairs into rounds of 4, one slot per sub-tile (chord_tpu
    raster.py:1100-1230, same integer semantics): small windows expand to
    small_ky x small_kx*4 candidate sub-tiles; at most min(big_capacity,
    128) spanning windows take the big path, the rest count their
    sub-tile span as overflow; a tile takes as many rounds as its fullest
    sub-tile, the queue holds pair_capacity // 4 rounds, and every round
    past that counts 4 pairs of overflow. Keys sort stably (chord_tpu's
    sort leaves equal keys in backend order, so which windows share a
    round can differ; see ROADMAP)."""
    c = config
    st = SUB_TILES
    d = setup.num_windows
    dev = setup.coefT.device
    i32 = dict(dtype=torch.int32, device=dev)
    sub_w = c.tile_w // st
    n_sub = c.n_tiles * st
    bx0, by0, bx1, by1 = (setup.window_bbox[i] for i in range(4))
    gx0 = bx0 // sub_w
    gx1 = bx1 // sub_w
    ty0 = by0 // c.tile_h
    ty1 = by1 // c.tile_h
    span_x = gx1 - gx0 + 1
    span_y = ty1 - ty0 + 1
    ok = setup.window_valid & (bx1 >= bx0)
    k_sub = c.small_kx * st
    small = ok & (span_x <= k_sub) & (span_y <= c.small_ky)
    big = ok & ~small
    gxw = c.tiles_x * st
    invalid = torch.tensor(n_sub, **i32)
    win_ids = torch.arange(d, **i32)
    keys_l, vals_l = [], []
    for ky in range(c.small_ky):
        for kx in range(k_sub):
            tyk = ty0 + ky
            gxk = gx0 + kx
            hit = small & (tyk <= ty1) & (gxk <= gx1)
            keys_l.append(torch.where(hit, tyk * gxw + gxk, invalid))
            vals_l.append(win_ids)

    big_cap = min(c.big_capacity, 128)
    big_rank = torch.cumsum(big.to(torch.int32), 0) - 1
    n_big = big.to(torch.int32).sum()
    # exact dropped-pair count: the sub-tile span of each big window past
    # capacity
    big_overflow = torch.where(big & (big_rank >= big_cap), span_x * span_y,
                               torch.zeros((), **i32)).sum().to(torch.int32)
    big_list = torch.nonzero(big).reshape(-1).to(torch.int32)[:big_cap]
    big_list = torch.cat([big_list, torch.zeros(big_cap - big_list.shape[0],
                                                **i32)])
    have = torch.arange(big_cap, **i32) < torch.clamp(n_big, max=big_cap)
    bl = torch.where(have, big_list, torch.zeros((), **i32))
    blong = bl.long()
    bgx0 = torch.where(have, gx0[blong], gxw + 1)
    bty0 = torch.where(have, ty0[blong], c.tiles_y + 1)
    bgx1 = torch.where(have, gx1[blong], -1)
    bty1 = torch.where(have, ty1[blong], -1)
    sub_ix = torch.arange(n_sub, **i32)[None, :].expand(big_cap, n_sub)
    sgx = sub_ix % gxw
    sty = sub_ix // gxw
    overlap = ((sgx >= bgx0[:, None]) & (sgx <= bgx1[:, None]) &
               (sty >= bty0[:, None]) & (sty <= bty1[:, None]))
    keys_l.append(torch.where(overlap, sub_ix, invalid).reshape(-1))
    vals_l.append(bl[:, None].expand(big_cap, n_sub).reshape(-1))

    keys_s, order = torch.sort(torch.cat(keys_l), stable=True)
    vals_s = torch.cat(vals_l)[order]
    total = (keys_s < n_sub).to(torch.int32).sum().to(torch.int32)
    cap = c.pair_capacity
    if keys_s.shape[0] < cap:
        pad = cap - keys_s.shape[0]
        keys_s = torch.cat([keys_s, torch.full((pad,), n_sub, **i32)])
        vals_s = torch.cat([vals_s, torch.full((pad,), d, **i32)])
    n_pairs = torch.clamp(total, max=cap)
    overflow = torch.clamp_min(total - cap, 0) + big_overflow
    pk = keys_s[:cap].contiguous()
    pv = vals_s[:cap]

    sub_ids = torch.arange(n_sub, **i32)
    sub_start = torch.clamp(torch.searchsorted(pk, sub_ids, out_int32=True),
                            max=cap)
    sub_end = torch.minimum(torch.searchsorted(pk, sub_ids, right=True,
                                               out_int32=True), n_pairs)
    sub_cnt = torch.clamp_min(sub_end - sub_start, 0)

    # rounds per tile = its fullest sub-tile; the 4 sub-tiles of tile
    # (ty, tx) are the consecutive keys ty*gxw + tx*4 + 0..3
    rounds_t = sub_cnt.reshape(c.n_tiles, st).amax(1)
    r_cap = max(cap // st, 1)
    round_start = torch.cat([torch.zeros(1, **i32),
                             torch.cumsum(rounds_t, 0)[:-1].to(torch.int32)])
    total_rounds = rounds_t.sum().to(torch.int32)
    overflow = overflow + torch.clamp_min(total_rounds - r_cap, 0) * st

    g = torch.arange(r_cap, **i32)
    t_of_g = torch.clamp(torch.searchsorted(round_start, g, right=True,
                                            out_int32=True) - 1,
                         0, c.n_tiles - 1).long()
    r_loc = g - round_start[t_of_g]
    live = (g < torch.clamp(total_rounds, max=r_cap)) & (r_loc <
                                                         rounds_t[t_of_g])
    y0_all = torch.cat([setup.window_bbox[1],
                        torch.full((1,), 1 << 29, **i32)])
    y1_all = torch.cat([setup.window_bbox[3],
                        torch.full((1,), -(1 << 29), **i32)])
    y0r = torch.full((r_cap,), 1 << 29, **i32)
    y1r = torch.full((r_cap,), -(1 << 29), **i32)
    cols = []
    for sidx in range(st):
        sub = t_of_g * st + sidx
        src = torch.clamp(sub_start[sub] + r_loc, 0, cap - 1).long()
        has = live & (r_loc < sub_cnt[sub])
        win_s = torch.where(has, pv[src], torch.tensor(d, **i32))
        cols.append(win_s)
        y0r = torch.minimum(y0r, torch.where(has, y0_all[win_s.long()],
                                             torch.tensor(1 << 29, **i32)))
        y1r = torch.maximum(y1r, torch.where(has, y1_all[win_s.long()],
                                             torch.tensor(-(1 << 29),
                                                          **i32)))
    counts = torch.minimum(rounds_t, torch.clamp_min(r_cap - round_start, 0))
    return SubtileQueue(
        gwin=torch.stack(cols, 1).reshape(-1).contiguous(),
        starts=torch.clamp(round_start, max=r_cap).contiguous(),
        counts=torch.clamp_min(counts, 0).to(torch.int32).contiguous(),
        y0r=torch.clamp(y0r, -1, 1 << 20).contiguous(),
        y1r=torch.clamp(y1r, -2, 1 << 20).contiguous(),
        n_pairs=n_pairs, overflow=overflow)


# --- raster entry points -----------------------------------------------------

def _check_config(c: RasterConfig) -> None:
    """chord_tpu raster_queue's checks (raster.py:946-961) and the port's
    128-px tile; `subtiles` is not read here (only rasterize() reads it)."""
    if c.tile_w != WINDOW:
        raise ValueError(f"tile_w={c.tile_w}: the raster kernels need 128")
    if c.tile_h % 8 != 0 or c.tile_h % c.sub_s != 0:
        raise ValueError(f"tile_h={c.tile_h} must be a multiple of 8 and "
                         f"of sub_s={c.sub_s} (set via r.raster.tileH)")
    if c.rp and (c.tile_h % c.rp != 0 or c.rp % 8 != 0):
        raise ValueError(f"rp={c.rp} must divide tile_h={c.tile_h} and be a "
                         f"multiple of 8 (set via r.raster.rp)")
    if c.bricks and c.tile_h % (BRICK_H * c.sub_s) != 0:
        raise ValueError(f"bricks mode needs tile_h % {BRICK_H * c.sub_s} "
                         f"== 0 (got {c.tile_w}x{c.tile_h})")


def _seed_planes(seeds, c: RasterConfig, dev) -> List[torch.Tensor]:
    """The seeds padded to (h_pad, w_pad): depth f32, vis i32[, 5 attrs]."""
    h_pad = c.tiles_y * c.tile_h
    w_pad = c.tiles_x * c.tile_w
    n_rt = 2 + (5 if c.with_attrs else 0)

    def padded(x, dtype):
        out = torch.zeros((h_pad, w_pad), dtype=dtype, device=dev)
        if x is not None:
            out[:x.shape[0], :x.shape[1]] = x.to(dtype)
        return out

    seeds = list(seeds or []) + [None] * n_rt
    return [padded(seeds[0], torch.float32), padded(seeds[1], torch.int32)] \
        + [padded(seeds[2 + k], torch.float32) for k in range(n_rt - 2)]


def raster_queue(queue: WorkQueue, setup: TriangleSetup, config: RasterConfig,
                 seeds: Optional[Sequence[torch.Tensor]] = None,
                 zclip: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """Rasterize the work queue -> render targets cropped to (H,W):
    (depth f32 reverse-Z, vis i32 bits[, nx, ny, nz, u, v f32]), with K1,
    or with K7 when config.bricks.

    `seeds` (same layout) carries an earlier phase's targets through a
    re-raster (two-phase occlusion); `zclip` (needs config.z_clip) is an
    (H,W) reverse-Z plane: fragments at or nearer than it are rejected."""
    c = config
    _check_config(c)
    h_pad = c.tiles_y * c.tile_h
    w_pad = c.tiles_x * c.tile_w
    dev = setup.coefT.device
    seed_planes = _seed_planes(seeds, c, dev)
    zq = None
    if c.z_clip:
        # default +3e38 = clip nothing (every fragment is nearer)
        zq = torch.full((h_pad, w_pad), 3e38, dtype=torch.float32, device=dev)
        if zclip is not None:
            zq[:zclip.shape[0], :zclip.shape[1]] = zclip
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
    kernel = raster_bricks if c.bricks else raster_tiles
    outs = kernel(queue.pair_win, queue.starts, queue.counts,
                  sb.contiguous(), setup.coefT, seed_planes, zq, c)
    return tuple(o[:c.height, :c.width] for o in outs)


def raster_queue_subtile(queue: SubtileQueue, setup: TriangleSetup,
                         config: RasterConfig,
                         seeds: Optional[Sequence[torch.Tensor]] = None
                         ) -> Tuple[torch.Tensor, ...]:
    """Rasterize the sub-tile rounds with K8 -> render targets cropped to
    (H,W). As in chord_tpu (raster.py:1366-1427) there are no tile_h
    checks and no z_clip."""
    c = config
    outs = raster_subtile(queue.gwin, queue.starts, queue.counts, queue.y0r,
                          queue.y1r, setup.coefT,
                          _seed_planes(seeds, c, setup.coefT.device), c)
    return tuple(o[:c.height, :c.width] for o in outs)


# --- the plain versions ------------------------------------------------------

def _expand_rows(r0: torch.Tensor, nrows: torch.Tensor):
    """Per group a row range [r0, r0+nrows) -> (group of each row, row)."""
    dev = r0.device
    n = int(nrows.sum())
    it_g = torch.repeat_interleave(torch.arange(r0.numel(), device=dev),
                                   nrows)
    row = (r0[it_g] + torch.arange(n, device=dev) -
           (torch.cumsum(nrows, 0) - nrows)[it_g])
    return it_g, row


def _pair_groups(pair_win, starts, counts, sb, c: RasterConfig):
    """The (pair, subwindow) groups of a work queue -> per group: window,
    subwindow, tile origin (py0, px0), rows y0 <= y < y1 inside the tile
    and the subwindow's x range [sx0, sx1]."""
    dev = pair_win.device
    s_cnt = c.sub_s
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
    return g_win, g_s, py0, px0, y0, y1, sb[2].long()[base], \
        sb[3].long()[base]


def _groups(pair_win, starts, counts, sb, c: RasterConfig):
    """K1's visits: the (pair, subwindow) groups whose x range meets the
    tile, with their rows rounded out to rp-row groups -> (window,
    subwindow, py0, px0, first row, row count)."""
    rp = c.rp or c.sub_s
    g_win, g_s, py0, px0, y0, y1, sx0, sx1 = _pair_groups(
        pair_win, starts, counts, sb, c)
    xok = (sx1 >= px0) & (sx0 < px0 + c.tile_w)
    y1 = torch.where(xok, y1, torch.zeros_like(y1))
    keep = y1 > y0
    y0, y1 = y0[keep], y1[keep]
    r0 = (y0 // rp) * rp
    r1 = ((y1 + rp - 1) // rp) * rp
    return (g_win[keep], g_s[keep], py0[keep], px0[keep], r0, r1 - r0)


def _brick_groups(pair_win, starts, counts, sb, c: RasterConfig):
    """K7's visits: per (pair, subwindow) meeting the tile, per 32-px brick
    its x range meets, the row groups of 4*S rows from y0 // (4*S) to
    ceil(y1 / (4*S)) -> (window, subwindow, py0, brick x0, brick, first
    row, row count)."""
    rows_it = BRICK_H * c.sub_s
    g_win, g_s, py0, px0, y0, y1, sx0, sx1 = _pair_groups(
        pair_win, starts, counts, sb, c)
    xok_any = (sx1 >= px0) & (sx0 < px0 + c.tile_w)
    keep = (y1 > y0) & xok_any
    g_win, g_s, py0, px0, y0, y1, sx0, sx1 = (
        v[keep] for v in (g_win, g_s, py0, px0, y0, y1, sx0, sx1))
    nb = c.tile_w // BRICK_W
    bx = torch.arange(nb, device=g_win.device).repeat(g_win.numel())
    rep = lambda v: torch.repeat_interleave(v, nb)
    g_win, g_s, py0, px0, y0, y1, sx0, sx1 = (
        rep(v) for v in (g_win, g_s, py0, px0, y0, y1, sx0, sx1))
    bx0 = px0 + bx * BRICK_W
    xok = (sx1 >= bx0) & (sx0 < bx0 + BRICK_W)
    p0 = y0 // rows_it
    p1 = (torch.where(xok, y1, torch.zeros_like(y1)) + rows_it - 1) // rows_it
    keep = p1 > p0
    return (g_win[keep], g_s[keep], py0[keep], bx0[keep], bx[keep],
            p0[keep] * rows_it, (p1 - p0)[keep] * rows_it)


def _subtile_groups(gwin, starts, counts, y0r, y1r, poison: int,
                    c: RasterConfig):
    """K8's visits: per tile, round and sub-tile whose window is not the
    poison window, the round's union rows inside the tile -> (window,
    py0, sub-tile x0, first row, row count)."""
    dev = gwin.device
    n_tiles = counts.shape[0]
    cnt = counts.long()
    tile_of = torch.repeat_interleave(torch.arange(n_tiles, device=dev), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    rid = starts.long()[tile_of] + torch.arange(tile_of.numel(), device=dev) \
        - first[tile_of]
    py0 = (tile_of // c.tiles_x) * c.tile_h
    y0 = torch.clamp(y0r.long()[rid] - py0, 0, c.tile_h)
    y1 = torch.clamp(y1r.long()[rid] + 1 - py0, 0, c.tile_h)
    sub = torch.arange(SUB_TILES, device=dev).repeat(rid.numel())
    rep = lambda v: torch.repeat_interleave(v, SUB_TILES)
    tile_of, rid, py0, y0, y1 = (rep(v) for v in (tile_of, rid, py0, y0, y1))
    win = gwin.long()[rid * SUB_TILES + sub]
    keep = (win != poison) & (y1 > y0)
    sx0 = (tile_of % c.tiles_x) * c.tile_w + sub * (c.tile_w // SUB_TILES)
    return (win[keep], py0[keep], sx0[keep], y0[keep], (y1 - y0)[keep])


def band_split(r0: torch.Tensor, nrows: torch.Tensor, band: int):
    """The band rule of K1, K7 and K8 (csrc/raster.cu, raster_bricks.cu,
    raster_subtile.cu):
    a block owns 32 columns of a tile and the tile rows [b*band, (b+1)*band)
    of one band b, and walks, in queue order, the visits whose rows meet its
    band, each cut to the band. Visit i's tile rows [r0[i], r0[i]+nrows[i])
    (nrows > 0) -> per piece, ordered by visit then band: (visit, band,
    first row, row count)."""
    dev = r0.device
    b0 = r0 // band
    nb = (r0 + nrows - 1) // band - b0 + 1
    item = torch.repeat_interleave(torch.arange(r0.numel(), device=dev), nb)
    b = b0[item] + torch.arange(item.numel(), device=dev) - \
        (torch.cumsum(nb, 0) - nb)[item]
    lo = torch.maximum(r0[item], b * band)
    hi = torch.minimum((r0 + nrows)[item], (b + 1) * band)
    return item, b, lo, hi - lo


def kernel_visits(name: str, args):
    """The plain visit list of a K1 ("raster"), K7 ("raster_bricks") or K8
    ("raster_subtile") call's arguments -> per visit, in queue order: (first
    triangle, triangles in its group, tile py0, the x0 of the 32-px columns
    it covers (visits, columns), first tile row, row count, and for K7 the
    brick's offset 32*bx in its tile, else None)."""
    if name in ("raster", "raster_bricks"):
        pair_win, starts, counts, sb, coefT, seeds, zclip, c = args
        cs = WINDOW // c.sub_s
        if name == "raster_bricks":
            g_win, g_s, py0, bx0, bx, r0, nrows = _brick_groups(
                pair_win, starts, counts, sb, c)
            return (g_win * WINDOW + g_s * cs, cs, py0, bx0[:, None], r0,
                    nrows, bx * BRICK_W)
        g_win, g_s, py0, px0, r0, nrows = _groups(pair_win, starts, counts,
                                                  sb, c)
        cols = px0[:, None] + 32 * torch.arange(c.tile_w // 32,
                                                device=px0.device)
        return g_win * WINDOW + g_s * cs, cs, py0, cols, r0, nrows, None
    gwin, starts, counts, y0r, y1r, coefT, seeds, c = args
    win, py0, sx0, r0, nrows = _subtile_groups(
        gwin, starts, counts, y0r, y1r, coefT.shape[0] // WINDOW - 1, c)
    return win * WINDOW, WINDOW, py0, sx0[:, None], r0, nrows, None


def corner_cull(a, b, c, x_lo, y_lo, y_hi, xoff=None) -> torch.Tensor:
    """The raster kernels' per-warp cull of one edge plane
    (csrc/raster_core.cuh edge_misses), on float32 tensors that broadcast:
    True where the plane, evaluated as the test evaluates it, is negative
    at the corner of [x_lo, x_lo + 31] x [y_lo, y_hi] where it is largest,
    so on the whole rectangle. K1 and K8: a*x + (b*y + c); with `xoff`
    (K7): (a*xl + b*yl) + (b*yb + (c + a*xoff)), xl = x - xoff, yl = y mod
    4, yb = y - yl, largest at xl's and, in the direction of b, at
    (yl, yb)'s high or low end: the rows' own when they share a brick row,
    else the box's (yl 0 or 3)."""
    ok = (a.abs() <= CULL_MAX) & (b.abs() <= CULL_MAX) & (c.abs() <= CULL_MAX)
    if xoff is None:
        xs = torch.where(a >= 0, x_lo + 31.0, x_lo)
        ys = torch.where(b >= 0, y_hi, y_lo)
        return ok & (a * xs + (b * ys + c) < 0)
    xl = x_lo - xoff
    xs = torch.where(a >= 0, xl + 31.0, xl)
    yb_lo, yb_hi = y_lo - y_lo % BRICK_H, y_hi - y_hi % BRICK_H
    one = yb_lo == yb_hi
    yl_lo = torch.where(one, y_lo - yb_lo, torch.zeros_like(y_lo))
    yl_hi = torch.where(one, y_hi - yb_hi, torch.full_like(y_hi, BRICK_H - 1))
    yl = torch.where(b >= 0, yl_hi, yl_lo)
    yb = torch.where(b >= 0, yb_hi, yb_lo)
    return ok & ((a * xs + b * yl) + (b * yb + (c + a * xoff)) < 0)


def cull_tests(coefT, tri0, n_tri: int, py0, cols, r0, nrows, xoff=None,
               chunk: int = 8192) -> Tuple[int, int]:
    """What K1, K7 and K8 evaluate on a visit list (kernel_visits) after
    the cull: each visit is cut into runs of the WARP_ROWS-row thread
    groups; per run and column the cull evaluates every triangle of the
    group (in K7's association with `xoff`), and the triangles it keeps
    are tested on the run's 32 x rows pixels -> (pixel tests, cull
    evaluations)."""
    coef = bits_f32(coefT)[:, :15]
    item, _, lo, n = band_split(r0, nrows, WARP_ROWS)
    tri = torch.arange(n_tri, device=coef.device)
    tests = 0
    for s in range(0, item.numel(), chunk):
        it, n_s = item[s:s + chunk], n[s:s + chunk]
        y_lo = (py0[it] + lo[s:s + chunk]).float()[:, None, None]
        y_hi = y_lo + (n_s - 1).float()[:, None, None]
        x_lo = cols[it].float()[:, :, None]          # (runs, columns, 1)
        xo = None if xoff is None else xoff[it].float()[:, None, None]
        cf = coef[tri0[it][:, None] + tri][:, None]  # (runs, 1, tri, 15)
        miss = torch.zeros((), dtype=torch.bool, device=coef.device)
        for k in range(3):
            miss = miss | corner_cull(cf[..., k], cf[..., 5 + k],
                                      cf[..., 10 + k], x_lo, y_lo, y_hi, xo)
        miss = miss.expand(it.numel(), cols.shape[1], n_tri)
        tests += int(((~miss).sum((1, 2)) * n_s).sum()) * 32
    return tests, item.numel() * cols.shape[1] * n_tri


def _eval_items(coefT, seeds, zclip, n_attr: int, tri0, n_tri: int, x0,
                n_lanes: int, row, xoff=None, chunk: int = 8192
                ) -> List[torch.Tensor]:
    """Shared core of the plain raster versions. Item i is one pixel row
    `row[i]` x `n_lanes` pixels from `x0[i]`, against the group of `n_tri`
    triangles from coefficient row `tri0[i]`. Per pixel the group's result
    (max depth, max payload at it, max attributes at it) merges into the
    seeds as a lexicographic max over (depth, payload).

    Plane association: K1 and K8 evaluate l = a*x + (b*y + c); with
    `xoff` (the pixel's brick offset 32*bx, K7) it is
    l = (a*xl + b*yl) + (b*yb + (c + a*xoff)), where xl = x - xoff,
    yl = y mod 4 and yb = y - yl, and an attribute plane
    ((aa*xl + ab*yl) + (ab*yb + (ac + aa*xoff))) / sum(l)."""
    dev = coefT.device
    h_pad, w_pad = seeds[0].shape
    lane = torch.arange(n_lanes, device=dev)
    tri = torch.arange(n_tri, device=dev)
    zero = torch.zeros((), device=dev)
    one = torch.ones((), device=dev)
    acc_key = ((seeds[0].contiguous().view(torch.int32).long() << 32) |
               (seeds[1].long() + 2 ** 31)).reshape(-1)
    acc = [p.reshape(-1).clone() for p in seeds[:2 + n_attr]]
    for lo in range(0, row.numel(), chunk):
        sl = slice(lo, lo + chunk)
        row_abs = row[sl]
        co = coefT[tri0[sl][:, None] + tri[None, :]]          # (I,T,32) i32
        cf = bits_f32(co)
        col = lambda k: cf[:, :, k:k + 1]
        xs = x0[sl][:, None] + lane[None, :]                   # (I,L)
        if xoff is None:
            px = xs.to(torch.float32)[:, None, :]
            yf = row_abs.to(torch.float32)[:, None, None]
            plane = lambda a, b, cc: col(a) * px + (col(b) * yf + col(cc))
        else:
            xo = xoff[sl]
            pxl = (xs - xo[:, None]).to(torch.float32)[:, None, :]
            xof = xo.to(torch.float32)[:, None, None]
            yl = row_abs % BRICK_H
            ylf = yl.to(torch.float32)[:, None, None]
            yf = (row_abs - yl).to(torch.float32)[:, None, None]
            plane = lambda a, b, cc: ((col(a) * pxl + col(b) * ylf) +
                                      (col(b) * yf + (col(cc) +
                                                      col(a) * xof)))
        l0, l1, l2, zn, zd = (plane(k, 5 + k, 10 + k) for k in range(5))
        covered = ((l0 >= 0.0) & (l1 >= 0.0) & (l2 >= 0.0) & (zd > 0.0) &
                   (zn > 0.0) & (zn <= zd))
        cand = torch.where(covered, zn / torch.where(covered, zd, one), zero)
        pix = row_abs[:, None] * w_pad + xs                    # (I,L)
        if zclip is not None:
            zc = zclip.reshape(-1)[pix][:, None, :]
            cand = torch.where(cand < zc, cand, zero)
        best = cand.amax(dim=1)                                # (I,L)
        winner = (cand == best[:, None, :]) & (cand > 0.0)
        pay_sel = torch.where(winner, co[:, :, 15:16], torch.zeros(
            (), dtype=torch.int32, device=dev)).amax(dim=1)
        sels = []
        if n_attr:
            inv_s = 1.0 / torch.where(covered, l0 + l1 + l2, one)
            for k in range(n_attr):
                val = plane(16 + 3 * k, 17 + 3 * k, 18 + 3 * k) * inv_s
                sels.append(torch.where(winner, val, torch.full(
                    (), NEG, device=dev)).amax(dim=1))
        key = ((best.contiguous().view(torch.int32).long() << 32) |
               (pay_sel.long() + 2 ** 31))
        # lexicographic max within the chunk, then against the accumulator
        # (strictly greater replaces: the accumulator wins ties, as the
        # kernels' in-order merge does)
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


def raster_tiles_plain(pair_win, starts, counts, sub_bounds, coefT,
                       seeds: List[torch.Tensor], zclip, c: RasterConfig,
                       chunk: int = 8192) -> List[torch.Tensor]:
    """Plain PyTorch version of kernel K1 (same inputs and outputs as
    `raster_tiles`; outputs are the padded (h_pad, w_pad) planes)."""
    cs = WINDOW // c.sub_s
    g_win, g_s, py0, px0, r0, nrows = _groups(pair_win, starts, counts,
                                              sub_bounds, c)
    it_g, row = _expand_rows(r0, nrows)
    return _eval_items(coefT, seeds, zclip, 5 if c.with_attrs else 0,
                       (g_win * WINDOW + g_s * cs)[it_g], cs, px0[it_g],
                       c.tile_w, py0[it_g] + row, chunk=chunk)


def raster_bricks_plain(pair_win, starts, counts, sub_bounds, coefT,
                        seeds: List[torch.Tensor], zclip, c: RasterConfig,
                        chunk: int = 32768) -> List[torch.Tensor]:
    """Plain PyTorch version of kernel K7 (same inputs and outputs as
    `raster_bricks`): K1's function over K7's visits in K7's
    association."""
    cs = WINDOW // c.sub_s
    g_win, g_s, py0, bx0, bx, r0, nrows = _brick_groups(
        pair_win, starts, counts, sub_bounds, c)
    it_g, row = _expand_rows(r0, nrows)
    return _eval_items(coefT, seeds, zclip, 5 if c.with_attrs else 0,
                       (g_win * WINDOW + g_s * cs)[it_g], cs, bx0[it_g],
                       BRICK_W, py0[it_g] + row,
                       xoff=(bx * BRICK_W)[it_g], chunk=chunk)


def raster_subtile_plain(gwin, starts, counts, y0r, y1r, coefT,
                         seeds: List[torch.Tensor], c: RasterConfig,
                         chunk: int = 4096) -> List[torch.Tensor]:
    """Plain PyTorch version of kernel K8 (same inputs and outputs as
    `raster_subtile`): per pixel the group is the whole 128-triangle
    window of its sub-tile's slot in the round."""
    poison = coefT.shape[0] // WINDOW - 1
    win, py0, sx0, r0, nrows = _subtile_groups(gwin, starts, counts, y0r,
                                               y1r, poison, c)
    it_g, row = _expand_rows(r0, nrows)
    return _eval_items(coefT, seeds, None, 5 if c.with_attrs else 0,
                       (win * WINDOW)[it_g], WINDOW, sx0[it_g],
                       c.tile_w // SUB_TILES, py0[it_g] + row, chunk=chunk)


# --- the wrappers ------------------------------------------------------------

def _check_targets(seeds, zclip, n_attr: int, c: RasterConfig) -> None:
    h_pad, w_pad = c.tiles_y * c.tile_h, c.tiles_x * c.tile_w
    if len(seeds) != 2 + n_attr:
        raise ValueError(f"{len(seeds)} seed planes, expected {2 + n_attr}")
    _cuda.check(seeds[0], "seed depth", torch.float32, (h_pad, w_pad))
    _cuda.check(seeds[1], "seed vis", torch.int32, (h_pad, w_pad))
    for k in range(n_attr):
        _cuda.check(seeds[2 + k], "seed attr", torch.float32, (h_pad, w_pad))
    if zclip is not None:
        _cuda.check(zclip, "zclip", torch.float32, (h_pad, w_pad))


def _new_targets(seeds, n_attr: int, dev):
    """(depth, vis, attr (n_attr,h,w) or None, seed attrs stacked or None)."""
    h_pad, w_pad = seeds[0].shape
    return (torch.empty((h_pad, w_pad), dtype=torch.float32, device=dev),
            torch.empty((h_pad, w_pad), dtype=torch.int32, device=dev),
            torch.empty((n_attr, h_pad, w_pad), dtype=torch.float32,
                        device=dev) if n_attr else None,
            torch.stack(seeds[2:2 + n_attr]).contiguous() if n_attr
            else None)


def _launch_queue(entry: str, pair_win, starts, counts, sub_bounds, coefT,
                  seeds: List[torch.Tensor], zclip, c: RasterConfig
                  ) -> List[torch.Tensor]:
    """Check a work queue's tensors and launch the K1 / K7 entry point
    `entry` (both take the same arguments)."""
    _check_config(c)
    n_attr = 5 if c.with_attrs else 0
    n_tiles = c.n_tiles
    d1 = coefT.shape[0] // WINDOW
    chk = _cuda.check
    chk(pair_win, "pair_win", torch.int32)
    chk(starts, "starts", torch.int32, (n_tiles,))
    chk(counts, "counts", torch.int32, (n_tiles,))
    chk(sub_bounds, "sub_bounds", torch.int32, (4, d1 * c.sub_s))
    chk(coefT, "coefT", torch.int32, (d1 * WINDOW, COEF_ROWS))
    _check_targets(seeds, zclip, n_attr, c)
    depth, vis, attr, seed_attr = _new_targets(seeds, n_attr, coefT.device)
    ci, p = _cuda.cint, _cuda.ptr
    _cuda.launch(entry, p(pair_win), p(starts), p(counts), p(sub_bounds),
                 ci(sub_bounds.shape[1]), p(coefT), p(seeds[0]), p(seeds[1]),
                 p(seed_attr), p(zclip), p(depth), p(vis), p(attr),
                 ci(n_tiles), ci(c.tiles_x), ci(c.tile_h), ci(depth.shape[1]),
                 ci(c.sub_s), ci(c.rp or c.sub_s), ci(n_attr), _cuda.stream())
    return [depth, vis] + ([attr[k] for k in range(n_attr)] if n_attr
                           else [])


def raster_tiles(pair_win, starts, counts, sub_bounds, coefT,
                 seeds: List[torch.Tensor], zclip, c: RasterConfig
                 ) -> List[torch.Tensor]:
    """Kernel K1: rasterize the work queue into padded render targets.
    CPU tensors -> raster_tiles_plain; CUDA tensors -> csrc/raster.cu."""
    if not coefT.is_cuda:
        return raster_tiles_plain(pair_win, starts, counts, sub_bounds,
                                  coefT, seeds, zclip, c)
    out = _launch_queue("chord_raster_tiles", pair_win, starts, counts,
                        sub_bounds, coefT, seeds, zclip, c)
    raster_tiles.launches += 1
    return out


raster_tiles.launches = 0


def raster_bricks(pair_win, starts, counts, sub_bounds, coefT,
                  seeds: List[torch.Tensor], zclip, c: RasterConfig
                  ) -> List[torch.Tensor]:
    """Kernel K7: the brick-visit raster of the work queue into padded
    render targets. CPU tensors -> raster_bricks_plain; CUDA tensors ->
    csrc/raster_bricks.cu."""
    if not coefT.is_cuda:
        return raster_bricks_plain(pair_win, starts, counts, sub_bounds,
                                   coefT, seeds, zclip, c)
    if not c.bricks:
        raise ValueError("raster_bricks needs config.bricks")
    out = _launch_queue("chord_raster_bricks", pair_win, starts, counts,
                        sub_bounds, coefT, seeds, zclip, c)
    raster_bricks.launches += 1
    return out


raster_bricks.launches = 0


def raster_subtile(gwin, starts, counts, y0r, y1r, coefT,
                   seeds: List[torch.Tensor], c: RasterConfig
                   ) -> List[torch.Tensor]:
    """Kernel K8: rasterize the sub-tile rounds into padded render
    targets. CPU tensors -> raster_subtile_plain; CUDA tensors ->
    csrc/raster_subtile.cu."""
    if not coefT.is_cuda:
        return raster_subtile_plain(gwin, starts, counts, y0r, y1r, coefT,
                                    seeds, c)
    if c.tile_w != WINDOW:
        raise ValueError(f"tile_w={c.tile_w}: the sub-tile kernel needs "
                         f"{WINDOW}")
    n_attr = 5 if c.with_attrs else 0
    n_tiles = c.n_tiles
    d1 = coefT.shape[0] // WINDOW
    chk = _cuda.check
    chk(gwin, "gwin", torch.int32)
    r_cap = gwin.shape[0] // SUB_TILES
    chk(starts, "starts", torch.int32, (n_tiles,))
    chk(counts, "counts", torch.int32, (n_tiles,))
    chk(y0r, "y0r", torch.int32, (r_cap,))
    chk(y1r, "y1r", torch.int32, (r_cap,))
    chk(coefT, "coefT", torch.int32, (d1 * WINDOW, COEF_ROWS))
    _check_targets(seeds, None, n_attr, c)
    depth, vis, attr, seed_attr = _new_targets(seeds, n_attr, coefT.device)
    ci, p = _cuda.cint, _cuda.ptr
    _cuda.launch("chord_raster_subtile", p(gwin), p(starts), p(counts),
                 p(y0r), p(y1r), p(coefT), ci(d1 - 1), p(seeds[0]),
                 p(seeds[1]), p(seed_attr), p(depth), p(vis), p(attr),
                 ci(n_tiles), ci(c.tiles_x), ci(c.tile_h), ci(depth.shape[1]),
                 ci(n_attr), _cuda.stream())
    raster_subtile.launches += 1
    return [depth, vis] + ([attr[k] for k in range(n_attr)] if n_attr
                           else [])


raster_subtile.launches = 0
