"""The block decomposition of the raster kernels K1, K7 and K8, on the CPU.

K1 (csrc/raster.cu), K7 (csrc/raster_bricks.cu) and K8
(csrc/raster_subtile.cu) give each block 32 columns of a tile and a band
of rows (raster.K1_BAND, K7_BAND, K8_BAND); a block walks, in queue order,
only the visits whose rows meet its band (raster.band_split), and each
warp skips the triangles that a corner test shows to fail l0, l1, l2 >= 0
on its whole rectangle of 32 columns x its rows. Neither may change a bit
of the result. Here, on small seeded queues at 256x96:

- the band pieces of the visit lists (raster._groups, _brick_groups,
  _subtile_groups) cover every visited pixel row once, with each pixel's
  visits in queue order;
- evaluating block by block through raster._eval_items (each block's 32
  columns and band, in block order; K7 in its association, with xoff)
  gives planes equal to raster_tiles_plain / raster_bricks_plain /
  raster_subtile_plain bit for bit;
- the corner test (raster.corner_cull, evaluated as the kernels evaluate
  it: float32, the plain version's association, K7's with xoff) never
  skips a triangle that covers a pixel of the rectangle, and
  raster.cull_tests counts the tests it leaves.

`band_inputs` builds the seeded cases; tests/test_torch_cuda.py runs the
kernels on them against the plain versions on the card.
"""

import numpy as np
import pytest
import torch

from chord_tpu_torch.ops import raster

W, H = 256, 96


def _scene(rng, scene: str, n_win: int, tile_h: int):
    """Clip-space vertices, validity, payloads and vertex attributes of
    n_win windows of 128 triangles."""
    n = n_win * 128
    if scene == "ties":
        # squares (two triangles each) over band boundaries at dyadic
        # depths, drawn twice in every window and once more in each later
        # window, with other payloads and attributes: exact depth ties
        # within a group (attributes max) and across visits (payload
        # decides; two visits never give one key, see ROADMAP §3)
        sq = [(0, 5, 64, 43, 0.5), (32, 0, 96, 70, 0.5),
              (100, 9, 160, 95, 0.25), (140, 20, 256, 60, 0.75),
              (8, 30, 250, 41, 0.5)]
        clip = np.zeros((n * 3, 4), np.float32)
        clip[:, 3] = 1.0
        valid = np.zeros(n, bool)
        for copy in range(n_win):
            for k, (x0, y0, x1, y1, z) in enumerate(sq):
                corners = np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]],
                                   np.float64)
                ndc = np.stack([corners[:, 0] * 2.0 / W - 1.0,
                                1.0 - corners[:, 1] * 2.0 / H], 1)
                for half, (i, j, m) in enumerate(((0, 1, 2), (0, 2, 3))):
                    for t in (copy * 128 + 2 * k + half,
                              copy * 128 + 64 + 2 * k + half):
                        clip[3 * t:3 * t + 3, :2] = ndc[[i, j, m]]
                        clip[3 * t:3 * t + 3, 2] = z
                        valid[t] = True
    else:
        cen = rng.uniform(-1.1, 1.1, (n, 2))
        half = rng.uniform(-0.2, 0.2, (n, 3, 2))
        if scene == "imbalance":
            # every window but the last over tile 0, the last in the
            # bottom right corner, the tiles between empty
            y_top = 1.0 - 2.0 * tile_h / H
            cen[: n - 128] = np.stack(
                [rng.uniform(-1.0, -0.1, n - 128),
                 rng.uniform(y_top + 0.1, 1.0, n - 128)], 1)
            cen[n - 128:] = np.stack([rng.uniform(0.5, 0.9, 128),
                                      rng.uniform(-0.9, -0.6, 128)], 1)
            half *= 0.5
        elif scene == "straddle":  # tall thin triangles over band edges
            half[..., 0] *= 0.25
            half[..., 1] *= 3.0
        cen = cen[np.argsort(np.floor(cen[:, 1] * 4) * 8 + cen[:, 0])]
        pts = cen[:, None, :] + half
        wv = rng.uniform(0.6, 2.5, (n, 3))
        clip = np.zeros((n * 3, 4), np.float32)
        clip[:, 0:2] = (pts * wv[..., None]).reshape(-1, 2)
        clip[:, 2] = (rng.uniform(0.1, 0.9, (n, 1)) * wv).reshape(-1)
        clip[:, 3] = wv.reshape(-1)
        valid = rng.uniform(size=n) < 0.9
        valid[128:256] = False                 # an empty window
    payload = np.arange(1, n + 1, dtype=np.int32)
    if scene == "negative":                    # signed payload compares
        payload[1::2] *= -1
    attrs = (rng.integers(-8, 9, (n * 3, 5)) / 8.0).astype(np.float32)
    return clip, valid, payload, attrs


def band_inputs(d, kernel: str, scene: str, attrs: bool, tile_h: int,
                sub_s: int = 8, rp: int = 0, zclip: bool = False,
                seed: int = 11):
    """The arguments of raster_tiles (kernel "k1"), raster_bricks ("k7";
    tile_h a multiple of 4*sub_s) or raster_subtile ("k8") on `d`: n windows of `scene` ("random", "imbalance",
    "straddle", "ties", "negative") at 256x96, random seed planes (depth
    [0, 0.5) with half of it 0; vis ids, signed for "negative" and "ties",
    so a visit that covers nothing still replaces a (0, < 0) seed)."""
    rng = np.random.default_rng(seed)
    n_win = {"ties": 4, "imbalance": 10}.get(scene, 6)
    clip, valid, payload, vattr = _scene(rng, scene, n_win, tile_h)
    n = valid.shape[0]
    c = raster.RasterConfig(width=W, height=H, tile_h=tile_h, sub_s=sub_s,
                            rp=rp, with_attrs=attrs, z_clip=zclip,
                            subtiles=kernel == "k8", bricks=kernel == "k7",
                            pair_capacity=2048,
                            big_capacity=32)
    t = lambda a: torch.from_numpy(a).to(d)
    setup = raster.setup_triangles(
        t(clip), t(np.arange(n * 3, dtype=np.int32).reshape(n, 3)),
        t(valid), t(payload), c, backface_cull=False, attrs=t(vattr))
    h_pad, w_pad = c.tiles_y * c.tile_h, c.tiles_x * c.tile_w
    dep = rng.uniform(0, 0.5, (h_pad, w_pad)).astype(np.float32)
    dep[rng.uniform(size=dep.shape) < 0.5] = 0.0
    lo = -(1 << 20) if scene in ("negative", "ties") else 0
    seeds = [dep, rng.integers(lo, 1 << 20, (h_pad, w_pad)).astype(np.int32)]
    seeds += [rng.normal(size=(h_pad, w_pad)).astype(np.float32)
              for _ in range(5 if attrs else 0)]
    seeds = [t(x) for x in seeds]
    if kernel == "k8":
        q = raster.bin_windows_subtile(setup, c)
        return (q.gwin, q.starts, q.counts, q.y0r, q.y1r, setup.coefT, seeds,
                c)
    q = raster.bin_windows(setup, c)
    zc = (t(rng.uniform(0.2, 1.0, (h_pad, w_pad)).astype(np.float32))
          if zclip else None)
    return (q.pair_win, q.starts, q.counts, setup.sub_bounds, setup.coefT,
            seeds, zc, c)


NAME = {"k1": "raster", "k7": "raster_bricks", "k8": "raster_subtile"}
BAND = {"k1": raster.K1_BAND, "k7": raster.K7_BAND, "k8": raster.K8_BAND}


def _coef(kernel, args):
    return args[5] if kernel == "k8" else args[4]


def _visits(kernel, args):
    """-> (first triangle, group size, tile index, tile py0, 32-px column
    x0s of the visit, first row, row count, K7's brick offset or None) per
    visit, in queue order."""
    c = args[-1]
    tri0, cs, py0, cols, r0, nrows, xoff = raster.kernel_visits(
        NAME[kernel], args)
    tile = (py0 // c.tile_h) * c.tiles_x + cols[:, 0] // c.tile_w
    return tri0, cs, tile, py0, cols, r0, nrows, xoff


def _blocks(kernel, args):
    """Each block's visit pieces as the kernel walks them: per (tile,
    column, band) in block order, the visits meeting the band in queue
    order -> (visit, x0, first row, row count)."""
    c = args[-1]
    tri0, cs, tile, py0, cols, r0, nrows, _ = _visits(kernel, args)
    band = BAND[kernel]
    item, b, lo, n = raster.band_split(r0, nrows, band)
    x0 = cols[item]                                  # (pieces, columns)
    n_col = x0.shape[1]
    item, b, lo, n = (v.repeat_interleave(n_col) for v in (item, b, lo, n))
    x0 = x0.reshape(-1)
    col = x0 % c.tile_w // 32
    n_bands = -(-c.tile_h // band)
    block = (tile[item] * (c.tile_w // 32) + col) * n_bands + b
    order = torch.sort(block, stable=True).indices
    return block[order], item[order], x0[order], lo[order], n[order]


# tile_h is a multiple of 8 (RasterConfig), so every tile holds whole
# bands of every kernel; the windows' rows cross band edges everywhere. K7's
# row groups of 4*sub_s (16, 32) span 2 or 4 of its 8-row bands, and it
# ignores rp
CASES = [("k1", "random", True, 24, 8, 0, False),
         ("k1", "imbalance", False, 16, 8, 0, False),
         ("k1", "straddle", True, 48, 4, 0, True),      # groups of 4 rows
         ("k1", "ties", True, 24, 8, 24, False),        # rp 24: whole tile
         ("k1", "negative", False, 24, 2, 0, True),     # 64-tri groups
         ("k8", "random", True, 24, 8, 0, False),
         ("k8", "straddle", False, 72, 8, 0, False),    # 9 bands a tile
         ("k8", "ties", True, 40, 8, 0, False),
         ("k8", "imbalance", True, 24, 8, 0, False),
         ("k7", "random", True, 32, 8, 0, False),
         ("k7", "imbalance", False, 16, 4, 0, True),
         ("k7", "straddle", True, 48, 4, 0, True),      # groups of 16 rows
         ("k7", "ties", True, 32, 8, 16, False),
         ("k7", "negative", False, 64, 8, 0, True)]


# the cases this file evaluates; K8's (the slowest to evaluate block by
# block) run in tests/test_torch_raster_bands_k8.py, so that a run that
# spreads test files over workers evaluates them beside the others
FILE_CASES = [c for c in CASES if c[0] != "k8"]


def _case_id(p):
    return "-".join(map(str, p))


def make_case(param):
    kernel, scene, attrs, tile_h, sub_s, rp, zclip = param
    return kernel, band_inputs(torch.device("cpu"), kernel, scene, attrs,
                               tile_h, sub_s, rp, zclip)


@pytest.fixture(params=FILE_CASES, ids=_case_id)
def case(request):
    return make_case(request.param)


def test_bands_cover_each_visit_once_in_queue_order(case):
    """Every (visit, pixel row, column) of the plain visit list lies in
    exactly one block, and each pixel sees its visits in queue order."""
    kernel, args = case
    c = args[-1]
    tri0, cs, tile, py0, cols, r0, nrows, _ = _visits(kernel, args)
    assert nrows.numel() > 0 and bool((nrows > 0).all())
    # the whole list: per (pixel row, column) its visits in queue order
    it, row = raster._expand_rows(r0, nrows)
    x0 = cols[it]
    n_col = x0.shape[1]
    full = torch.stack([((py0[it] + row)[:, None] * 4096 + x0).reshape(-1),
                        it.repeat_interleave(n_col)], 1)
    order = torch.sort(full[:, 0], stable=True).indices
    full = full[order]
    # the blocks: their pieces, walked block by block
    block, item, bx0, lo, n = _blocks(kernel, args)
    for blk in torch.unique(block):            # queue order inside a block
        assert bool((torch.diff(item[block == blk]) > 0).all())
    band = BAND[kernel]
    assert bool((lo // band == (lo + n - 1) // band).all())
    pi, prow = raster._expand_rows(lo, n)
    pieces = torch.stack([(py0[item[pi]] + prow) * 4096 + bx0[pi],
                          item[pi]], 1)
    order = torch.sort(pieces[:, 0], stable=True).indices
    assert torch.equal(pieces[order], full)
    assert int(n.sum()) == int(nrows.sum()) * n_col


def _bits(planes):
    return [p.contiguous().view(torch.int32) for p in planes]


def test_block_by_block_evaluation_equals_plain(case):
    """_eval_items over each block's pieces, block after block, gives the
    plain version's planes bit for bit."""
    kernel, args = case
    c = args[-1]
    n_attr = 5 if c.with_attrs else 0
    tri0, cs, tile, py0, cols, r0, nrows, xoff = _visits(kernel, args)
    if kernel == "k8":
        seeds, zc = args[6], None
        ref = raster.raster_subtile_plain(*args)
    else:
        seeds, zc = args[5], args[6]
        ref = (raster.raster_tiles_plain if kernel == "k1" else
               raster.raster_bricks_plain)(*args)
    block, item, bx0, lo, n = _blocks(kernel, args)
    planes = list(seeds)
    for blk in torch.unique(block):
        sel = block == blk
        it, row = raster._expand_rows(lo[sel], n[sel])
        items = item[sel][it]
        planes = raster._eval_items(
            _coef(kernel, args), planes, zc, n_attr, tri0[items], cs,
            bx0[sel][it], 32, py0[items] + row,
            xoff=None if xoff is None else xoff[items])
    for got, want in zip(_bits(planes), _bits(ref)):
        assert torch.equal(got, want)
    assert float((ref[0] > 0).float().mean()) > 0.1


def _corner_cull(coef, x_lo, y_lo, y_hi, xoff=None):
    """raster.corner_cull of every edge for one 32-column rectangle: per
    triangle row of `coef` (float32 (T, 15)), True where some edge's plane
    is < 0 on the whole rectangle."""
    f = lambda v: torch.tensor(float(v))
    out = torch.zeros(coef.shape[0], dtype=torch.bool)
    for k in range(3):
        out |= raster.corner_cull(coef[:, k], coef[:, 5 + k],
                                  coef[:, 10 + k], f(x_lo), f(y_lo), f(y_hi),
                                  None if xoff is None else f(xoff))
    return out


@pytest.mark.parametrize("kernel,scene", [("k1", "random"), ("k8", "random"),
                                          ("k8", "straddle"),
                                          ("k1", "ties"), ("k7", "random"),
                                          ("k7", "straddle"),
                                          ("k7", "ties")])
def test_corner_cull_skips_only_uncovered_triangles(kernel, scene):
    """For every warp rectangle a visit reaches (32 columns x the rows of
    a thread group it visits), a triangle the corner test skips has
    l0, l1, l2 >= 0 at no pixel of it, brute force in the kernel's
    association (K7's: (a*xl + b*yl) + (b*yb + (c + a*xoff))); the test
    skips most of them, and raster.cull_tests counts the pixel tests and
    cull evaluations left."""
    args = band_inputs(torch.device("cpu"), kernel, scene, False,
                       {"k1": 24, "k7": 32, "k8": 40}[kernel])
    coef = raster.bits_f32(_coef(kernel, args))
    tri0, cs, tile, py0, cols, r0, nrows, xoff = _visits(kernel, args)
    item, b, lo, n = raster.band_split(r0, nrows, raster.WARP_ROWS)
    skipped = total = tests = 0
    for i in range(item.numel()):
        v = int(item[i])
        tri = coef[int(tri0[v]):int(tri0[v]) + cs, :15]
        ys = (py0[v] + lo[i] + torch.arange(int(n[i]))).float()
        y_lo, y_hi = ys[0], ys[-1]
        xo = None if xoff is None else int(xoff[v])
        for x0 in cols[v].tolist():
            cull = _corner_cull(tri, float(x0), y_lo, y_hi, xo)
            yy = ys[None, :, None]
            hit = torch.ones((tri.shape[0], ys.numel(), 32), dtype=torch.bool)
            for k in range(3):
                a, bb, cc = (tri[:, j][:, None, None]
                             for j in (k, 5 + k, 10 + k))
                if xo is None:
                    px = (x0 + torch.arange(32)).float()[None, None, :]
                    hit &= (a * px + (bb * yy + cc)) >= 0
                else:
                    xl = (x0 - xo + torch.arange(32)).float()[None, None, :]
                    yl = yy % 4
                    hit &= ((a * xl + bb * yl) +
                            (bb * (yy - yl) + (cc + a * float(xo)))) >= 0
            cov = hit.flatten(1).any(1)
            assert not bool((cull & cov).any())
            skipped += int(cull.sum())
            total += cull.numel()
            tests += int((~cull).sum()) * ys.numel() * 32
    assert skipped > total // 2
    assert raster.cull_tests(_coef(kernel, args), tri0, cs, py0, cols, r0,
                             nrows, xoff=xoff, chunk=7) == (tests, total)
