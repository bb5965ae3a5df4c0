// Kernel K7: brick-visit raster over the binned work queue.
//
// Replaces chord_tpu/ops/raster.py::_raster_tile_kernel_bricks (:740, run
// by raster_queue :1028 when RasterConfig.bricks). The function is
// chord_tpu_torch/ops/raster.py raster_bricks_plain: K1's function on the
// same (tile, window) pairs with fewer visits and its own plane
// association. Per (pair, subwindow of 128/S triangles) it visits only the
// 32-px column bricks of the tile that the subwindow's x range overlaps,
// on the row groups of 4*S rows from y0 // (4*S) to ceil(y1 / (4*S))
// (_brick_groups). The Pallas kernel folds a 4-row x 32-px brick into one
// vector row; what is kept of it here is what decides results at a razor
// edge: the visited rows and bricks, and the association
//   l = (a*xl + b*yl) + (b*yb + (c + a*xoff)),
// where xoff = 32*bx is the brick's offset in the tile, xl = x - xoff (the
// tile's first column plus the lane), yl = y mod 4 and yb = y - yl; an
// attribute is ((aa*xl + ab*yl) + (ab*yb + (ac + aa*xoff))) / sum(l). Per
// pixel a group's result (max depth, z_clip-rejected per fragment, max
// payload at it, NaN-propagating max of the attributes at it, with the
// non-winners' fill) replaces the accumulator when deeper, or as deep
// with a larger payload.
//
// What bounds it on the H100: the bytes it must move (queue,
// coefficients, seed and output planes) and the edge tests the corner
// cull leaves (raster.cull_tests with K7's association; every test of the
// visit list, 16 triangles x 21 flops per pixel and visited row, would
// take 0.082 ms at the f32 peak for geo_tex_bricks' main phase 0, and
// under -fmad=false twice that at perfect issue); and latency: each
// pixel's visits run in queue order, and one tile holds several times the
// mean tile's pairs. The previous design ran one 512-thread block per
// (tile, brick), 160 blocks at 720p with 192-row tiles, walked every pair
// of its tile, staged each pair's whole 16 KB window between two barriers,
// tested every triangle at every visited pixel with all five planes before
// the coverage test, evaluated the attributes of every new or tied winner
// and read-modify-wrote the output planes per (subwindow, row): 2.471 ms
// for that phase 0 (H100 80GB HBM3 at 700 W, chip_smoke).
//
// This design (0.277 ms on that phase 0, 0.098 on the masked pass, beside
// the previous design's 2.446 and 0.586 in the same run): K1 and K8's core
// (raster_core.cuh) with K7's plane policy (PlanesBrick) and visit rule
// (BrickQueue).
// - One block of 4 warps per (tile, brick, band of kBand = 8 rows): warp
//   w owns the brick's 32 columns, one per lane, and band rows 2w, 2w+1 in
//   registers; at 720p with 192-row tiles, 40 x 4 x 24 = 3,840 blocks.
//   A band of 8 lies in one 4*S-row group (S >= 2), so its 4 warps walk
//   the same visits. K1's shape (4 bricks x 2 rows a block, one list with
//   a brick mask per visit, a warp idle at a visit outside its brick) ran
//   phase 0 in 0.411 ms against this shape's 0.277, the masked pass in
//   0.133 against 0.098 (H100 80GB HBM3 at 700 W, kernel_ab.py, both
//   designs in turns; PERF.md section 6).
// - The block lists, in queue order, its brick's (pair, subwindow) visits
//   whose rows meet the band (a block-wide ballot compaction), then walks
//   them with the staging ring, the per-warp corner cull in K7's
//   association (exact: a thread's 2 rows lie in one brick row, so the
//   corner is a pixel) and the deferred attribute merge of the core.
// - Accumulators in registers; each output plane is written once.
// raster.band_split with raster.K7_BAND is the band rule in Python
// (tests/test_torch_raster_bands.py holds it to the plain version).
//
// Why the bits still equal raster_bricks_plain: each pixel lies in one
// brick and one band and sees its brick's visits in queue order, every
// value is computed with the plain version's expression and association
// under -fmad=false, and a culled triangle is one that fails
// l0, l1, l2 >= 0 at every pixel of the warp's rows.

#include "raster_core.cuh"

namespace {

using namespace chord_raster;

constexpr int kRows = 2;     // rows per thread
constexpr int kWarps = 4;    // warps per block, stacked down the band
constexpr int kBand = kRows * kWarps;
constexpr int kBrickW = 32;
constexpr int kBrickH = 4;

// K7's visits of one (tile, brick) (_brick_groups): candidate g = pair
// g / S, subwindow g % S; rows rounded out to groups of 4*S.
struct BrickQueue {
  const int* pair_win;
  const int* sb;
  int nsb, start, count, sub_s, cs, py0, bx0, tile_h;

  __device__ int size() const { return count * sub_s; }

  __device__ bool visit(int g, int2* v) const {
    const int j = g / sub_s, s = g - j * sub_s;
    const int win = pair_win[start + j];
    const int base = win * sub_s + s;
    const int y0 = min(max(sb[base] - py0, 0), tile_h);
    const int y1 = min(max(sb[nsb + base] + 1 - py0, 0), tile_h);
    // the brick's x gate (it implies the tile's)
    const bool xok = (sb[3 * nsb + base] >= bx0) &&
                     (sb[2 * nsb + base] < bx0 + kBrickW);
    if (!xok || y1 <= y0) return false;
    const int rows = kBrickH * sub_s;
    const int r0 = (y0 / rows) * rows;
    const int r1 = ((y1 + rows - 1) / rows) * rows;
    *v = make_int2(win * kWindow + s * cs, (r0 << 16) | r1);
    return true;
  }
};

template <bool ATTR, bool ZCLIP>
__global__ void __launch_bounds__(32 * kWarps, kMinBlocks)
raster_bricks_kernel(const int* __restrict__ pair_win,
                     const int* __restrict__ starts,
                     const int* __restrict__ counts,
                     const int* __restrict__ sb, int nsb,
                     const int* __restrict__ coef,
                     const float* __restrict__ seed_depth,
                     const int* __restrict__ seed_vis,
                     const float* __restrict__ seed_attr,
                     const float* __restrict__ zclip,
                     float* __restrict__ depth, int* __restrict__ vis,
                     float* __restrict__ attr, int tiles_x, int tile_h,
                     int w_pad, int h_pad, int sub_s) {
  const int tile = blockIdx.x;
  const int py0 = (tile / tiles_x) * tile_h;
  const int px0 = (tile % tiles_x) * kWindow;
  const int bx0 = px0 + blockIdx.y * kBrickW;
  const int cs = kWindow / sub_s;
  const BrickQueue q{pair_win, sb, nsb, starts[tile], counts[tile],
                     sub_s,    cs, py0, bx0,         tile_h};
  raster_band<kRows, 1, kWarps, ATTR, ZCLIP, PlanesBrick>(
      q, cs, coef, seed_depth, seed_vis, seed_attr, zclip, depth, vis, attr,
      py0, px0, bx0, blockIdx.z * kBand, w_pad, (size_t)h_pad * w_pad);
}

template <bool ATTR, bool ZCLIP>
void launch(dim3 grid, cudaStream_t st, const void* pair_win,
            const void* starts, const void* counts, const void* sb, int nsb,
            const void* coef, const void* seed_depth, const void* seed_vis,
            const void* seed_attr, const void* zclip, void* depth, void* vis,
            void* attr, int tiles_x, int tile_h, int w_pad, int h_pad,
            int sub_s) {
  raster_bricks_kernel<ATTR, ZCLIP><<<grid, 32 * kWarps, 0, st>>>(
      (const int*)pair_win, (const int*)starts, (const int*)counts,
      (const int*)sb, nsb, (const int*)coef, (const float*)seed_depth,
      (const int*)seed_vis, (const float*)seed_attr, (const float*)zclip,
      (float*)depth, (int*)vis, (float*)attr, tiles_x, tile_h, w_pad, h_pad,
      sub_s);
}

}  // namespace

extern "C" int chord_raster_bricks(
    const void* pair_win, const void* starts, const void* counts,
    const void* sub_bounds, int nsb, const void* coef, const void* seed_depth,
    const void* seed_vis, const void* seed_attr, const void* zclip,
    void* depth, void* vis, void* attr, int n_tiles, int tiles_x, int tile_h,
    int w_pad, int sub_s, int rp, int n_attr, void* stream) {
  (void)rp;   // K7 rounds rows to 4*sub_s whatever rp says
  if (n_tiles <= 0) return 0;
  // whole bands, and rows rounded out to 4*sub_s stay inside the tile
  if (sub_s <= 0 || kWindow % sub_s != 0 || tile_h % kBand != 0 ||
      tile_h % (kBrickH * sub_s) != 0)
    return (int)cudaErrorInvalidValue;
  const int h_pad = (n_tiles / tiles_x) * tile_h;
  const dim3 grid(n_tiles, kWindow / kBrickW, tile_h / kBand);
  const cudaStream_t st = (cudaStream_t)stream;
  auto* fn = n_attr ? (zclip ? launch<true, true> : launch<true, false>)
                    : (zclip ? launch<false, true> : launch<false, false>);
  fn(grid, st, pair_win, starts, counts, sub_bounds, nsb, coef, seed_depth,
     seed_vis, seed_attr, zclip, depth, vis, attr, tiles_x, tile_h, w_pad,
     h_pad, sub_s);
  return (int)cudaGetLastError();
}

// The band height, for the Python side's mirror (raster.K7_BAND).
extern "C" int chord_raster_bricks_band() { return kBand; }
