// Kernel K1: tiled visibility-buffer raster over the binned work queue.
//
// Replaces chord_tpu/ops/raster.py::_raster_tile_kernel (:488) and its
// _raster_subwindow_body (:632), run by raster_queue (:1028). The function
// is chord_tpu_torch/ops/raster.py raster_tiles_plain: per screen tile
// (tile_h x 128 px) the tile's pairs in queue order; per pair the S
// subwindows of 128/S triangles whose x range meets the tile, each on the
// rows of its y range rounded out to rp-row groups (_groups), on all 128
// columns of the tile. Per pixel a group's result (max depth, max payload
// at it, NaN-propagating max of the attributes at it, with the
// non-winners' fill) replaces the accumulator when deeper, or as deep with
// a larger payload.
//
// What bounds it on the H100: the bytes it must move (queue,
// coefficients, seed and output planes: 0.029 ms at the memory rate for
// the `off` frame's main phase 0), ahead of the edge tests the corner
// cull leaves (raster.cull_tests; every test of the visit list, 16
// triangles x 21 flops per pixel and subwindow row visit, would take
// 0.085 ms at the f32 peak, and under -fmad=false twice that at perfect
// issue); and latency: each pixel's visits run in queue order, and one
// tile can hold 5x the mean tile's pairs. The previous design ran one
// 512-thread block per tile (40 blocks at 720p on 132 SMs), staged each
// pair's 16 KB coefficient block between two barriers, tested every
// triangle at every pixel and read-modified-wrote the output planes per
// visit: 9.7-10.1 ms.
//
// This design (the shared core in raster_core.cuh):
// - One block of 4 warps per (tile, band of kRows = 2 rows): warp w owns
//   the tile's 32-px column brick w, one column per lane, and the band's
//   2 rows in registers (216-row main tiles: 108 bands, 4,320 blocks at
//   720p; 128-row cascade tiles: 64 bands, 4,096 blocks at 1024^2). The
//   4 bricks share one visit list, as K1's x gate is per tile. The band:
//   chip_smoke's per-tile stats (`work raster` lines) put the `off`
//   frame's main phase 0 at 1 to 184 pairs per tile (median 22) and the
//   row visits per block at 4.4x to 6.4x their mean for every band from 8
//   to 72 rows: the spread is between tiles, so no band evens it out.
//   What the band sets is a visit's serial chain in the heaviest blocks:
//   8-, 4- and 2-row bands ran phase 0 in 0.69, 0.40 and 0.35 ms, 1 row in
//   0.37 (H100, chip_smoke; PERF.md §6).
// - The block lists the (pair, subwindow) groups whose rows meet its band
//   (a block-wide ballot compaction of the tile's candidates), then walks
//   the list with the staging ring, the corner cull and the per-pixel test
//   of raster_core.cuh.
// - Accumulators in registers; each output plane is written once.
// raster.band_split (ops/raster.py) is the band rule in Python
// (tests/test_torch_raster_bands.py holds it to the plain version).
//
// Why the bits still equal raster_tiles_plain: each pixel sees the same
// groups in the same order (the bands partition the tile's rows, the
// bricks its columns), every value is computed with the plain version's
// expression and association under -fmad=false, and a culled triangle is
// one that fails l0, l1, l2 >= 0 at every pixel of the warp's rows.

#include "raster_core.cuh"

namespace {

using namespace chord_raster;

constexpr int kRows = 2;    // rows per thread (= the band)
constexpr int kBricks = 4;  // 32-px column bricks per tile: warps per block

// K1's visits of one tile (_groups): candidate g = pair g / S, subwindow
// g % S.
struct TileQueue {
  const int* pair_win;
  const int* sb;
  int nsb, start, count, sub_s, cs, rp, py0, px0, tile_h;

  __device__ int size() const { return count * sub_s; }

  __device__ bool visit(int g, int2* v) const {
    const int j = g / sub_s, s = g - j * sub_s;
    const int win = pair_win[start + j];
    const int base = win * sub_s + s;
    const int y0 = min(max(sb[base] - py0, 0), tile_h);
    const int y1 = min(max(sb[nsb + base] + 1 - py0, 0), tile_h);
    const bool xok = (sb[3 * nsb + base] >= px0) &&
                     (sb[2 * nsb + base] < px0 + kWindow);
    if (!xok || y1 <= y0) return false;
    const int r0 = (y0 / rp) * rp;
    const int r1 = ((y1 + rp - 1) / rp) * rp;
    *v = make_int2(win * kWindow + s * cs, (r0 << 16) | r1);
    return true;
  }
};

template <bool ATTR, bool ZCLIP>
__global__ void __launch_bounds__(32 * kBricks, kMinBlocks)
raster_tiles_kernel(const int* __restrict__ pair_win,
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
                    int w_pad, int h_pad, int sub_s, int rp) {
  const int tile = blockIdx.x;
  const int py0 = (tile / tiles_x) * tile_h;
  const int px0 = (tile % tiles_x) * kWindow;
  const int cs = kWindow / sub_s;
  const TileQueue q{pair_win, sb,     nsb, starts[tile], counts[tile],
                    sub_s,    cs,     rp,  py0,          px0,
                    tile_h};
  raster_band<kRows, kBricks, 1, ATTR, ZCLIP, PlanesXY>(
      q, cs, coef, seed_depth, seed_vis, seed_attr, zclip, depth, vis, attr,
      py0, px0, px0, blockIdx.y * kRows, w_pad, (size_t)h_pad * w_pad);
}

template <bool ATTR, bool ZCLIP>
void launch(dim3 grid, cudaStream_t st, const void* pair_win,
            const void* starts, const void* counts, const void* sb, int nsb,
            const void* coef, const void* seed_depth, const void* seed_vis,
            const void* seed_attr, const void* zclip, void* depth, void* vis,
            void* attr, int tiles_x, int tile_h, int w_pad, int h_pad,
            int sub_s, int rp) {
  raster_tiles_kernel<ATTR, ZCLIP><<<grid, 32 * kBricks, 0, st>>>(
      (const int*)pair_win, (const int*)starts, (const int*)counts,
      (const int*)sb, nsb, (const int*)coef, (const float*)seed_depth,
      (const int*)seed_vis, (const float*)seed_attr, (const float*)zclip,
      (float*)depth, (int*)vis, (float*)attr, tiles_x, tile_h, w_pad, h_pad,
      sub_s, rp);
}

}  // namespace

extern "C" int chord_raster_tiles(
    const void* pair_win, const void* starts, const void* counts,
    const void* sub_bounds, int nsb, const void* coef, const void* seed_depth,
    const void* seed_vis, const void* seed_attr, const void* zclip,
    void* depth, void* vis, void* attr, int n_tiles, int tiles_x, int tile_h,
    int w_pad, int sub_s, int rp, int n_attr, void* stream) {
  if (n_tiles <= 0) return 0;
  // whole bands, and rows rounded out to rp stay inside the tile
  if (tile_h % kRows != 0 || rp <= 0 || tile_h % rp != 0)
    return (int)cudaErrorInvalidValue;
  const int h_pad = (n_tiles / tiles_x) * tile_h;
  const dim3 grid(n_tiles, tile_h / kRows);
  const cudaStream_t st = (cudaStream_t)stream;
  auto* fn = n_attr ? (zclip ? launch<true, true> : launch<true, false>)
                    : (zclip ? launch<false, true> : launch<false, false>);
  fn(grid, st, pair_win, starts, counts, sub_bounds, nsb, coef, seed_depth,
     seed_vis, seed_attr, zclip, depth, vis, attr, tiles_x, tile_h, w_pad,
     h_pad, sub_s, rp);
  return (int)cudaGetLastError();
}

// The band height, for the Python side's mirror (raster.K1_BAND).
extern "C" int chord_raster_tiles_band() { return kRows; }
