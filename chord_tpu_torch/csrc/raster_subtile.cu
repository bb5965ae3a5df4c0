// Kernel K8: sub-tile raster over the round-grouped work queue.
//
// Replaces chord_tpu/ops/raster.py::_raster_tile_kernel_st (:1233, driven
// by raster_queue_subtile :1366). The function is
// chord_tpu_torch/ops/raster.py raster_subtile_plain: the work queue
// (bin_windows_subtile) groups each 128-px screen tile's pairs into rounds
// of four windows, one per 32-px sub-tile; per round and sub-tile whose
// window is not the poison window, every row of the round's union y range
// is tested against the window's 128 triangles (_subtile_groups). Per
// pixel the group's result (max depth, max payload at it, NaN-propagating
// max of the attributes at it, with the non-winners' fill) replaces the
// accumulator when deeper, or as deep with a larger payload.
//
// What bounds it on the H100: the edge tests the corner cull leaves, about
// 3% of the visit list's (raster.cull_tests; 0.038 ms at the f32 peak on
// the flat frame at 1080p, where every test, 128 triangles x 21 flops per
// (row, sub-tile) visit, would take 1.24 ms, and under -fmad=false twice
// that at perfect issue), and the spread of the rounds over tiles: one
// tile of the flat frame holds 267 rounds, the median tile 9. The
// previous design ran one 512-thread block per (tile, sub-tile), 300
// blocks at 1080p of which 264 fit at once, walked every round through a
// two-barrier 16 KB staging and tested every triangle at every pixel:
// 23.5-24.9 ms.
//
// This design (the shared core in raster_core.cuh):
// - One block of 4 warps per (tile, sub-tile, band of kBand = 8 rows):
//   warp w owns the sub-tile's 32 columns, one per lane, and band rows
//   2w, 2w+1 in registers. At 1080p (216-row tiles) that is 75 x 4 x 27 =
//   8,100 blocks. The band: chip_smoke's per-tile stats (`work
//   raster_subtile` lines) put the row visits per block at 12.3x to 12.8x
//   their mean for every band from 8 to 48 rows: the heavy tile's rounds
//   span most of its rows whatever the band. What the rows per thread set
//   is each step's serial chain: 8, 4, 2 and 1 rows ran the flat frame in
//   2.68, 1.39, 1.09 and 1.21-1.25 ms (H100, chip_smoke; PERF.md §6).
// - The block lists the rounds whose slot holds a window and whose union
//   meets its band (a block-wide ballot compaction), then walks them 32
//   triangles a step with the staging ring, the corner cull and the
//   per-pixel test of raster_core.cuh. The cull is what removes most of
//   the work: a round's window spreads over ~128 rows, a warp's rectangle
//   is 32 x 2 px.
// - Accumulators in registers; each output plane is written once.
// raster.band_split (ops/raster.py) is the band rule in Python
// (tests/test_torch_raster_bands.py holds it to the plain version).
//
// Why the bits still equal raster_subtile_plain: each pixel sees the same
// rounds in the same order, every value is computed with the plain
// version's expression and association under -fmad=false, and a culled
// triangle is one that fails l0, l1, l2 >= 0 at every pixel of the warp's
// rows.

#include "raster_core.cuh"

namespace {

using namespace chord_raster;

constexpr int kRows = 2;     // rows per thread
constexpr int kWarps = 4;    // warps per block, stacked down the band
constexpr int kBand = kRows * kWarps;
constexpr int kSubTiles = 4;
constexpr int kSubW = kWindow / kSubTiles;

// K8's visits of one (tile, sub-tile) (_subtile_groups): candidate j is
// round start + j.
struct RoundQueue {
  const int* gwin;
  const int* y0r;
  const int* y1r;
  int start, count, sub, poison, py0, tile_h;

  __device__ int size() const { return count; }

  __device__ bool visit(int j, int2* v) const {
    const int rid = start + j;
    const int win = gwin[rid * kSubTiles + sub];
    const int y0 = min(max(y0r[rid] - py0, 0), tile_h);
    const int y1 = min(max(y1r[rid] + 1 - py0, 0), tile_h);
    if (win == poison || y1 <= y0) return false;
    *v = make_int2(win * kWindow, (y0 << 16) | y1);
    return true;
  }
};

template <bool ATTR>
__global__ void __launch_bounds__(32 * kWarps, kMinBlocks)
raster_subtile_kernel(const int* __restrict__ gwin,
                      const int* __restrict__ starts,
                      const int* __restrict__ counts,
                      const int* __restrict__ y0r,
                      const int* __restrict__ y1r,
                      const int* __restrict__ coef, int poison,
                      const float* __restrict__ seed_depth,
                      const int* __restrict__ seed_vis,
                      const float* __restrict__ seed_attr,
                      float* __restrict__ depth, int* __restrict__ vis,
                      float* __restrict__ attr, int tiles_x, int tile_h,
                      int w_pad, int h_pad) {
  const int tile = blockIdx.x / kSubTiles;
  const int sub = blockIdx.x % kSubTiles;
  const int py0 = (tile / tiles_x) * tile_h;
  const int px0 = (tile % tiles_x) * kWindow;
  const int x0 = px0 + sub * kSubW;
  const RoundQueue q{gwin, y0r,    y1r, starts[tile], counts[tile],
                     sub,  poison, py0, tile_h};
  raster_band<kRows, 1, kWarps, ATTR, false, PlanesXY>(
      q, kWindow, coef, seed_depth, seed_vis, seed_attr, nullptr, depth, vis,
      attr, py0, px0, x0, blockIdx.y * kBand, w_pad, (size_t)h_pad * w_pad);
}

}  // namespace

extern "C" int chord_raster_subtile(
    const void* gwin, const void* starts, const void* counts,
    const void* y0r, const void* y1r, const void* coef, int poison,
    const void* seed_depth, const void* seed_vis, const void* seed_attr,
    void* depth, void* vis, void* attr, int n_tiles, int tiles_x, int tile_h,
    int w_pad, int n_attr, void* stream) {
  if (n_tiles <= 0) return 0;
  if (tile_h % kBand != 0) return (int)cudaErrorInvalidValue;   // whole bands
  const int h_pad = (n_tiles / tiles_x) * tile_h;
  const dim3 grid(n_tiles * kSubTiles, tile_h / kBand);
  const cudaStream_t st = (cudaStream_t)stream;
  auto* kernel = n_attr ? raster_subtile_kernel<true>
                        : raster_subtile_kernel<false>;
  kernel<<<grid, 32 * kWarps, 0, st>>>(
      (const int*)gwin, (const int*)starts, (const int*)counts,
      (const int*)y0r, (const int*)y1r, (const int*)coef, poison,
      (const float*)seed_depth, (const int*)seed_vis,
      (const float*)seed_attr, (float*)depth, (int*)vis, (float*)attr,
      tiles_x, tile_h, w_pad, h_pad);
  return (int)cudaGetLastError();
}

// The band height and the rows a thread holds, for the Python side's
// mirror (raster.K8_BAND, raster.WARP_ROWS).
extern "C" int chord_raster_subtile_band() { return kBand; }
extern "C" int chord_raster_subtile_rows() { return kRows; }
