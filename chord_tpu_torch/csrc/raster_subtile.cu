// Kernel K8: sub-tile raster over the round-grouped work queue.
//
// Replaces chord_tpu/ops/raster.py::_raster_tile_kernel_st (:1233, driven
// by raster_queue_subtile :1366). The work queue (bin_windows_subtile)
// groups each 128-px screen tile's pairs into rounds of four windows, one
// per 32-px sub-tile; a round's rows are the union of its four windows' y
// ranges. The Pallas kernel builds lane-grouped coefficient planes so one
// (128-triangle, 128-lane) pass serves all four windows; here each
// sub-tile is its own block, so no lanes are shared at all.
//
// One block per (screen tile, sub-tile): 32 x 16 threads, thread (x, y)
// owns column x of the sub-tile and every tile row congruent to y mod 16,
// so a pixel is only ever touched by one thread and the output planes
// (seeded first) need no atomics. The block walks its tile's rounds in
// order; a round whose slot holds the poison window (no window of this
// sub-tile) or whose union misses the tile is skipped, otherwise the
// window's 128 x 32 coefficient block (16 KB) is staged in shared memory
// and every row of the union is evaluated against all 128 triangles, with
// K1's plane association l = a*px + (b*y + c). Per pixel the group is the
// whole window: its max depth, the max payload (signed int32) among the
// triangles at that depth and, with attributes, the elementwise max of
// their 5 perspective-correct attributes, merged into the accumulator
// when deeper, or as deep with a larger payload.
//
// Bound, at the flat frame's size, by the edge-function math: 128
// triangles x ~30 f32 ops per pixel-row visit; 300 blocks at 1080p (75
// tiles x 4). Built with -fmad=false so every product and sum rounds as in
// the plain PyTorch version (chord_tpu_torch/ops/raster.py
// raster_subtile_plain): bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kWindow = 128;
constexpr int kCoef = 32;
constexpr int kSubW = 32;
constexpr int kSubTiles = 4;
constexpr int kRowThreads = 16;
constexpr float kNeg = -3e38f;

__device__ __forceinline__ float max_nan(float a, float b) {
  // torch.amax semantics: NaN propagates
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

__global__ void __launch_bounds__(kSubW * kRowThreads)
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
                      int w_pad, int h_pad, int n_attr) {
  __shared__ int sc[kWindow * kCoef];
  const int tile = blockIdx.x;
  const int sub = blockIdx.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kSubW + tx;
  const int py0 = (tile / tiles_x) * tile_h;
  const int x = (tile % tiles_x) * kWindow + sub * kSubW + tx;
  const size_t plane = (size_t)h_pad * w_pad;

  for (int row = ty; row < tile_h; row += kRowThreads) {
    const size_t p = (size_t)(py0 + row) * w_pad + x;
    depth[p] = seed_depth[p];
    vis[p] = seed_vis[p];
    for (int k = 0; k < n_attr; ++k)
      attr[k * plane + p] = seed_attr[k * plane + p];
  }

  const int count = counts[tile];
  const int start = starts[tile];
  const float px = (float)x;

  for (int j = 0; j < count; ++j) {
    const int rid = start + j;
    const int win = gwin[rid * kSubTiles + sub];
    const int y0 = min(max(y0r[rid] - py0, 0), tile_h);
    const int y1 = min(max(y1r[rid] + 1 - py0, 0), tile_h);
    if (win == poison || y1 <= y0) continue;   // uniform over the block
    __syncthreads();   // the previous round's coefficients fully consumed
    const int* src = coef + (size_t)win * kWindow * kCoef;
    for (int q = tid; q < kWindow * kCoef; q += kSubW * kRowThreads)
      sc[q] = src[q];
    __syncthreads();

    const int first = y0 + ((ty - y0) % kRowThreads + kRowThreads) %
                               kRowThreads;
    for (int row = first; row < y1; row += kRowThreads) {
      const float yf = (float)(py0 + row);
      const size_t p = (size_t)(py0 + row) * w_pad + x;
      float best = 0.0f;
      int pay_sel = 0;
      int n_win = 0;   // triangles at the winning depth
      float sel[5] = {kNeg, kNeg, kNeg, kNeg, kNeg};
      for (int t = 0; t < kWindow; ++t) {
        const int* tc = sc + t * kCoef;
        float l[5];
        for (int k = 0; k < 5; ++k) {
          const float a = __int_as_float(tc[k]);
          const float b = __int_as_float(tc[5 + k]);
          const float c = __int_as_float(tc[10 + k]);
          l[k] = a * px + (b * yf + c);
        }
        const bool covered = (l[0] >= 0.0f) && (l[1] >= 0.0f) &&
                             (l[2] >= 0.0f) && (l[4] > 0.0f) &&
                             (l[3] > 0.0f) && (l[3] <= l[4]);
        const float cand = covered ? l[3] / l[4] : 0.0f;
        if (!(cand > 0.0f) || cand < best) continue;
        float val[5];
        if (n_attr) {
          const float inv_s = 1.0f / ((l[0] + l[1]) + l[2]);
          for (int k = 0; k < 5; ++k) {
            const float aa = __int_as_float(tc[16 + 3 * k]);
            const float ab = __int_as_float(tc[17 + 3 * k]);
            const float ac = __int_as_float(tc[18 + 3 * k]);
            val[k] = (aa * px + (ab * yf + ac)) * inv_s;
          }
        }
        if (cand > best) {   // a new maximum: earlier winners are out
          best = cand;
          n_win = 1;
          pay_sel = tc[15];
          if (n_attr)
            for (int k = 0; k < 5; ++k) sel[k] = val[k];
        } else {             // a tie at the winning depth
          ++n_win;
          pay_sel = max(pay_sel, tc[15]);
          if (n_attr)
            for (int k = 0; k < 5; ++k) sel[k] = max_nan(sel[k], val[k]);
        }
      }
      // the group max also runs over the non-winners' fill (0, kNeg)
      if (n_win < kWindow) {
        pay_sel = max(pay_sel, 0);
        for (int k = 0; k < 5; ++k) sel[k] = max_nan(sel[k], kNeg);
      }
      const float acc_d = depth[p];
      const int acc_v = vis[p];
      if (best > acc_d || (best == acc_d && pay_sel > acc_v)) {
        depth[p] = best;
        vis[p] = pay_sel;
        for (int k = 0; k < n_attr; ++k) attr[k * plane + p] = sel[k];
      }
    }
  }
}

}  // namespace

extern "C" int chord_raster_subtile(
    const void* gwin, const void* starts, const void* counts,
    const void* y0r, const void* y1r, const void* coef, int poison,
    const void* seed_depth, const void* seed_vis, const void* seed_attr,
    void* depth, void* vis, void* attr, int n_tiles, int tiles_x, int tile_h,
    int w_pad, int n_attr, void* stream) {
  if (n_tiles <= 0) return 0;
  const int h_pad = (n_tiles / tiles_x) * tile_h;
  dim3 grid(n_tiles, kSubTiles);
  dim3 block(kSubW, kRowThreads);
  raster_subtile_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int*)gwin, (const int*)starts, (const int*)counts,
      (const int*)y0r, (const int*)y1r, (const int*)coef, poison,
      (const float*)seed_depth, (const int*)seed_vis,
      (const float*)seed_attr, (float*)depth, (int*)vis, (float*)attr,
      tiles_x, tile_h, w_pad, h_pad, n_attr);
  return (int)cudaGetLastError();
}
