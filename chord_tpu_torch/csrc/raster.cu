// Kernel K1: tiled visibility-buffer raster over the binned work queue.
//
// Replaces chord_tpu/ops/raster.py::_raster_tile_kernel (:488) and its
// _raster_subwindow_body (:632). One block per screen tile (tile_h x 128
// pixels), 128 x 4 threads: thread (x, y) owns column x and every row
// congruent to y mod 4 of the tile, so a pixel is only ever touched by one
// thread and the accumulators (the output planes, seeded first) need no
// atomics. The block walks the tile's pairs in queue order; per pair it
// stages the window's 128 x 32 coefficient block (16 KB) in shared memory,
// then walks the S subwindows of 128/S triangles, skipping those whose x
// range misses the tile and visiting only the rows of the subwindow's y
// bounds, rounded out to rp-row groups exactly as the Pallas row packing
// does.
//
// Per pixel and subwindow group: each triangle's edge functions
// l = a*px + (b*y + c), depth z = N/D where covered (l0,l1,l2 >= 0,
// D > 0, 0 < N <= D), optional z_clip rejection; the group's result is the
// max depth, the max payload (signed int32) among the triangles at that
// depth, and the elementwise max of their 5 perspective-correct attributes.
// It replaces the accumulator when its depth is greater, or equal with a
// larger payload (reverse-Z, deterministic ties).
//
// Bound, at the bench size, by the edge-function math: ~16 triangles x ~30
// f32 ops per pixel-row visit of each subwindow; only 40 blocks at 720p
// (132 SMs), which a tuned version can split. Built with -fmad=false so every
// product and sum rounds as in the plain PyTorch version
// (chord_tpu_torch/ops/raster.py raster_tiles_plain): bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kWindow = 128;
constexpr int kCoef = 32;
constexpr int kRowsPerPass = 4;
constexpr float kNeg = -3e38f;

__device__ __forceinline__ float max_nan(float a, float b) {
  // jnp.max / torch.amax semantics: NaN propagates
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

__global__ void __launch_bounds__(kWindow * kRowsPerPass)
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
                    int w_pad, int h_pad, int sub_s, int rp, int n_attr) {
  __shared__ int sc[kWindow * kCoef];
  const int tile = blockIdx.x;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kWindow + tx;
  const int py0 = (tile / tiles_x) * tile_h;
  const int px0 = (tile % tiles_x) * kWindow;
  const size_t plane = (size_t)h_pad * w_pad;

  for (int row = ty; row < tile_h; row += kRowsPerPass) {
    size_t p = (size_t)(py0 + row) * w_pad + px0 + tx;
    depth[p] = seed_depth[p];
    vis[p] = seed_vis[p];
    for (int k = 0; k < n_attr; ++k) attr[k * plane + p] = seed_attr[k * plane + p];
  }

  const int count = counts[tile];
  const int start = starts[tile];
  const int cs = kWindow / sub_s;
  const float px = (float)(px0 + tx);
  const int* sy0 = sb;
  const int* sy1 = sb + nsb;
  const int* sx0 = sb + 2 * nsb;
  const int* sx1 = sb + 3 * nsb;

  for (int j = 0; j < count; ++j) {
    const int win = pair_win[start + j];
    __syncthreads();   // previous pair's coefficients fully consumed
    const int* src = coef + (size_t)win * kWindow * kCoef;
    for (int q = tid; q < kWindow * kCoef; q += kWindow * kRowsPerPass)
      sc[q] = src[q];
    __syncthreads();

    for (int s = 0; s < sub_s; ++s) {
      const int base = win * sub_s + s;
      int y0 = min(max(sy0[base] - py0, 0), tile_h);
      int y1 = min(max(sy1[base] + 1 - py0, 0), tile_h);
      const bool xok = (sx1[base] >= px0) && (sx0[base] < px0 + kWindow);
      if (!xok) y1 = 0;
      if (y1 <= y0) continue;
      const int r0 = (y0 / rp) * rp;
      const int r1 = ((y1 + rp - 1) / rp) * rp;
      const int first = r0 + ((ty - r0) % kRowsPerPass + kRowsPerPass) %
                                 kRowsPerPass;
      const int* grp = sc + s * cs * kCoef;
      for (int row = first; row < r1; row += kRowsPerPass) {
        const float yf = (float)(py0 + row);
        const size_t p = (size_t)(py0 + row) * w_pad + px0 + tx;
        const float zc = zclip ? zclip[p] : 0.0f;
        float best = 0.0f;
        int pay_sel = 0;
        int n_win = 0;   // triangles at the winning depth
        float sel[5] = {kNeg, kNeg, kNeg, kNeg, kNeg};
        for (int t = 0; t < cs; ++t) {
          const int* tc = grp + t * kCoef;
          float l[5];
          for (int k = 0; k < 5; ++k) {
            float a = __int_as_float(tc[k]);
            float b = __int_as_float(tc[5 + k]);
            float c = __int_as_float(tc[10 + k]);
            l[k] = a * px + (b * yf + c);
          }
          const bool covered = (l[0] >= 0.0f) && (l[1] >= 0.0f) &&
                               (l[2] >= 0.0f) && (l[4] > 0.0f) &&
                               (l[3] > 0.0f) && (l[3] <= l[4]);
          float cand = covered ? l[3] / l[4] : 0.0f;
          if (zclip && !(cand < zc)) cand = 0.0f;
          if (cand > best) {
            // a new maximum: earlier winners are out
            best = cand;
            n_win = 1;
            pay_sel = max(tc[15], 0);
            if (n_attr) {
              float inv_s = 1.0f / (l[0] + l[1] + l[2]);
              for (int k = 0; k < 5; ++k) {
                float aa = __int_as_float(tc[16 + 3 * k]);
                float ab = __int_as_float(tc[17 + 3 * k]);
                float ac = __int_as_float(tc[18 + 3 * k]);
                sel[k] = (aa * px + (ab * yf + ac)) * inv_s;
              }
            }
          } else if (cand == best && cand > 0.0f) {
            ++n_win;
            pay_sel = max(pay_sel, tc[15]);
            if (n_attr) {
              float inv_s = 1.0f / (l[0] + l[1] + l[2]);
              for (int k = 0; k < 5; ++k) {
                float aa = __int_as_float(tc[16 + 3 * k]);
                float ab = __int_as_float(tc[17 + 3 * k]);
                float ac = __int_as_float(tc[18 + 3 * k]);
                sel[k] = max_nan(sel[k], (aa * px + (ab * yf + ac)) * inv_s);
              }
            }
          }
        }
        // the group max also runs over the losers' kNeg fill
        if (n_win < cs)
          for (int k = 0; k < 5; ++k) sel[k] = max_nan(sel[k], kNeg);
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
}

}  // namespace

extern "C" int chord_raster_tiles(
    const void* pair_win, const void* starts, const void* counts,
    const void* sub_bounds, int nsb, const void* coef, const void* seed_depth,
    const void* seed_vis, const void* seed_attr, const void* zclip,
    void* depth, void* vis, void* attr, int n_tiles, int tiles_x, int tile_h,
    int w_pad, int sub_s, int rp, int n_attr, void* stream) {
  if (n_tiles <= 0) return 0;
  const int h_pad = (n_tiles / tiles_x) * tile_h;
  dim3 block(kWindow, kRowsPerPass);
  raster_tiles_kernel<<<n_tiles, block, 0, (cudaStream_t)stream>>>(
      (const int*)pair_win, (const int*)starts, (const int*)counts,
      (const int*)sub_bounds, nsb, (const int*)coef,
      (const float*)seed_depth, (const int*)seed_vis,
      (const float*)seed_attr, (const float*)zclip, (float*)depth, (int*)vis,
      (float*)attr, tiles_x, tile_h, w_pad, h_pad, sub_s, rp, n_attr);
  return (int)cudaGetLastError();
}
