// Kernel K7: brick-visit raster over the binned work queue.
//
// Replaces chord_tpu/ops/raster.py::_raster_tile_kernel_bricks (:740, run
// by raster_queue :1028 when RasterConfig.bricks). It computes K1's
// function on the same (tile, window) pairs but visits less: per
// subwindow of 128/S triangles it evaluates only the 32-px x-bricks of the
// tile that the subwindow's x range overlaps, in row groups of 4*S rows
// (from y0 // (4*S) to ceil(y1 / (4*S))). The Pallas kernel folds a 4-row
// x 32-px brick into one vector row (bricks_pack / bricks_unpack); the
// planes here stay linear, and what is kept of the TPU design is what
// changes results at a razor edge: the visited rows and bricks, and the
// plane association
//   l = (a*xl + b*yl) + (b*yb + (c + a*xoff)),
// where xoff = 32*bx is the brick's offset in the tile, xl = x - xoff (the
// tile's x origin plus the lane), yl = y mod 4 and yb = y - yl; an
// attribute is ((aa*xl + ab*yl) + (ab*yb + (ac + aa*xoff))) / sum(l).
//
// One block per (screen tile, brick): 32 x 16 threads, thread (x, y) owns
// column x of the brick and every tile row congruent to y mod 16, so the
// output planes (seeded first) need no atomics. The block walks the
// tile's pairs in queue order, skips a pair none of whose subwindows
// reaches this brick (the test is uniform over the block), else stages
// the window's 128 x 32 coefficient block (16 KB) in shared memory and
// runs each subwindow that passes K7's gates. Per pixel and subwindow
// group: max depth (optionally z_clip-rejected per fragment), max payload
// at it, max attributes at it, merged as in K1.
//
// Bound, at the bench size, by the edge-function math: 128/S triangles x
// ~30 f32 ops per pixel-row visit; 160 blocks at 720p with 192-row tiles.
// Built with -fmad=false so every product and sum rounds as in the plain
// PyTorch version (chord_tpu_torch/ops/raster.py raster_bricks_plain):
// bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kWindow = 128;
constexpr int kCoef = 32;
constexpr int kBrickW = 32;
constexpr int kBrickH = 4;
constexpr int kRowThreads = 16;
constexpr float kNeg = -3e38f;

__device__ __forceinline__ float max_nan(float a, float b) {
  // torch.amax semantics: NaN propagates
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

struct SubRows {
  int r0, r1;   // tile rows [r0, r1) to visit, empty when r1 <= r0
};

// K7's gates for subwindow `base` in this tile and brick.
__device__ __forceinline__ SubRows sub_rows(const int* sb, int nsb, int base,
                                            int py0, int tile_px0, int bx0,
                                            int tile_h, int rows_it) {
  const int y0 = min(max(sb[base] - py0, 0), tile_h);
  const int y1 = min(max(sb[nsb + base] + 1 - py0, 0), tile_h);
  const int sx0 = sb[2 * nsb + base];
  const int sx1 = sb[3 * nsb + base];
  const bool xok_any = (sx1 >= tile_px0) && (sx0 < tile_px0 + kWindow);
  const bool xok = (sx1 >= bx0) && (sx0 < bx0 + kBrickW);
  SubRows r{0, 0};
  if (!(y1 > y0) || !xok_any || !xok) return r;
  const int p0 = y0 / rows_it;
  const int p1 = (y1 + rows_it - 1) / rows_it;
  if (p1 > p0) {
    r.r0 = p0 * rows_it;
    r.r1 = p1 * rows_it;
  }
  return r;
}

__global__ void __launch_bounds__(kBrickW * kRowThreads)
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
                     int w_pad, int h_pad, int sub_s, int n_attr) {
  __shared__ int sc[kWindow * kCoef];
  const int tile = blockIdx.x;
  const int bx = blockIdx.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kBrickW + tx;
  const int py0 = (tile / tiles_x) * tile_h;
  const int tile_px0 = (tile % tiles_x) * kWindow;
  const int bx0 = tile_px0 + bx * kBrickW;
  const int x = bx0 + tx;
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
  const int cs = kWindow / sub_s;
  const int rows_it = kBrickH * sub_s;
  const float pxl = (float)(tile_px0 + tx);
  const float xoff = (float)(bx * kBrickW);

  for (int j = 0; j < count; ++j) {
    const int win = pair_win[start + j];
    bool any = false;
    for (int s = 0; s < sub_s && !any; ++s) {
      const SubRows r = sub_rows(sb, nsb, win * sub_s + s, py0, tile_px0,
                                 bx0, tile_h, rows_it);
      any = r.r1 > r.r0;
    }
    if (!any) continue;   // uniform over the block
    __syncthreads();      // the previous pair's coefficients fully consumed
    const int* src = coef + (size_t)win * kWindow * kCoef;
    for (int q = tid; q < kWindow * kCoef; q += kBrickW * kRowThreads)
      sc[q] = src[q];
    __syncthreads();

    for (int s = 0; s < sub_s; ++s) {
      const SubRows r = sub_rows(sb, nsb, win * sub_s + s, py0, tile_px0,
                                 bx0, tile_h, rows_it);
      if (r.r1 <= r.r0) continue;
      const int first = r.r0 + ((ty - r.r0) % kRowThreads + kRowThreads) %
                                   kRowThreads;
      const int* grp = sc + s * cs * kCoef;
      for (int row = first; row < r.r1; row += kRowThreads) {
        const int yl_i = row % kBrickH;
        const float yl = (float)yl_i;
        const float yb = (float)(py0 + row - yl_i);
        const size_t p = (size_t)(py0 + row) * w_pad + x;
        const float zc = zclip ? zclip[p] : 0.0f;
        float best = 0.0f;
        int pay_sel = 0;
        int n_win = 0;   // triangles at the winning depth
        float sel[5] = {kNeg, kNeg, kNeg, kNeg, kNeg};
        for (int t = 0; t < cs; ++t) {
          const int* tc = grp + t * kCoef;
          float l[5];
          for (int k = 0; k < 5; ++k) {
            const float a = __int_as_float(tc[k]);
            const float b = __int_as_float(tc[5 + k]);
            const float c = __int_as_float(tc[10 + k]);
            l[k] = (a * pxl + b * yl) + (b * yb + (c + a * xoff));
          }
          const bool covered = (l[0] >= 0.0f) && (l[1] >= 0.0f) &&
                               (l[2] >= 0.0f) && (l[4] > 0.0f) &&
                               (l[3] > 0.0f) && (l[3] <= l[4]);
          float cand = covered ? l[3] / l[4] : 0.0f;
          if (zclip && !(cand < zc)) cand = 0.0f;
          if (!(cand > 0.0f) || cand < best) continue;
          float val[5];
          if (n_attr) {
            const float inv_s = 1.0f / ((l[0] + l[1]) + l[2]);
            for (int k = 0; k < 5; ++k) {
              const float aa = __int_as_float(tc[16 + 3 * k]);
              const float ab = __int_as_float(tc[17 + 3 * k]);
              const float ac = __int_as_float(tc[18 + 3 * k]);
              val[k] = ((aa * pxl + ab * yl) + (ab * yb + (ac + aa * xoff))) *
                       inv_s;
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
        if (n_win < cs) {
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
}

}  // namespace

extern "C" int chord_raster_bricks(
    const void* pair_win, const void* starts, const void* counts,
    const void* sub_bounds, int nsb, const void* coef, const void* seed_depth,
    const void* seed_vis, const void* seed_attr, const void* zclip,
    void* depth, void* vis, void* attr, int n_tiles, int tiles_x, int tile_h,
    int w_pad, int sub_s, int rp, int n_attr, void* stream) {
  (void)rp;   // K7 packs 4*sub_s rows per iteration whatever rp says
  if (n_tiles <= 0) return 0;
  const int h_pad = (n_tiles / tiles_x) * tile_h;
  dim3 grid(n_tiles, kWindow / kBrickW);
  dim3 block(kBrickW, kRowThreads);
  raster_bricks_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int*)pair_win, (const int*)starts, (const int*)counts,
      (const int*)sub_bounds, nsb, (const int*)coef,
      (const float*)seed_depth, (const int*)seed_vis,
      (const float*)seed_attr, (const float*)zclip, (float*)depth, (int*)vis,
      (float*)attr, tiles_x, tile_h, w_pad, h_pad, sub_s, n_attr);
  return (int)cudaGetLastError();
}
