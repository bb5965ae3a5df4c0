// Kernel K4: tile-local bilinear history reprojection.
//
// Replaces chord_tpu/ops/tile_reproject.py::_reproject_kernel (:55). The
// Pallas kernel DMAs a (48, 256) window per 32x128 output tile from
// edge-padded planes and folds the two lerps into one-hot selection
// matmuls. Here the kernel reads the history in its own (h, w, C) layout
// and writes the (h, w, C) output: the edge pad is folded into clamped
// coordinates (padded-plane row yp holds history row clamp(yp - MARGIN, 0,
// h-1), and likewise for columns), so no padded copy, permute or crop runs
// around it.
//
// Work split: a block per (32x128 output tile, strip of kRows rows); its
// 128*C threads cover the tile's 128 columns x C channels, thread k on
// column k / C and channel k % C, so a warp reads and writes 128
// contiguous bytes of the interleaved layout. Each thread walks its strip
// down one column, loading the kRows + 1 tap rows it needs once (the
// lower tap row of an output row is the upper one of the next), all
// loads issued before the first lerp. Bound: bytes, the history rows and
// columns the taps touch, read once, and the output written once; the
// second column tap and the strip's extra row are L1/L2 hits.
//
// Per tile the wrapper passes [y0p, x0p, fy_q, fx_q]: the sample start in
// padded-plane coordinates (clamped to [-MARGIN, hp - 1] x [-MARGIN,
// wp - 1] in history coordinates, hp x wp the size rounded up to whole
// tiles, then shifted by MARGIN) and the fractions in 1/1024 units,
// exactly as chord_tpu computes them outside its kernel. The lerps are
//   top = (1-fy) * P[y][x]   + fy * P[y+1][x]
//   bot = (1-fy) * P[y][x+1] + fy * P[y+1][x+1]
//   out = (1-fx) * top + fx * bot
// with every product and sum rounded separately: the library is built with
// -fmad=false so this matches the plain PyTorch version
// (chord_tpu_torch/ops/tile_reproject.py reproject_tiles_plain, which
// still reads the edge-padded planes) bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 128;
constexpr int kMargin = 128;
constexpr int kRows = 8;          // output rows a thread
constexpr int kMaxChannels = 8;   // 128 * C threads a block
constexpr float kInvFracQ = 1.0f / 1024.0f;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__global__ void __launch_bounds__(kTileW * kMaxChannels)
tile_reproject_kernel(const float* __restrict__ img,
                      const int* __restrict__ tab, int c_ch, int h, int w,
                      int wt, float* __restrict__ out) {
  const int t = blockIdx.x;
  const int j = threadIdx.x / c_ch;
  const int c = threadIdx.x - j * c_ch;
  const int x = (t % wt) * kTileW + j;
  const int y = (t / wt) * kTileH + blockIdx.y * kRows;
  if (x >= w || y >= h) return;
  const float fy = (float)tab[t * 4 + 2] * kInvFracQ;
  const float fx = (float)tab[t * 4 + 3] * kInvFracQ;
  const float gy = 1.0f - fy, gx = 1.0f - fx;
  // this strip's first tap row and this column's tap, in history coordinates
  const int sy = tab[t * 4 + 0] - kMargin + blockIdx.y * kRows;
  const int sx = tab[t * 4 + 1] - kMargin + j;
  const int row = w * c_ch;
  const int x0 = clampi(sx, 0, w - 1) * c_ch + c;
  const int x1 = clampi(sx + 1, 0, w - 1) * c_ch + c;
  float a[kRows + 1], b[kRows + 1];
#pragma unroll
  for (int i = 0; i <= kRows; ++i) {
    const float* r = img + clampi(sy + i, 0, h - 1) * row;
    a[i] = __ldg(r + x0);
    b[i] = __ldg(r + x1);
  }
  const int n = min(kRows, h - y);
  float* o = out + y * row + x * c_ch + c;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (i < n) {
      const float top = gy * a[i] + fy * a[i + 1];
      const float bot = gy * b[i] + fy * b[i + 1];
      o[i * row] = gx * top + fx * bot;
    }
  }
}

}  // namespace

// img and out (h, w, c_ch) f32 contiguous, h * w * c_ch < 2^31; tab
// (ceil(h/32) * ceil(w/128), 4) i32.
extern "C" int chord_tile_reproject_hwc(const void* img, const void* tab,
                                        int c_ch, int h, int w, void* out,
                                        void* stream) {
  if (c_ch < 1 || c_ch > kMaxChannels || h < 0 || w < 0)
    return (int)cudaErrorInvalidValue;
  if (h == 0 || w == 0) return 0;
  const int wt = (w + kTileW - 1) / kTileW;
  const int ht = (h + kTileH - 1) / kTileH;
  dim3 grid(wt * ht, kTileH / kRows);
  tile_reproject_kernel<<<grid, kTileW * c_ch, 0, (cudaStream_t)stream>>>(
      (const float*)img, (const int*)tab, c_ch, h, w, wt, (float*)out);
  return (int)cudaGetLastError();
}
