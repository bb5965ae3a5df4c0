// Kernel K4: tile-local bilinear history reprojection.
//
// Replaces chord_tpu/ops/tile_reproject.py::_reproject_kernel (:55). The
// Pallas kernel DMAs a (48, 256) window per 32x128 output tile and folds the
// two lerps into one-hot selection matmuls. Here: one block per output tile,
// one thread per output column, looping over the tile's 32 rows; each output
// pixel reads its 4 taps from the edge-padded planes (neighbouring threads
// read neighbouring addresses, taps shared between rows hit L1). Bound by
// the tap reads and the output write, ~(4 + 1) x 4 B x C per pixel, most of
// the taps served from cache.
//
// Per tile the wrapper passes [y0p, x0p, fy_q, fx_q]: the sample start in
// padded-plane coordinates and the fractions in 1/1024 units, exactly as
// chord_tpu computes them outside its kernel. The lerps are
//   top = (1-fy) * P[y][x]   + fy * P[y+1][x]
//   bot = (1-fy) * P[y][x+1] + fy * P[y+1][x+1]
//   out = (1-fx) * top + fx * bot
// with every product and sum rounded separately: the library is built with
// -fmad=false so this matches the plain PyTorch version
// (chord_tpu_torch/ops/tile_reproject.py reproject_tiles_plain) bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 128;
constexpr float kInvFracQ = 1.0f / 1024.0f;

__global__ void tile_reproject_kernel(const float* __restrict__ planes,
                                      const int* __restrict__ tab, int c_ch,
                                      int hp, int wp, int pw, int ph,
                                      float* __restrict__ out) {
  int t = blockIdx.x;
  int wt = wp / kTileW;
  int ty = t / wt, tx = t % wt;
  int y0p = tab[t * 4 + 0];
  int x0p = tab[t * 4 + 1];
  float fy = (float)tab[t * 4 + 2] * kInvFracQ;
  float fx = (float)tab[t * 4 + 3] * kInvFracQ;
  float gy = 1.0f - fy, gx = 1.0f - fx;
  int j = threadIdx.x;
  size_t plane = (size_t)ph * pw;
  for (int c = 0; c < c_ch; ++c) {
    const float* P = planes + c * plane;
    for (int i = 0; i < kTileH; ++i) {
      size_t r0 = (size_t)(y0p + i) * pw + x0p + j;
      size_t r1 = r0 + pw;
      float top = gy * P[r0] + fy * P[r1];
      float bot = gy * P[r0 + 1] + fy * P[r1 + 1];
      float v = gx * top + fx * bot;
      out[c * (size_t)hp * wp + (size_t)(ty * kTileH + i) * wp +
          tx * kTileW + j] = v;
    }
  }
}

}  // namespace

extern "C" int chord_tile_reproject(const void* planes, const void* tab,
                                    int c_ch, int hp, int wp, int pw, int ph,
                                    void* out, void* stream) {
  int nt = (hp / kTileH) * (wp / kTileW);
  if (nt <= 0) return 0;
  tile_reproject_kernel<<<nt, kTileW, 0, (cudaStream_t)stream>>>(
      (const float*)planes, (const int*)tab, c_ch, hp, wp, pw, ph,
      (float*)out);
  return (int)cudaGetLastError();
}
