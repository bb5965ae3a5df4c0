// Kernel K5: paged virtual-texture sampler.
//
// Replaces chord_tpu/ops/paged_texture.py::_paged_kernel (:251, via
// paged_sample :442). The Pallas kernel stages a K-page palette per
// (BH,128) pixel block and resolves taps with lane shuffles, because the
// TPU has no gather; pixels whose page misses the palette fall back to a
// coarse mip. Here: one thread per pixel. The tap math (wrap, clamp, page
// tile, apron slots) is done once and shared by the C channels; each
// channel reads its page straight from global memory, where the bench pool
// (~1.5 MB compressed) stays in L2. No palette, so no miss and no fallback:
// every pixel gets its full-resolution sample.
//
// Pages: raw = 1024 int32 RGBA8 texels (slot = sy*32 + sx); compressed =
// 256 int32 (row 0: endpoints 0 | endpoints 1 per 4x4 block, row 1: the
// 2-bit selector words), decoded per texel with the f32 ramp of
// chord_tpu's _stage_page (:230-248). Bilinear filters in f32 left to
// right and rounds to u8; nearest returns the stored texel.
//
// Bound at the bench's 1280x720: the bytes of the per-pixel inputs and
// outputs (C layer planes + uv + mip read, C packed planes written; the
// pages are L2-resident). Built with -fmad=false, so every product and sum
// rounds as the plain PyTorch version
// (chord_tpu_torch/ops/paged_texture.py paged_sample_plain) does: the
// outputs match it bit for bit.

#include <cuda_runtime.h>

// Edge size of each mip, passed by value (ctypes Structure _MipTable).
// Outside the anonymous namespace: the exported C entry point takes it.
struct ChordMipTable {
  int size[16];
};

namespace {

constexpr int kTile = 32;
constexpr int kUsable = 31;

// f32 -> int32 as the port's f2i: NaN -> 0, saturating, truncating.
__device__ __forceinline__ int f2i(float x) {
  if (x != x) return 0;
  x = fminf(fmaxf(x, -2147483648.0f), 2147483520.0f);
  return (int)x;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Packed RGBA8 texel at `slot` of `page`.
__device__ __forceinline__ unsigned fetch(const int* __restrict__ pages,
                                          int page, int slot,
                                          bool compressed) {
  if (!compressed) return (unsigned)pages[(size_t)page * (kTile * kTile) + slot];
  int sy = slot >> 5, sx = slot & 31;
  const int* base = pages + (size_t)page * 256;
  int bi = (sy >> 2) * 8 + (sx >> 2);
  unsigned e0 = (unsigned)base[bi];
  unsigned e1 = (unsigned)base[64 + bi];
  unsigned sw = (unsigned)base[128 + bi];
  int t = (sy & 3) * 4 + (sx & 3);
  float sel = (float)((sw >> (2 * t)) & 3u);
  unsigned out = 0;
  for (int sh = 0; sh < 32; sh += 8) {
    float a = (float)((e0 >> sh) & 255u);
    float b = (float)((e1 >> sh) & 255u);
    float val = floorf((a * (3.0f - sel) + b * sel) * (1.0f / 3.0f) + 0.5f);
    out |= ((unsigned)(int)val) << sh;
  }
  return out;
}

__device__ __forceinline__ float chan(unsigned p, int sh) {
  return (float)((p >> sh) & 255u);
}

__global__ void paged_sample_kernel(const int* __restrict__ pages, int n_pages,
                                    const int* __restrict__ meta, int e_pad,
                                    const int* __restrict__ layers, int n_ch,
                                    const float* __restrict__ uv,
                                    const int* __restrict__ mip, int npix,
                                    ChordMipTable mt, int n_mips,
                                    int bilinear,
                                    int compressed, int* __restrict__ out) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npix) return;
  // --- shared tap math (u wraps, taps clamp) ---
  int m = clampi(mip[p], 0, n_mips - 1);
  int size = mt.size[m];
  int tcnt = size <= kUsable ? 1 : (size + kUsable - 1) / kUsable;
  float sf = (float)size;
  float u = uv[2 * (size_t)p];
  float v = uv[2 * (size_t)p + 1];
  float x = (u - floorf(u)) * sf;
  float y = (v - floorf(v)) * sf;
  float x0f, y0f, fx = 0.0f, fy = 0.0f;
  if (bilinear) {
    x0f = floorf(x - 0.5f);
    y0f = floorf(y - 0.5f);
    fx = x - 0.5f - x0f;
    fy = y - 0.5f - y0f;
  } else {
    x0f = floorf(x);
    y0f = floorf(y);
  }
  int x0 = f2i(x0f), y0 = f2i(y0f);
  int bx0 = clampi(x0, 0, size - 1), by0 = clampi(y0, 0, size - 1);
  int tx = f2i(((float)bx0 + 0.5f) * (1.0f / kUsable));
  int ty = f2i(((float)by0 + 0.5f) * (1.0f / kUsable));
  int sx0 = bx0 - tx * kUsable, sy0 = by0 - ty * kUsable;
  int tile_in = ty * tcnt + tx;
  int s00 = sy0 * kTile + sx0, s01 = s00, s10 = s00, s11 = s00;
  if (bilinear) {
    int sx1 = clampi(x0 + 1, 0, size - 1) - tx * kUsable;
    int sy1 = clampi(y0 + 1, 0, size - 1) - ty * kUsable;
    s01 = sy0 * kTile + sx1;
    s10 = sy1 * kTile + sx0;
    s11 = sy1 * kTile + sx1;
  }
  float wx0 = 1.0f - fx, wy0 = 1.0f - fy;
  // --- per channel: page lookup + taps ---
  for (int c = 0; c < n_ch; ++c) {
    size_t o = (size_t)c * npix + p;
    int layer = layers[o];
    if (layer < 0) {
      out[o] = -1;
      continue;
    }
    int e = clampi(layer * n_mips + m, 0, e_pad - 1);
    int page = clampi(meta[e] + tile_in, 0, n_pages - 1);
    if (!bilinear) {
      out[o] = (int)fetch(pages, page, s00, compressed);
      continue;
    }
    unsigned t00 = fetch(pages, page, s00, compressed);
    unsigned t01 = fetch(pages, page, s01, compressed);
    unsigned t10 = fetch(pages, page, s10, compressed);
    unsigned t11 = fetch(pages, page, s11, compressed);
    unsigned r = 0;
    for (int sh = 0; sh < 32; sh += 8) {
      float val = chan(t00, sh) * wx0 * wy0 + chan(t01, sh) * fx * wy0 +
                  chan(t10, sh) * wx0 * fy + chan(t11, sh) * fx * fy;
      val = fminf(fmaxf(val + 0.5f, 0.0f), 255.0f);
      r |= ((unsigned)f2i(val)) << sh;
    }
    out[o] = (int)r;
  }
}

}  // namespace

extern "C" int chord_paged_sample(const void* pages, int n_pages,
                                  const void* meta, int e_pad,
                                  const void* layers, int n_ch, const void* uv,
                                  const void* mip, int npix, ChordMipTable mt,
                                  int n_mips, int bilinear, int compressed,
                                  void* out, void* stream) {
  if (npix <= 0 || n_ch <= 0) return 0;
  int threads = 256;
  int blocks = (npix + threads - 1) / threads;
  paged_sample_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)pages, n_pages, (const int*)meta, e_pad, (const int*)layers,
      n_ch, (const float*)uv, (const int*)mip, npix, mt, n_mips, bilinear,
      compressed, (int*)out);
  return (int)cudaGetLastError();
}
