// Kernel K5: paged virtual-texture sampler.
//
// Replaces chord_tpu/ops/paged_texture.py::_paged_kernel (:251, via
// paged_sample :442). The Pallas kernel stages a K-page palette per
// (BH,128) pixel block and resolves taps with lane shuffles, because the
// TPU has no gather; pixels whose page misses the palette fall back to a
// coarse mip. Here every pixel reads its pages straight from global memory,
// where the bench pool (~1.5 MB compressed) stays in L2: no palette, so no
// miss and no fallback, every pixel gets its full-resolution sample.
//
// Pages: raw = 1024 int32 RGBA8 texels (slot = sy*32 + sx); compressed =
// 256 int32 (row 0: endpoints 0 | endpoints 1 per 4x4 block, row 1: the
// 2-bit selector words), decoded per texel with the f32 ramp of
// chord_tpu's _stage_page (:230-248). Bilinear filters in f32 left to
// right and rounds to u8; nearest returns the stored texel.
//
// Layout. Bilinear: one thread a pixel; the tap math (wrap, clamp, page
// tile, apron slots) is done once and shared by the C channels. A
// compressed footprint's four texels lie in one, two or four 4x4 blocks:
// it straddles a block edge in x only when sx0 & 3 == 3 and in y only when
// sy0 & 3 == 3, and never a page (the apron repeats the neighbour's first
// texel). Each distinct block's three words are loaded once, and each
// texel is decoded straight into the filter's sums, as floats and in the
// filter's order: a decoded texel is an integer in [0, 255], so the plain
// version's pack to u8 and unpack is the identity. Bytes become floats by
// the 2^23 trick (PRMT + FADD) in place of I2F. Nearest: one thread a
// (pixel, channel), grid.y = channel, so the layer load does not wait on a
// channel loop.
//
// Bound at the bench's 1280x720: the bytes of the per-pixel inputs and
// outputs (C layer planes + uv + mip read, C packed planes written; the
// pages are L2-resident). The C=4 bilinear resolve is held back by the
// decode's f32 operations, not by its gathers (PERF.md §6). Built with
// -fmad=false, so every product and sum rounds as the plain PyTorch
// version (chord_tpu_torch/ops/paged_texture.py paged_sample_plain) does:
// the outputs match it bit for bit.

#include <cuda_runtime.h>

// Edge size of each mip, passed by value (ctypes Structure _MipTable).
// Outside the anonymous namespace: the exported C entry point takes it.
struct ChordMipTable {
  int size[16];
};

namespace {

constexpr int kTile = 32;
constexpr int kUsable = 31;
constexpr int kThreads = 256;

// f32 -> int32 as the port's f2i: NaN -> 0, saturating, truncating.
__device__ __forceinline__ int f2i(float x) {
  if (x != x) return 0;
  x = fminf(fmaxf(x, -2147483648.0f), 2147483520.0f);
  return (int)x;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Byte j of w as a float, exactly: [w.byte_j, 0, 0, 0x4B] is 2^23 + byte.
__device__ __forceinline__ float byte_f(unsigned w, int j) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650u + j)) -
         8388608.0f;
}

// Packed RGBA8 texel t = (sy & 3) * 4 + (sx & 3) of a compressed block
// (endpoints e0, e1, selector word sw).
__device__ __forceinline__ unsigned decode(unsigned e0, unsigned e1,
                                          unsigned sw, int t) {
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

// Texel t of a compressed block, decoded as decode() does, added into the
// bilinear sums of its 4 channels: the first tap sets (v * w1) * w2, each
// later one adds its own, the plain version's left-to-right sum.
__device__ __forceinline__ void tap_into(unsigned e0, unsigned e1,
                                         unsigned sw, int t, float w1,
                                         float w2, float acc[4], bool first) {
  float sel = __uint_as_float(0x4B000000u | ((sw >> (2 * t)) & 3u)) -
              8388608.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float v = floorf((byte_f(e0, j) * (3.0f - sel) + byte_f(e1, j) * sel) *
                         (1.0f / 3.0f) + 0.5f);
    float term = v * w1 * w2;
    acc[j] = first ? term : acc[j] + term;
  }
}

// The per-pixel tap math, shared by the channels.
struct Taps {
  int m, tile_in, sx0, sy0, sx1, sy1;
  float fx, fy, wx0, wy0;
};

template <bool kBilinear>
__device__ __forceinline__ Taps tap_math(float u, float v, int mip,
                                         const ChordMipTable& mt,
                                         int n_mips) {
  Taps tp;
  int m = clampi(mip, 0, n_mips - 1);
  int size = mt.size[m];
  int tcnt = size <= kUsable ? 1 : (size + kUsable - 1) / kUsable;
  float sf = (float)size;
  float x = (u - floorf(u)) * sf;
  float y = (v - floorf(v)) * sf;
  float x0f, y0f, fx = 0.0f, fy = 0.0f;
  if (kBilinear) {
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
  tp.m = m;
  tp.tile_in = ty * tcnt + tx;
  tp.sx0 = bx0 - tx * kUsable;
  tp.sy0 = by0 - ty * kUsable;
  tp.sx1 = tp.sx0;
  tp.sy1 = tp.sy0;
  if (kBilinear) {
    tp.sx1 = clampi(x0 + 1, 0, size - 1) - tx * kUsable;
    tp.sy1 = clampi(y0 + 1, 0, size - 1) - ty * kUsable;
  }
  tp.fx = fx;
  tp.fy = fy;
  tp.wx0 = 1.0f - fx;
  tp.wy0 = 1.0f - fy;
  return tp;
}

struct Args {
  const int* pages;
  int n_pages;
  const int* meta;
  int e_pad;
  const int* layers;
  int n_ch;
  const float* uv;
  const int* mip;
  int npix;
  ChordMipTable mt;
  int n_mips;
  int* out;
};

__device__ __forceinline__ int page_of(const Args& g, const Taps& tp,
                                       int layer) {
  int e = clampi(layer * g.n_mips + tp.m, 0, g.e_pad - 1);
  return clampi(__ldg(g.meta + e) + tp.tile_in, 0, g.n_pages - 1);
}

__device__ __forceinline__ Taps pixel_taps(const Args& g, int p,
                                           bool bilinear) {
  float u = __ldg(g.uv + 2 * (size_t)p), v = __ldg(g.uv + 2 * (size_t)p + 1);
  int mip = __ldg(g.mip + p);
  return bilinear ? tap_math<true>(u, v, mip, g.mt, g.n_mips)
                  : tap_math<false>(u, v, mip, g.mt, g.n_mips);
}

// val + 0.5 clamped to [0, 255] (never NaN after fmaxf), so the port's f2i
// is a plain truncation here.
__device__ __forceinline__ unsigned round_u8(float val) {
  return (unsigned)(int)fminf(fmaxf(val + 0.5f, 0.0f), 255.0f);
}

template <bool kCompressed>
__device__ __forceinline__ int bilinear_texel(const int* __restrict__ pages,
                                              int page, const Taps& tp) {
  float acc[4];
  if (kCompressed) {
    const int* base = pages + (size_t)page * 256;
    const int b00 = (tp.sy0 >> 2) * 8 + (tp.sx0 >> 2);
    const bool dx = (tp.sx1 >> 2) != (tp.sx0 >> 2);   // then b00 + 1
    const bool dy = (tp.sy1 >> 2) != (tp.sy0 >> 2);   // then b00 + 8
    // words q = e0, e1, sw of the blocks of texels 00, 01, 10, 11
    unsigned w00[3], w01[3], w10[3], w11[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      w00[q] = (unsigned)__ldg(base + 64 * q + b00);
      w01[q] = w00[q];
      w10[q] = w00[q];
    }
    if (dx) {
#pragma unroll
      for (int q = 0; q < 3; ++q)
        w01[q] = (unsigned)__ldg(base + 64 * q + b00 + 1);
    }
    if (dy) {
#pragma unroll
      for (int q = 0; q < 3; ++q)
        w10[q] = (unsigned)__ldg(base + 64 * q + b00 + 8);
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) w11[q] = dx ? w01[q] : w10[q];
    if (dx && dy) {
#pragma unroll
      for (int q = 0; q < 3; ++q)
        w11[q] = (unsigned)__ldg(base + 64 * q + b00 + 9);
    }
    const int r0 = (tp.sy0 & 3) * 4, r1 = (tp.sy1 & 3) * 4;
    const int c0 = tp.sx0 & 3, c1 = tp.sx1 & 3;
    tap_into(w00[0], w00[1], w00[2], r0 + c0, tp.wx0, tp.wy0, acc, true);
    tap_into(w01[0], w01[1], w01[2], r0 + c1, tp.fx, tp.wy0, acc, false);
    tap_into(w10[0], w10[1], w10[2], r1 + c0, tp.wx0, tp.fy, acc, false);
    tap_into(w11[0], w11[1], w11[2], r1 + c1, tp.fx, tp.fy, acc, false);
  } else {
    const int* base = pages + (size_t)page * (kTile * kTile);
    unsigned t00 = (unsigned)__ldg(base + tp.sy0 * kTile + tp.sx0);
    unsigned t01 = (unsigned)__ldg(base + tp.sy0 * kTile + tp.sx1);
    unsigned t10 = (unsigned)__ldg(base + tp.sy1 * kTile + tp.sx0);
    unsigned t11 = (unsigned)__ldg(base + tp.sy1 * kTile + tp.sx1);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[j] = byte_f(t00, j) * tp.wx0 * tp.wy0 +
               byte_f(t01, j) * tp.fx * tp.wy0 +
               byte_f(t10, j) * tp.wx0 * tp.fy +
               byte_f(t11, j) * tp.fx * tp.fy;
  }
  unsigned r = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) r |= round_u8(acc[j]) << (8 * j);
  return (int)r;
}

template <bool kCompressed>
__device__ __forceinline__ int nearest_texel(const int* __restrict__ pages,
                                             int page, const Taps& tp) {
  if (!kCompressed)
    return __ldg(pages + (size_t)page * (kTile * kTile) + tp.sy0 * kTile +
                 tp.sx0);
  const int* base = pages + (size_t)page * 256;
  const int bi = (tp.sy0 >> 2) * 8 + (tp.sx0 >> 2);
  return (int)decode((unsigned)__ldg(base + bi),
                     (unsigned)__ldg(base + 64 + bi),
                     (unsigned)__ldg(base + 128 + bi),
                     (tp.sy0 & 3) * 4 + (tp.sx0 & 3));
}

// Bilinear: one thread a pixel, the channels in turn.
template <bool kCompressed>
__global__ void __launch_bounds__(kThreads) bilinear_kernel(const Args g) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= g.npix) return;
  const Taps tp = pixel_taps(g, p, true);
  for (int c = 0; c < g.n_ch; ++c) {
    const size_t o = (size_t)c * g.npix + p;
    const int layer = __ldg(g.layers + o);
    g.out[o] = layer < 0 ? -1
                         : bilinear_texel<kCompressed>(
                               g.pages, page_of(g, tp, layer), tp);
  }
}

// Nearest: one thread a (pixel, channel = blockIdx.y).
template <bool kCompressed>
__global__ void __launch_bounds__(kThreads) nearest_kernel(const Args g) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= g.npix) return;
  const size_t o = (size_t)blockIdx.y * g.npix + p;
  const int layer = __ldg(g.layers + o);
  const Taps tp = pixel_taps(g, p, false);
  g.out[o] = layer < 0 ? -1
                       : nearest_texel<kCompressed>(
                             g.pages, page_of(g, tp, layer), tp);
}

}  // namespace

extern "C" int chord_paged_sample(const void* pages, int n_pages,
                                  const void* meta, int e_pad,
                                  const void* layers, int n_ch, const void* uv,
                                  const void* mip, int npix, ChordMipTable mt,
                                  int n_mips, int bilinear, int compressed,
                                  void* out, void* stream) {
  if (npix <= 0 || n_ch <= 0) return 0;
  const Args g{(const int*)pages, n_pages, (const int*)meta, e_pad,
               (const int*)layers, n_ch, (const float*)uv, (const int*)mip,
               npix, mt, n_mips, (int*)out};
  const int blocks = (npix + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (bilinear && compressed)
    bilinear_kernel<true><<<blocks, kThreads, 0, s>>>(g);
  else if (bilinear)
    bilinear_kernel<false><<<blocks, kThreads, 0, s>>>(g);
  else if (compressed)
    nearest_kernel<true><<<dim3(blocks, n_ch), kThreads, 0, s>>>(g);
  else
    nearest_kernel<false><<<dim3(blocks, n_ch), kThreads, 0, s>>>(g);
  return (int)cudaGetLastError();
}
