// Kernel K5: paged virtual-texture sampler.
//
// Replaces chord_tpu/ops/paged_texture.py::_paged_kernel (:251, via
// paged_sample :442), and computes its function: per (16,128) pixel block
// only the K smallest distinct page ids the block's (channel, pixel)s ask
// for are served (the palette; K = 16 for the fused material maps, 10 for
// one map). A texel whose page misses reads the single-page fallback mip
// max(mip, first mip of size <= 16) if that page is among the C+4 smallest
// distinct fallback pages of the block's missed texels, else the entry's
// average colour. The palette decides which value a texel gets, so it is
// part of the function, not a layout of the TPU's.
//
// Pages: raw = 1024 int32 RGBA8 texels (slot = sy*32 + sx); compressed =
// 256 int32 (row 0: endpoints 0 | endpoints 1 per 4x4 block, row 1: the
// 2-bit selector words), decoded per texel with the f32 ramp of
// chord_tpu's _stage_page (:230-248). Bilinear filters in f32 left to
// right and rounds to u8; nearest returns the stored texel.
//
// Layout: one block of 16 warps per (16,128) pixel block; thread t takes
// column t % 128 of rows t / 128 + 4j (j < 4), all C channels. Each texel's
// page id is computed before any clamp (chord_tpu clamps only the page it
// stages). The palette takes two levels and one barrier: each warp finds
// the K smallest distinct ids of its texels by rounds of a warp-wide min,
// the 16 lists go to shared memory, and every warp takes the K smallest
// distinct of those. That is exact: each of the block's K smallest
// distinct ids is among the K smallest of the warp that holds it. The
// served ids are then those at or below the last id found. A second round
// does the same over the missed texels' fallback pages with C+4. Then each
// thread resolves its texels from global memory (the bench pool, ~1.5 MB
// compressed, stays in L2). A compressed bilinear footprint's four texels
// lie in one, two or four 4x4 blocks: it straddles a block edge in x only
// when sx1 > sx0 crosses a multiple of 4, and never a page (the apron
// repeats the neighbour's first texel; the fallback mip is one page). Each
// distinct block's three words are loaded once, and each texel is decoded
// straight into the filter's sums, as floats and in the filter's order: a
// decoded texel is an integer in [0, 255], so the plain version's pack to
// u8 and unpack is the identity. Bytes become floats by the 2^23 trick
// (PRMT + FADD) in place of I2F.
//
// Built with -fmad=false, so every product and sum rounds as the plain
// PyTorch version (chord_tpu_torch/ops/paged_texture.py paged_sample_plain)
// does: the outputs match it bit for bit.

#include <cuda_runtime.h>

// Edge size of each mip, passed by value (ctypes Structure _MipTable).
// Outside the anonymous namespace: the exported C entry point takes it.
struct ChordMipTable {
  int size[16];
};

namespace {

constexpr int kTile = 32;
constexpr int kUsable = 31;
constexpr int kBH = 16;                  // pixel rows per palette block
constexpr int kBW = 128;                 // pixel columns per palette block
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;    // 16
constexpr int kPix = kBH * kBW / kThreads;   // 4 pixels a thread
constexpr int kMaxK = 16;                // palette pages (K <= 16)
constexpr int kMaxFb = 8;                // fallback pages (C + 4 <= 8)
constexpr int kBig = 1 << 30;            // "no page"
static_assert(kThreads % kBW == 0 && kPix * kThreads == kBH * kBW,
              "whole rows a step");
static_assert(kWarps * kMaxK % 32 == 0 && kWarps * kMaxFb % 32 == 0,
              "whole candidate rows");

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

// The tap math of one mip for one pixel, shared by the channels: u wraps,
// taps clamp to `size`; tiled: the footprint's page tile (tcnt tiles a
// row) and slots within it, else the mip's one page, slots unshifted.
struct Taps {
  int tile_in, sx0, sy0, sx1, sy1;
  float fx, fy, wx0, wy0;
};

template <bool kBilinear>
__device__ __forceinline__ Taps tap_math(float u, float v, int size,
                                         bool tiled) {
  Taps tp;
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
  int bx1 = clampi(x0 + 1, 0, size - 1), by1 = clampi(y0 + 1, 0, size - 1);
  tp.tile_in = 0;
  if (tiled) {
    int tcnt = size <= kUsable ? 1 : (size + kUsable - 1) / kUsable;
    int tx = f2i(((float)bx0 + 0.5f) * (1.0f / kUsable));
    int ty = f2i(((float)by0 + 0.5f) * (1.0f / kUsable));
    tp.tile_in = ty * tcnt + tx;
    bx0 -= tx * kUsable;
    bx1 -= tx * kUsable;
    by0 -= ty * kUsable;
    by1 -= ty * kUsable;
  }
  tp.sx0 = bx0;
  tp.sy0 = by0;
  tp.sx1 = kBilinear ? bx1 : bx0;
  tp.sy1 = kBilinear ? by1 : by0;
  tp.fx = fx;
  tp.fy = fy;
  tp.wx0 = 1.0f - fx;
  tp.wy0 = 1.0f - fy;
  return tp;
}

struct Args {
  const int* pages;
  int n_pages;
  const int* meta;      // row 0: first page, row 1: average colour
  int e_pad;
  const int* layers;
  const float* uv;
  const int* mip;
  int h, w;
  ChordMipTable mt;
  int n_mips;
  int fb_idx;           // the first mip of size <= 16, else n_mips - 1
  int k_pages;
  int* out;
  int* cov;             // nullptr: no coverage output
};

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

template <bool kBilinear, bool kCompressed>
__device__ __forceinline__ int texel(const Args& g, int page,
                                     const Taps& tp) {
  page = clampi(page, 0, g.n_pages - 1);
  return kBilinear ? bilinear_texel<kCompressed>(g.pages, page, tp)
                   : nearest_texel<kCompressed>(g.pages, page, tp);
}

// The up to k smallest distinct of the warp's N values a lane (values are
// at most kBig), padded with kBig: rounds of a warp-wide min, each taking
// the round's value out, until k or only kBig are left. Returns the last
// value found (INT_MIN if none): the values served are those at or below.
template <int N, int M>
__device__ __forceinline__ int warp_smallest(const int (&key)[N], int k,
                                             int (&ids)[M]) {
  int rem[N];
#pragma unroll
  for (int j = 0; j < N; ++j) rem[j] = key[j];
#pragma unroll
  for (int i = 0; i < M; ++i) ids[i] = kBig;
  int last = -2147483647 - 1;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if (i >= k) break;                // block-uniform
    int m = rem[0];
#pragma unroll
    for (int j = 1; j < N; ++j) m = min(m, rem[j]);
    m = __reduce_min_sync(0xffffffffu, m);
    if (m == kBig) break;             // warp-uniform
    ids[i] = m;
    last = m;
#pragma unroll
    for (int j = 0; j < N; ++j) rem[j] = rem[j] == m ? kBig : rem[j];
  }
  return last;
}

// The block's threshold: the last of the K smallest distinct keys of all
// its threads (two levels through `cand`, kWarps * M ints, one barrier).
template <int N, int M>
__device__ __forceinline__ int block_threshold(const int (&key)[N], int k,
                                               int* cand) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int ids[M];
  warp_smallest(key, k, ids);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < M; ++i) cand[warp * M + i] = ids[i];
  }
  __syncthreads();
  constexpr int kPer = kWarps * M / 32;
  int mine[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) mine[q] = cand[lane + 32 * q];
  return warp_smallest(mine, k, ids);
}

template <int C, bool kBilinear, bool kCompressed>
__global__ void __launch_bounds__(kThreads) palette_kernel(const Args g) {
  __shared__ int s_cand[kWarps * kMaxK];
  __shared__ int s_fb[kWarps * kMaxFb];
  const int col = blockIdx.x * kBW + threadIdx.x % kBW;
  const int row0 = blockIdx.y * kBH + threadIdx.x / kBW;
  constexpr int kRowStep = kThreads / kBW;   // 4
  const size_t npix = (size_t)g.h * g.w;

  // per (pixel j, channel c) at i = j * C + c: the page id (kBig where
  // untextured, padded or at or above kBig), its fallback page id and the
  // entry (-1: untextured)
  int key[kPix * C], fkey[kPix * C], ent[kPix * C];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int row = row0 + j * kRowStep;
    const bool in = row < g.h && col < g.w;
    const size_t p = in ? (size_t)row * g.w + col : 0;
    const float u = in ? __ldg(g.uv + 2 * p) : 0.0f;
    const float v = in ? __ldg(g.uv + 2 * p + 1) : 0.0f;
    const int m = clampi(in ? __ldg(g.mip + p) : 0, 0, g.n_mips - 1);
    const int fm = max(m, g.fb_idx);
    const Taps tp = tap_math<kBilinear>(u, v, g.mt.size[m], true);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i = j * C + c;
      const int layer = in ? __ldg(g.layers + c * npix + p) : -1;
      ent[i] = layer < 0 ? -1 : clampi(layer * g.n_mips + m, 0, g.e_pad - 1);
      const int fe = clampi(layer * g.n_mips + fm, 0, g.e_pad - 1);
      key[i] = layer < 0 ? kBig : min(__ldg(g.meta + ent[i]) + tp.tile_in,
                                      kBig);
      fkey[i] = layer < 0 ? kBig : min(__ldg(g.meta + fe), kBig);
    }
  }

  const int thr = block_threshold<kPix * C, kMaxK>(key, g.k_pages, s_cand);
#pragma unroll
  for (int i = 0; i < kPix * C; ++i)
    fkey[i] = key[i] < kBig && key[i] <= thr ? kBig : fkey[i];
  const int fthr = block_threshold<kPix * C, kMaxFb>(fkey, C + 4, s_fb);

#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int row = row0 + j * kRowStep;
    if (row >= g.h || col >= g.w) continue;
    const size_t p = (size_t)row * g.w + col;
    const float u = __ldg(g.uv + 2 * p), v = __ldg(g.uv + 2 * p + 1);
    const int m = clampi(__ldg(g.mip + p), 0, g.n_mips - 1);
    const int fm = max(m, g.fb_idx);
    const Taps tp = tap_math<kBilinear>(u, v, g.mt.size[m], true);
    const Taps fp = tap_math<kBilinear>(u, v, g.mt.size[fm], false);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i = j * C + c;
      const bool served = key[i] < kBig && key[i] <= thr;
      int o = -1;
      if (ent[i] >= 0) {
        if (served)
          o = texel<kBilinear, kCompressed>(g, key[i], tp);
        else if (fkey[i] < kBig && fkey[i] <= fthr)
          o = texel<kBilinear, kCompressed>(g, fkey[i], fp);
        else
          o = __ldg(g.meta + g.e_pad + ent[i]);
      }
      g.out[c * npix + p] = o;
      if (g.cov) g.cov[c * npix + p] = (served || ent[i] < 0) ? 1 : 0;
    }
  }
}

template <int C>
int launch(const Args& g, bool bilinear, bool compressed, cudaStream_t s) {
  const dim3 grid((g.w + kBW - 1) / kBW, (g.h + kBH - 1) / kBH);
  if (bilinear && compressed)
    palette_kernel<C, true, true><<<grid, kThreads, 0, s>>>(g);
  else if (bilinear)
    palette_kernel<C, true, false><<<grid, kThreads, 0, s>>>(g);
  else if (compressed)
    palette_kernel<C, false, true><<<grid, kThreads, 0, s>>>(g);
  else
    palette_kernel<C, false, false><<<grid, kThreads, 0, s>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t, or -1 for arguments the kernel does not take
// (C outside [1, 4], K outside [1, 16]).
extern "C" int chord_paged_sample(const void* pages, int n_pages,
                                  const void* meta, int e_pad,
                                  const void* layers, int n_ch, const void* uv,
                                  const void* mip, int h, int w,
                                  ChordMipTable mt, int n_mips, int fb_idx,
                                  int k_pages, int bilinear, int compressed,
                                  void* out, void* cov, void* stream) {
  if (n_ch < 1 || n_ch > 4 || k_pages < 1 || k_pages > kMaxK) return -1;
  if (h <= 0 || w <= 0) return 0;
  const Args g{(const int*)pages, n_pages, (const int*)meta, e_pad,
               (const int*)layers, (const float*)uv, (const int*)mip, h, w,
               mt, n_mips, fb_idx, k_pages, (int*)out, (int*)cov};
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_ch) {
    case 1: return launch<1>(g, bilinear, compressed, s);
    case 2: return launch<2>(g, bilinear, compressed, s);
    case 3: return launch<3>(g, bilinear, compressed, s);
    default: return launch<4>(g, bilinear, compressed, s);
  }
}
