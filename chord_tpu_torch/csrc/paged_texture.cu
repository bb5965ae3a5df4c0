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
// 2-bit selector words), decoded with the f32 ramp of chord_tpu's
// _stage_page (:230-248). Bilinear filters in f32 left to right and rounds
// to u8; nearest returns the stored texel.
//
// Bound: at the frame's shapes a call moves its per-pixel inputs and
// outputs once (bytes), but the palette is a chain of block-wide steps and
// the bilinear filter of four maps costs ~100 f32 operations a texel, so
// the design keeps the steps few and short and the instructions a texel
// low. Layout: one block of 16 warps per (16,128) pixel block; thread t
// takes column t % 128 of rows t / 128 + 4j (j < 4), all C channels, and
// keeps each texel's page id (computed before any clamp: chord_tpu clamps
// only the page it stages) and fallback page id in registers.
//
// The palette in a constant number of block-wide steps: the block's
// smallest and largest ids (one barrier); each id sets bit id - min of a
// shared bitmap of kSpan bits (one barrier; an atomicOr only where neither
// the lane below nor the thread's pixel a row step up holds the same id:
// atomics on the few words a block fills serialize); each warp then counts
// set bits word by word (popc, a warp prefix sum) up to the K-th: the ids
// at or below it are served. Warp 0 writes each served id's rank (its
// palette slot) into a byte map and the ids in slot order. Ids kSpan or
// more above the block's smallest (a pool wider than the bitmap, ids far
// apart) take an exact second route when the bitmap holds fewer than K:
// rounds of a block-wide min over those ids only. The fallback pages are
// chosen the same way from the missed texels, and only where the block
// missed any (__syncthreads_or). Each texel's case becomes a byte: its
// slot, the average colour or untextured.
//
// Then the block stages its served pages in shared memory, as chord_tpu
// stages each served page: a compressed page as its 64 selector words and,
// per 4x4 block, its four ramp colours (computed once a page, in integers:
// see ramp_level), so a tap is two shared loads; a nearest call stages too
// (measured faster than decoding its one tap from L2). Raw pools (4 KB a
// page) read their texels from global memory (L2). The resolve's uv and
// mip are loaded again (L1), issued before the staging; each footprint's
// tap indices are shared by the channels; the tap math converts through
// the FP32 pipe (kSmall), the filter's u8 -> f32 by the 2^23 trick (PRMT +
// FADD) and its rounding by a round-toward-zero add.
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
constexpr int kRowStep = kThreads / kBW; // 4
constexpr int kPix = kBH * kBW / kThreads;   // 4 pixels a thread
constexpr int kMaxK = 16;                // palette pages (K <= 16)
constexpr int kMaxFb = 8;                // fallback pages (C + 4 <= 8)
constexpr int kSlots = kMaxK + kMaxFb;   // staged pages: palette, fallback
constexpr int kBig = 1 << 30;            // "no page"
constexpr int kIntMin = -2147483647 - 1;
constexpr int kSpan = 4096;              // bitmap bits: ids min .. min+4095
constexpr int kWords = kSpan / 32;
constexpr int kAvg = 0xFE;               // texel code: the average colour
constexpr int kNone = 0xFF;              // texel code: untextured
static_assert(kThreads % kBW == 0 && kPix * kThreads == kBH * kBW,
              "whole rows a step");
static_assert(kWarps <= 32, "one lane a warp's partials");

// f32 -> int32 as the port's f2i: NaN -> 0, saturating, truncating.
__device__ __forceinline__ int f2i(float x) {
  if (x != x) return 0;
  x = fminf(fmaxf(x, -2147483648.0f), 2147483520.0f);
  return (int)x;
}

// The same for an integer-valued x in [-2^22, 2^22] (or NaN), on the
// FP32 pipe: x + 1.5 * 2^23 is exact and its low bits hold x.
__device__ __forceinline__ int f2i_small(float x) {
  return x != x ? 0 : __float_as_int(x + 12582912.0f) - 0x4B400000;
}

// An int in [0, 2^23) as a float, exactly: 2^23 + i less 2^23.
__device__ __forceinline__ float i2f_small(int i) {
  return __int_as_float(0x4B000000 | i) - 8388608.0f;
}

// The truncation of a float in [0, 2^23): 2^23 + x rounded toward zero.
__device__ __forceinline__ int trunc_small(float x) {
  return __float_as_int(__fadd_rz(x, 8388608.0f)) - 0x4B000000;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Byte j of w as a float, exactly: [w.byte_j, 0, 0, 0x4B] is 2^23 + byte.
__device__ __forceinline__ float byte_f(unsigned w, int j) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650u + j)) -
         8388608.0f;
}

// trunc(x) for a float x in [0, 256) as the low byte of 2^23 + x's bits
// (the sum rounds toward zero).
__device__ __forceinline__ unsigned u8_bits(float x) {
  return __float_as_uint(__fadd_rz(x, 8388608.0f));
}

// Four u8_bits words -> one packed RGBA8 word.
__device__ __forceinline__ unsigned pack4(unsigned b0, unsigned b1,
                                         unsigned b2, unsigned b3) {
  return __byte_perm(__byte_perm(b0, b1, 0x0040u),
                     __byte_perm(b2, b3, 0x0040u), 0x5410u);
}

// Level kSel of a compressed block's ramp (endpoints e0, e1) as packed
// RGBA8. The plain version's f32 floor((a * (3 - sel) + b * sel) / 3 + .5)
// equals (a * (3 - sel) + b * sel + 1) / 3 in integers for every pair of
// bytes a, b and sel in 0..3 (the products and the sum are exact in f32,
// and the quotient's fraction, 0, 1/3 or 2/3, keeps the f32 rounding far
// from the floor's steps; tests/test_torch_paged_footprint.py checks all
// 256 x 256 x 4): levels 0 and 3 are the endpoints themselves.
template <int kSel>
__device__ __forceinline__ unsigned ramp_level(unsigned e0, unsigned e1) {
  if (kSel == 0) return e0;
  if (kSel == 3) return e1;
  unsigned out = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    out |= ((e0 >> (8 * j) & 255u) * (3 - kSel) +
            (e1 >> (8 * j) & 255u) * kSel + 1u) / 3u << (8 * j);
  return out;
}

// The tap math of one mip for one pixel, shared by the channels: u wraps,
// taps clamp to `size` (sf: (float)size); tiled: the footprint's page tile
// (tcnt tiles a row) and slots within it, else the mip's one page, slots
// unshifted. kSmall (every mip 1 to 2^21 texels a side): u - floor(u)
// lies in [0, 1], so x0f and y0f lie in [-1, size] or are NaN, and the
// conversions go through the FP32 pipe, not the conversion unit.
struct Taps {
  int tile_in, sx0, sy0, sx1, sy1;
  float fx, fy, wx0, wy0;
};

template <bool kBilinear, bool kSmall>
__device__ __forceinline__ Taps tap_math(float u, float v, int size,
                                         float sf, bool tiled) {
  Taps tp;
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
  int x0 = kSmall ? f2i_small(x0f) : f2i(x0f);
  int y0 = kSmall ? f2i_small(y0f) : f2i(y0f);
  int bx0 = clampi(x0, 0, size - 1), by0 = clampi(y0, 0, size - 1);
  int bx1 = clampi(x0 + 1, 0, size - 1), by1 = clampi(y0 + 1, 0, size - 1);
  tp.tile_in = 0;
  if (tiled) {
    int tcnt = size <= kUsable ? 1 : (size + kUsable - 1) / kUsable;
    int tx, ty;
    if (kSmall) {
      tx = trunc_small((i2f_small(bx0) + 0.5f) * (1.0f / kUsable));
      ty = trunc_small((i2f_small(by0) + 0.5f) * (1.0f / kUsable));
    } else {
      tx = f2i(((float)bx0 + 0.5f) * (1.0f / kUsable));
      ty = f2i(((float)by0 + 0.5f) * (1.0f / kUsable));
    }
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
  float sizef[16];      // (float)mt.size[m]
  int n_mips;
  int fb_idx;           // the first mip of size <= 16, else n_mips - 1
  int k_pages;
  int* out;
  int* cov;             // nullptr: no coverage output
};

// One block-wide choice of the smallest distinct ids: bit d of `bits` says
// some id is base + d; slot[d] is the rank of a chosen id base + d among
// the chosen (written for the chosen only).
struct Choice {
  unsigned bits[kWords];
  unsigned char slot[kSpan];
};

template <bool kCompressed>
struct Shared {
  Choice ch[2];                 // 0: the palette, 1: the fallback pages
  int ids[kSlots];              // slot -> page id (before the clamp)
  int part[kWarps][4];          // per warp: id min / max, fallback min / max
  int rmin[kWarps];             // the second route's block-wide min
  // compressed: per staged page its selector words and, per 4x4 block,
  // the four colours of its ramp
  unsigned selw[kCompressed ? kSlots : 1][64];
  unsigned ramp[kCompressed ? kSlots : 1][256];
};

// Set the bit of each id of `key` (pixel j, channel c at j * C + c) below
// kBig within kSpan of `base` (every id is at least base). Atomics on the
// few words a block's ids fill serialize, so a texel skips its atomic where
// its own pixel a row step up or the lane below holds the same id: the
// first of each id in (row, lane) order still sets its bit. A texel index
// no lane of the warp needs is skipped whole (every warp of the block runs
// this at once, so its instructions count).
template <int C, int N>
__device__ __forceinline__ void mark(Choice& ch, const int (&key)[N],
                                     int base) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const unsigned d = (unsigned)key[i] - (unsigned)base;
    const bool want = key[i] < kBig && d < (unsigned)kSpan &&
                      (i < C || key[i - C] != key[i]);
    if (!__any_sync(0xffffffffu, want)) continue;
    const int below = __shfl_up_sync(0xffffffffu, key[i], 1);
    if (want && (lane == 0 || below != key[i]))
      atomicOr(&ch.bits[d / 32], 1u << (d % 32));
  }
}

// The k lowest set bits of ch.bits[0, nwords), by each warp alone: returns
// their count n (at most k) and sets `last`, the n-th of them (-1: none).
// The writer warp also stores each one's rank in ch.slot and its id base +
// bit in ids[rank]. All arguments are block-uniform.
__device__ __forceinline__ int choose(Choice& ch, int nwords, int k,
                                      int base, bool writer, int* ids,
                                      int& last) {
  const int lane = threadIdx.x % 32;
  int total = 0;
  last = -1;
  for (int w0 = 0; w0 < nwords && total < k; w0 += 32) {
    const int w = w0 + lane;
    const unsigned word = w < nwords ? ch.bits[w] : 0u;
    const int cnt = __popc(word);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o *= 2) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    const int before = total + incl - cnt;
    if (writer) {
      unsigned rest = word;
      for (int r = before; rest && r < k; ++r) {
        const int d = 32 * w + __ffs(rest) - 1;
        ch.slot[d] = (unsigned char)r;
        ids[r] = base + d;
        rest &= rest - 1;
      }
    }
    // the highest word holding chosen bits holds the last of them
    const unsigned holds = __ballot_sync(0xffffffffu, cnt > 0 && before < k);
    if (holds) {
      const int src = 31 - __clz(holds);
      int bit = 0;
      if (lane == src) {
        unsigned rest = word;
        for (int r = before + 1; r < k && (rest & (rest - 1)); ++r)
          rest &= rest - 1;
        bit = __ffs(rest) - 1;
      }
      last = 32 * (w0 + src) + __shfl_sync(0xffffffffu, bit, src);
    }
    total += __shfl_sync(0xffffffffu, incl, 31);
  }
  return min(total, k);
}

// Block-wide min of v (two barriers; every thread calls it).
__device__ __forceinline__ int block_min(int v, int* rmin) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  v = __reduce_min_sync(0xffffffffu, v);
  if (lane == 0) rmin[warp] = v;
  __syncthreads();
  v = __reduce_min_sync(0xffffffffu, lane < kWarps ? rmin[lane] : kBig);
  __syncthreads();
  return v;
}

// The threshold of the k smallest distinct ids of `key` (below kBig; base
// and top their min and max, base < kBig): every id at or below it is
// chosen (kIntMin: no id). Bitmap first; then, if it held fewer than k,
// the exact second route over the ids kSpan or more above base. ids[0, n)
// get the chosen ids in order (n_bits of them from the bitmap).
template <int N>
__device__ __forceinline__ int threshold(Choice& ch, const int (&key)[N],
                                         int base, int top, int k, int* ids,
                                         int* rmin, int& n, int& n_bits) {
  n = n_bits = 0;
  if (base >= kBig) return kIntMin;
  const unsigned span = (unsigned)top - (unsigned)base;
  const int nwords = span / 32 >= (unsigned)kWords ? kWords : span / 32 + 1;
  int last;
  n = n_bits = choose(ch, nwords, k, base, threadIdx.x < 32, ids, last);
  int thr = base + last;
  if (n < k && span >= (unsigned)kSpan) {
    thr = base + (kSpan - 1);   // above every bitmap id, below the rest
    for (; n < k; ++n) {
      int m = kBig;
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (key[i] > thr) m = min(m, key[i]);
      m = block_min(m, rmin);
      if (m >= kBig) break;
      if (threadIdx.x == 0) ids[n] = m;
      thr = m;
    }
  }
  return n > 0 ? thr : kIntMin;
}

// Slot of a chosen id beyond the bitmap: the bitmap's n_bits, then its
// rank among ids[n_bits, n) (the second route's, in order).
__device__ __forceinline__ int rank_beyond(int key, const int* ids,
                                           int n_bits, int n) {
  int r = n_bits;
  while (r < n && ids[r] < key) ++r;
  return r;
}

// The slot of a chosen id: ch.slot (read for every texel, so the loads
// issue together) or, with kBeyond (the second route chose ids), the rank
// of an id beyond the bitmap.
template <bool kBeyond>
__device__ __forceinline__ unsigned slot_of(const Choice& ch, int key,
                                            int base, const int* ids,
                                            int n_bits, int n) {
  const unsigned d = (unsigned)key - (unsigned)base;
  const unsigned r = ch.slot[d < (unsigned)kSpan ? d : 0];
  return !kBeyond || d < (unsigned)kSpan
             ? r : (unsigned)rank_beyond(key, ids, n_bits, n);
}

// Per pixel, a byte a channel: the palette slot of a served texel, kAvg
// for a missed one, kNone where untextured.
template <bool kBeyond, int C, int N>
__device__ __forceinline__ void palette_codes(
    unsigned (&code)[kPix], const Choice& ch, const int (&key)[N],
    unsigned textured, unsigned served, int base, const int* ids,
    int n_bits, int n) {
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    code[j] = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i = j * C + c;
      const unsigned r = slot_of<kBeyond>(ch, key[i], base, ids, n_bits, n);
      const unsigned cd = !(textured >> i & 1u) ? kNone
                          : (served >> i & 1u) ? r : kAvg;
      code[j] |= cd << (8 * c);
    }
  }
}

// The filter of four packed texels, rounded to u8 and packed.
__device__ __forceinline__ int filter(unsigned t00, unsigned t01,
                                      unsigned t10, unsigned t11,
                                      const Taps& tp) {
  unsigned b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float val = byte_f(t00, j) * tp.wx0 * tp.wy0 +
                      byte_f(t01, j) * tp.fx * tp.wy0 +
                      byte_f(t10, j) * tp.wx0 * tp.fy +
                      byte_f(t11, j) * tp.fx * tp.fy;
    // val + 0.5 clamped to [0, 255] (never NaN after fmaxf), truncated
    b[j] = u8_bits(fminf(fmaxf(val + 0.5f, 0.0f), 255.0f));
  }
  return (int)pack4(b[0], b[1], b[2], b[3]);
}

// Where a footprint's taps (00, 01, 10, 11) lie in a page, shared by the
// channels: compressed, the 4x4 block and the shift of the texel's
// selector in its word; raw, the texel's slot.
struct TapIdx {
  int at[4], sh[4];
};

template <bool kCompressed>
__device__ __forceinline__ TapIdx tap_idx(const Taps& tp) {
  const int sx[4] = {tp.sx0, tp.sx1, tp.sx0, tp.sx1};
  const int sy[4] = {tp.sy0, tp.sy0, tp.sy1, tp.sy1};
  TapIdx ti;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    ti.at[q] = kCompressed ? (sy[q] >> 2) * 8 + (sx[q] >> 2)
                           : sy[q] * kTile + sx[q];
    ti.sh[q] = 2 * ((sy[q] & 3) * 4 + (sx[q] & 3));
  }
  return ti;
}

// The texel of the page in `slot` at the footprint's taps: staged
// (compressed: the selector, then its ramp colour) or from global memory
// (raw, at the page clamped to the pool); bilinear filters the four.
template <bool kBilinear, bool kCompressed>
__device__ __forceinline__ int sample(const Shared<kCompressed>& s,
                                      const Args& g, int slot,
                                      const TapIdx& ti, const Taps& tp) {
  constexpr int kTaps = kBilinear ? 4 : 1;
  unsigned t[4];
  const int* page = g.pages;
  if (!kCompressed)
    page += (size_t)clampi(s.ids[slot], 0, g.n_pages - 1) * (kTile * kTile);
#pragma unroll
  for (int q = 0; q < kTaps; ++q) {
    if (kCompressed) {
      const unsigned sel = (s.selw[slot][ti.at[q]] >> ti.sh[q]) & 3u;
      t[q] = s.ramp[slot][4 * ti.at[q] + sel];
    } else {
      t[q] = (unsigned)__ldg(page + ti.at[q]);
    }
  }
  return kBilinear ? filter(t[0], t[1], t[2], t[3], tp) : (int)t[0];
}

template <int C, bool kBilinear, bool kCompressed, bool kSmall>
__global__ void __launch_bounds__(kThreads, 2) palette_kernel(const Args g) {
  __shared__ Shared<kCompressed> s;
  constexpr int kN = kPix * C;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col = blockIdx.x * kBW + threadIdx.x % kBW;
  const int row0 = blockIdx.y * kBH + threadIdx.x / kBW;
  const size_t npix = (size_t)g.h * g.w;

  for (int i = threadIdx.x; i < 2 * kWords; i += kThreads)
    s.ch[i / kWords].bits[i % kWords] = 0u;

  // per (pixel j, channel c) at i = j * C + c: the page id (kBig where
  // untextured, padded or at or above kBig) and the fallback page id
  int key[kN], fkey[kN];
  unsigned textured = 0;
  int lo = kBig, hi = kIntMin, flo = kBig, fhi = kIntMin;
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int row = row0 + j * kRowStep;
    const bool in = row < g.h && col < g.w;
    const size_t p = in ? (size_t)row * g.w + col : 0;
    const float u = in ? __ldg(g.uv + 2 * p) : 0.0f;
    const float v = in ? __ldg(g.uv + 2 * p + 1) : 0.0f;
    const int m = clampi(in ? __ldg(g.mip + p) : 0, 0, g.n_mips - 1);
    const int fm = max(m, g.fb_idx);
    const int tile = tap_math<kBilinear, kSmall>(u, v, g.mt.size[m],
                                                 g.sizef[m], true).tile_in;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i = j * C + c;
      const int layer = in ? __ldg(g.layers + c * npix + p) : -1;
      // every load issued at once: entries clamp into meta, used or not
      const int first = __ldg(g.meta + clampi(layer * g.n_mips + m, 0,
                                              g.e_pad - 1));
      const int ffirst = __ldg(g.meta + clampi(layer * g.n_mips + fm, 0,
                                               g.e_pad - 1));
      textured |= (layer >= 0 ? 1u : 0u) << i;
      key[i] = layer >= 0 ? min(first + tile, kBig) : kBig;
      fkey[i] = layer >= 0 ? min(ffirst, kBig) : kBig;
      lo = min(lo, key[i]);
      flo = min(flo, fkey[i]);
      if (key[i] < kBig) hi = max(hi, key[i]);
      if (fkey[i] < kBig) fhi = max(fhi, fkey[i]);
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  flo = __reduce_min_sync(0xffffffffu, flo);
  fhi = __reduce_max_sync(0xffffffffu, fhi);
  if (lane == 0) {
    s.part[warp][0] = lo;
    s.part[warp][1] = hi;
    s.part[warp][2] = flo;
    s.part[warp][3] = fhi;
  }
  __syncthreads();
  {
    const bool mine = lane < kWarps;
    lo = __reduce_min_sync(0xffffffffu, mine ? s.part[lane][0] : kBig);
    hi = __reduce_max_sync(0xffffffffu, mine ? s.part[lane][1] : kIntMin);
    // the fallback bounds cover every textured texel: a bound of the
    // missed ones
    flo = __reduce_min_sync(0xffffffffu, mine ? s.part[lane][2] : kBig);
    fhi = __reduce_max_sync(0xffffffffu, mine ? s.part[lane][3] : kIntMin);
  }

  // the palette
  mark<C>(s.ch[0], key, lo);
  __syncthreads();
  int n_pal, n_pal_bits;
  const int thr = threshold(s.ch[0], key, lo, hi, g.k_pages, s.ids, s.rmin,
                            n_pal, n_pal_bits);
  unsigned served = 0;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    if (key[i] < kBig && key[i] <= thr) {
      served |= 1u << i;
      fkey[i] = kBig;     // only the missed texels ask for fallback pages
    }
  }

  // the fallback pages, where the block (and the warp) missed any texel
  unsigned missed = 0;
#pragma unroll
  for (int i = 0; i < kN; ++i) missed |= fkey[i] < kBig ? 1u : 0u;
  if (__any_sync(0xffffffffu, missed)) mark<C>(s.ch[1], fkey, flo);
  // also: ch[0].slot and the palette ids
  const bool any_missed = __syncthreads_or(missed);
  unsigned code[kPix];
  if (n_pal == n_pal_bits)
    palette_codes<false, C>(code, s.ch[0], key, textured, served, lo, s.ids,
                            n_pal_bits, n_pal);
  else
    palette_codes<true, C>(code, s.ch[0], key, textured, served, lo, s.ids,
                           n_pal_bits, n_pal);
  int n_fb = 0;
  if (any_missed) {
    int n_fb_bits;
    const int fthr = threshold(s.ch[1], fkey, flo, fhi, C + 4,
                               s.ids + kMaxK, s.rmin, n_fb, n_fb_bits);
    __syncthreads();      // ch[1].slot and the fallback ids
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int i = j * C + c;
        if (fkey[i] < kBig && fkey[i] <= fthr)
          code[j] = (code[j] & ~(255u << (8 * c))) |
                    (kMaxK + slot_of<true>(s.ch[1], fkey[i], flo,
                                           s.ids + kMaxK, n_fb_bits, n_fb))
                        << (8 * c);
      }
    }
  }

  // the resolve's uv and mip, asked for before the staging
  float ru[kPix], rv[kPix];
  int rm[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int row = row0 + j * kRowStep;
    const size_t p = row < g.h && col < g.w ? (size_t)row * g.w + col : 0;
    ru[j] = __ldg(g.uv + 2 * p);
    rv[j] = __ldg(g.uv + 2 * p + 1);
    rm[j] = clampi(__ldg(g.mip + p), 0, g.n_mips - 1);
  }

  if (kCompressed) {
    // stage the served pages: selector words and the decoded ramp
    // (a thread's three blocks' loads issued together)
    constexpr int kSteps = kSlots * 64 / kThreads;
    static_assert(kSteps * kThreads == kSlots * 64, "whole steps");
    unsigned e0[kSteps], e1[kSteps], sw[kSteps];
#pragma unroll
    for (int q = 0; q < kSteps; ++q) {
      const int slot = (threadIdx.x + q * kThreads) / 64;
      const int b = threadIdx.x % 64;
      const bool used = slot < kMaxK ? slot < n_pal : slot - kMaxK < n_fb;
      const int* pg = g.pages +
          (size_t)clampi(used ? s.ids[slot] : 0, 0, g.n_pages - 1) * 256;
      e0[q] = used ? (unsigned)__ldg(pg + b) : 0u;
      e1[q] = used ? (unsigned)__ldg(pg + 64 + b) : 0u;
      sw[q] = used ? (unsigned)__ldg(pg + 128 + b) : 0u;
    }
#pragma unroll
    for (int q = 0; q < kSteps; ++q) {
      const int slot = (threadIdx.x + q * kThreads) / 64;
      const int b = threadIdx.x % 64;
      if (slot < kMaxK ? slot >= n_pal : slot - kMaxK >= n_fb) continue;
      s.selw[slot][b] = sw[q];
      s.ramp[slot][4 * b] = ramp_level<0>(e0[q], e1[q]);
      s.ramp[slot][4 * b + 1] = ramp_level<1>(e0[q], e1[q]);
      s.ramp[slot][4 * b + 2] = ramp_level<2>(e0[q], e1[q]);
      s.ramp[slot][4 * b + 3] = ramp_level<3>(e0[q], e1[q]);
    }
    __syncthreads();
  }

  // the resolve: palette texels first, then (where a pixel has any) the
  // fallback's, each pass with its taps' indices shared by the channels
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int row = row0 + j * kRowStep;
    if (row >= g.h || col >= g.w) continue;
    const size_t p = (size_t)row * g.w + col;
    const float u = ru[j], v = rv[j];
    const int m = rm[j];
    const Taps tp = tap_math<kBilinear, kSmall>(u, v, g.mt.size[m],
                                                g.sizef[m], true);
    const TapIdx ti = tap_idx<kCompressed>(tp);
    int o[C];
    bool any_fb = false;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int cd = code[j] >> (8 * c) & 255u;
      o[c] = -1;
      if (cd < kMaxK) {
        o[c] = sample<kBilinear, kCompressed>(s, g, cd, ti, tp);
      } else if (cd == kAvg) {
        const int layer = __ldg(g.layers + c * npix + p);
        o[c] = __ldg(g.meta + g.e_pad +
                     clampi(layer * g.n_mips + m, 0, g.e_pad - 1));
      }
      any_fb |= cd >= kMaxK && cd < kSlots;
    }
    if (any_fb) {
      const int fm = max(m, g.fb_idx);
      const Taps fp = tap_math<kBilinear, kSmall>(u, v, g.mt.size[fm],
                                                  g.sizef[fm], false);
      const TapIdx fi = tap_idx<kCompressed>(fp);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int cd = code[j] >> (8 * c) & 255u;
        if (cd >= kMaxK && cd < kSlots)
          o[c] = sample<kBilinear, kCompressed>(s, g, cd, fi, fp);
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int cd = code[j] >> (8 * c) & 255u;
      g.out[c * npix + p] = o[c];
      if (g.cov) g.cov[c * npix + p] = (cd < kMaxK || cd == kNone) ? 1 : 0;
    }
  }
}

template <int C, bool kSmall>
void launch(const Args& g, bool bilinear, bool compressed, cudaStream_t s) {
  const dim3 grid((g.w + kBW - 1) / kBW, (g.h + kBH - 1) / kBH);
  if (bilinear && compressed)
    palette_kernel<C, true, true, kSmall><<<grid, kThreads, 0, s>>>(g);
  else if (bilinear)
    palette_kernel<C, true, false, kSmall><<<grid, kThreads, 0, s>>>(g);
  else if (compressed)
    palette_kernel<C, false, true, kSmall><<<grid, kThreads, 0, s>>>(g);
  else
    palette_kernel<C, false, false, kSmall><<<grid, kThreads, 0, s>>>(g);
}

template <int C>
int launch(const Args& g, bool bilinear, bool compressed, bool small,
           cudaStream_t s) {
  if (small)
    launch<C, true>(g, bilinear, compressed, s);
  else
    launch<C, false>(g, bilinear, compressed, s);
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
  Args g{(const int*)pages, n_pages, (const int*)meta, e_pad,
         (const int*)layers, (const float*)uv, (const int*)mip, h, w, mt,
         {}, n_mips, fb_idx, k_pages, (int*)out, (int*)cov};
  bool small = true;
  for (int m = 0; m < 16; ++m) {
    g.sizef[m] = (float)mt.size[m];
    if (m < n_mips || m == fb_idx)
      small &= mt.size[m] >= 1 && mt.size[m] <= (1 << 21);
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_ch) {
    case 1: return launch<1>(g, bilinear, compressed, small, s);
    case 2: return launch<2>(g, bilinear, compressed, small, s);
    case 3: return launch<3>(g, bilinear, compressed, small, s);
    default: return launch<4>(g, bilinear, compressed, small, s);
  }
}
