// Shared core of the raster kernels K1 (raster.cu) and K8
// (raster_subtile.cu), which compute one function (ops/raster.py
// _eval_items) over two visit lists (_groups, _subtile_groups).
//
// A block owns 32*WX columns and a band of WY*K rows of one screen tile:
// warp (wx, wy) owns the 32 columns from x0 + 32*wx and the K consecutive
// tile rows from band0 + K*wy, one column per lane. The block walks its
// tile's candidate visits in queue order. A visit is a group of cs
// consecutive triangles of coefT and the tile rows [r0, r1) it is
// evaluated on; the kernel's Queue decides which candidates are visits and
// gives their rows. Only the visits that meet the band are listed: any
// partition of the tile's pixels among blocks keeps every pixel's visits
// and their order (raster.band_split is the same rule in Python).
//
// Per step (a visit's next 32 triangles) the block stages the words a test
// reads of each triangle (15 plane coefficients and the payload, and with
// attributes their 15 plane coefficients) in a ring of four shared buffers
// with cp.async, two steps ahead, so one barrier a step separates the
// writes of step s+2 from the reads of step s-2. Each warp then culls the
// step's triangles for its own rectangle of 32 columns x its visited rows:
// lane t evaluates, for edge k = 0..2, the plane at the corner where it is
// largest (x at the high end when a >= 0, y at the high end when b >= 0).
// Rounding is monotone and the coefficients are bounded (|a|, |b|, |c| <=
// 1e29, else no cull: no product or sum overflows), so
// l = a*x + (b*y + c), evaluated as the test evaluates it, is largest at
// that corner over the whole rectangle; if it is negative there the
// triangle fails the test at every pixel of the rectangle and is skipped.
// A skipped triangle is never covered, so it never wins and the result is
// unchanged. The survivors (a ballot mask) are tested per pixel: a*px
// once per triangle, l0..l2 for each row, then l3, l4 and the IEEE divide
// only where l0..l2 cover.
//
// Per pixel the registers hold the accumulator (depth, payload and the 5
// attributes, seeded once) and, during a visit, the group's best depth,
// the max payload at it, its number of winners and its first and last
// winner. At the visit's end the group's result is merged into the
// accumulator when deeper, or as deep with a larger payload; only then are
// its attributes computed, re-testing the triangles between its first and
// last winner in triangle order (from the staged step, or from global
// memory for a triangle of an earlier step of a visit of more than 32):
// the NaN-propagating max of the winners' attributes, and a max with the
// non-winners' fill (payload 0, attributes -3e38) when not every triangle
// won. Each output is written once, at the end.
//
// The first and last winner are triangle indices in a group of at most
// kWindow = 128, so they and the count pack into one int (meta). The
// alternative, each new or tied winner's attributes evaluated inline from
// the staged words (no meta, no re-test), ran K1 9-10% slower without
// attributes and 17% slower on the masked pass with them, and K8 within
// 1.5% (H100 80GB HBM3 at 700 W, chip_smoke's phase-4 timing, both
// designs alternating in one run; PERF.md section 6).
//
// The band height divides tile_h (the entry points check it; RasterConfig
// makes tile_h a multiple of 8, and rp divide it), so no block reaches
// past its tile and no visit's rows past tile_h.
//
// Every value is computed with the plain version's expression and
// association, built with -fmad=false: l = a*px + (b*yf + c),
// cand = l3 / l4 (IEEE), inv_s = 1 / ((l0 + l1) + l2), attribute
// (aa*px + (ab*yf + ac)) * inv_s. So the planes equal the plain version's
// bit for bit.

#pragma once

#include <cuda_runtime.h>

namespace chord_raster {

constexpr int kWindow = 128;      // triangles per window
constexpr int kCoef = 32;         // words per triangle in coefT
constexpr int kChunk = 32;        // triangles per step: one per lane
constexpr int kRing = 4;          // staging buffers: two steps ahead
constexpr int kList = 512;        // visits listed before a walk
constexpr int kMinBlocks = 6;     // resident 128-thread blocks an SM is
                                  // built for: <= 85 registers a thread
constexpr float kNeg = -3e38f;    // attribute fill of a non-winner
constexpr float kCullMax = 1e29f;

__device__ __forceinline__ float max_nan(float a, float b) {
  // torch.amax semantics: NaN propagates
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

__device__ __forceinline__ void cp_async16(int* smem, const int* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A staged triangle: its first 16 words (32 with attributes) at a stride
// of 20 (36) words, so that a quarter warp's 16-B reads of 8 triangles hit
// distinct banks.
template <bool ATTR>
struct Staged {
  static constexpr int kWords = ATTR ? 32 : 16;
  static constexpr int kStride = kWords + 4;
};

// Stage the words of triangles tri0 .. tri0+nt-1 into `dst`.
template <bool ATTR>
__device__ __forceinline__ void stage(int* dst, const int* __restrict__ coef,
                                      int tri0, int nt, int nthreads) {
  constexpr int kParts = Staged<ATTR>::kWords / 4;
  for (int q = threadIdx.x; q < nt * kParts; q += nthreads) {
    const int t = q / kParts, part = q - t * kParts;
    cp_async16(dst + t * Staged<ATTR>::kStride + part * 4,
               coef + (size_t)(tri0 + t) * kCoef + part * 4);
  }
  cp_async_commit();
}

// True when the plane a*x + (b*y + c) is negative on the whole rectangle
// [x_lo, x_hi] x [y_lo, y_hi] (see the header).
__device__ __forceinline__ bool edge_misses(int ai, int bi, int ci,
                                            float x_lo, float x_hi,
                                            float y_lo, float y_hi) {
  const float a = __int_as_float(ai), b = __int_as_float(bi),
              c = __int_as_float(ci);
  if (!(fabsf(a) <= kCullMax && fabsf(b) <= kCullMax && fabsf(c) <= kCullMax))
    return false;
  const float xs = a >= 0.0f ? x_hi : x_lo;
  const float ys = b >= 0.0f ? y_hi : y_lo;
  return a * xs + (b * ys + c) < 0.0f;
}

// A triangle's depth at one pixel: 0 where not covered (or z-clipped).
// `g` points at its words, in shared or global memory.
__device__ __forceinline__ float depth_at(const int* g, float px, float yf,
                                          float zc, bool zclip, float* l) {
  for (int k = 0; k < 5; ++k) {
    const float a = __int_as_float(g[k]);
    const float b = __int_as_float(g[5 + k]);
    const float c = __int_as_float(g[10 + k]);
    l[k] = a * px + (b * yf + c);
  }
  const bool covered = (l[0] >= 0.0f) && (l[1] >= 0.0f) && (l[2] >= 0.0f) &&
                       (l[4] > 0.0f) && (l[3] > 0.0f) && (l[3] <= l[4]);
  float cand = covered ? l[3] / l[4] : 0.0f;
  if (zclip && !(cand < zc)) cand = 0.0f;
  return cand;
}

// One block's band: see the header. `q` yields the candidates of the tile
// (q.size(), q.visit(j, &v): v.x the first triangle, v.y = r0 << 16 | r1).
template <int K, int WX, int WY, bool ATTR, bool ZCLIP, class Queue>
__device__ __forceinline__ void raster_band(
    const Queue& q, int cs, const int* __restrict__ coef,
    const float* __restrict__ seed_depth, const int* __restrict__ seed_vis,
    const float* __restrict__ seed_attr, const float* __restrict__ zclip,
    float* __restrict__ depth, int* __restrict__ vis,
    float* __restrict__ attr, int py0, int x0, int band0, int w_pad,
    size_t plane) {
  constexpr int kWarps = WX * WY;
  constexpr int kThreads = 32 * kWarps;
  constexpr int kStride = Staged<ATTR>::kStride;
  __shared__ __align__(16) int ring[kRing][kChunk * kStride];
  __shared__ int2 list[kList];
  __shared__ int warp_n[kWarps];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wx = warp % WX, wy = warp / WX;
  const int x = x0 + 32 * wx + lane;
  const int my0 = band0 + K * wy;            // this thread's first row
  const int band1 = band0 + K * WY;
  const float px = (float)x;
  const float x_lo = (float)(x0 + 32 * wx), x_hi = x_lo + 31.0f;
  const unsigned below = (1u << lane) - 1u;

  float acc_d[K], yf[K], zc[K];
  int acc_v[K];
  float acc_a[5][K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int row = my0 + i;
    const size_t p = (size_t)(py0 + row) * w_pad + x;
    yf[i] = (float)(py0 + row);
    acc_d[i] = seed_depth[p];
    acc_v[i] = seed_vis[p];
    zc[i] = ZCLIP ? zclip[p] : 0.0f;
#pragma unroll
    for (int k = 0; k < 5; ++k)
      acc_a[k][i] = ATTR ? seed_attr[k * plane + p] : 0.0f;
  }

  const int n_cand = q.size();
  const int nch = (cs + kChunk - 1) / kChunk;
  float best[K];
  int pay[K], meta[K];   // meta: first winner | last winner << 8 | n << 16
  int cursor = 0;
  while (cursor < n_cand) {
    // list the band's visits, in queue order
    int n = 0;
    do {
      const int j = cursor + threadIdx.x;
      int2 v = make_int2(0, 0);
      bool keep = j < n_cand && q.visit(j, &v);
      keep = keep && (v.y >> 16) < band1 && (v.y & 0xffff) > band0;
      const unsigned m = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) warp_n[warp] = __popc(m);
      __syncthreads();
      int off = n, tot = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int c = warp_n[w];
        off += w < warp ? c : 0;
        tot += c;
      }
      if (keep) list[off + __popc(m & below)] = v;
      __syncthreads();
      n += tot;
      cursor += kThreads;
    } while (cursor < n_cand && n + kThreads <= kList);

    // walk them: step s is chunk s % nch of visit s / nch
    const int steps = n * nch;
    auto stage_step = [&](int s2) {
      const int i2 = s2 / nch, c2 = s2 - i2 * nch;
      stage<ATTR>(ring[s2 % kRing], coef, list[i2].x + c2 * kChunk,
                  min(cs - c2 * kChunk, kChunk), kThreads);
    };
    for (int s = 0; s < min(steps, 2); ++s) stage_step(s);
    for (int s = 0; s < steps; ++s) {
      if (s + 2 < steps) {
        stage_step(s + 2);
        cp_async_wait<2>();
      } else if (s + 1 < steps) {
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int vi = s / nch, c = s - vi * nch;
      const int2 v = list[vi];
      const int lo = max(v.y >> 16, my0) - my0;
      const int hi = min(v.y & 0xffff, my0 + K) - my0;
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < K; ++i) {
          best[i] = 0.0f;
          pay[i] = 0;
          meta[i] = 0;
        }
      }
      if (lo >= hi) continue;   // uniform over the warp

      // cull the step's triangles on this warp's rectangle
      const int* buf = ring[s % kRing];
      const int nt = min(cs - c * kChunk, kChunk);
      bool live = false;
      if (lane < nt) {
        const int4* tc = reinterpret_cast<const int4*>(buf + lane * kStride);
        const int4 w0 = tc[0], w1 = tc[1], w2 = tc[2], w3 = tc[3];
        const float y_lo = yf[0] + (float)lo, y_hi = yf[0] + (float)(hi - 1);
        live = !(edge_misses(w0.x, w1.y, w2.z, x_lo, x_hi, y_lo, y_hi) ||
                 edge_misses(w0.y, w1.z, w2.w, x_lo, x_hi, y_lo, y_hi) ||
                 edge_misses(w0.z, w1.w, w3.x, x_lo, x_hi, y_lo, y_hi));
      }
      unsigned m = __ballot_sync(0xffffffffu, live);
      while (m) {
        const int t = __ffs(m) - 1;
        m &= m - 1;
        const int4* tc = reinterpret_cast<const int4*>(buf + t * kStride);
        const int4 w0 = tc[0], w1 = tc[1], w2 = tc[2], w3 = tc[3];
        const float a0 = __int_as_float(w0.x), a1 = __int_as_float(w0.y),
                    a2 = __int_as_float(w0.z), a3 = __int_as_float(w0.w),
                    a4 = __int_as_float(w1.x);
        const float b0 = __int_as_float(w1.y), b1 = __int_as_float(w1.z),
                    b2 = __int_as_float(w1.w), b3 = __int_as_float(w2.x),
                    b4 = __int_as_float(w2.y);
        const float c0 = __int_as_float(w2.z), c1 = __int_as_float(w2.w),
                    c2 = __int_as_float(w3.x), c3 = __int_as_float(w3.y),
                    c4 = __int_as_float(w3.z);
        const int payload = w3.w;
        const int tri = c * kChunk + t;
        const float ax0 = a0 * px, ax1 = a1 * px, ax2 = a2 * px;
        const float ax3 = a3 * px, ax4 = a4 * px;
#pragma unroll
        for (int i = 0; i < K; ++i) {
          if (i < lo || i >= hi) continue;
          const float y = yf[i];
          const float l0 = ax0 + (b0 * y + c0);
          const float l1 = ax1 + (b1 * y + c1);
          const float l2 = ax2 + (b2 * y + c2);
          if (!(l0 >= 0.0f && l1 >= 0.0f && l2 >= 0.0f)) continue;
          const float l3 = ax3 + (b3 * y + c3);
          const float l4 = ax4 + (b4 * y + c4);
          if (!(l4 > 0.0f && l3 > 0.0f && l3 <= l4)) continue;
          const float cand = l3 / l4;
          if (ZCLIP && !(cand < zc[i])) continue;
          if (cand > best[i]) {   // a new maximum: earlier winners are out
            best[i] = cand;
            pay[i] = payload;
            meta[i] = tri | (tri << 8) | (1 << 16);
          } else if (cand == best[i] && cand > 0.0f) {   // a tie
            pay[i] = max(pay[i], payload);
            meta[i] = (meta[i] & 0xff) | (tri << 8) |
                      (((meta[i] >> 16) + 1) << 16);
          }
        }
      }
      if (c != nch - 1) continue;

      // the visit's end: merge the group's result per row
#pragma unroll
      for (int i = 0; i < K; ++i) {
        if (i < lo || i >= hi) continue;
        const int n_win = meta[i] >> 16;
        const int p_sel = n_win < cs ? max(pay[i], 0) : pay[i];
        if (!(best[i] > acc_d[i] || (best[i] == acc_d[i] && p_sel > acc_v[i])))
          continue;
        acc_d[i] = best[i];
        acc_v[i] = p_sel;
        if (!ATTR) continue;
        float sel[5] = {kNeg, kNeg, kNeg, kNeg, kNeg};
        bool first = true;
        const int t1 = n_win ? (meta[i] >> 8) & 0xff : -1;
        for (int t = meta[i] & 0xff; t <= t1; ++t) {
          const int* g = t >= c * kChunk
                             ? buf + (t - c * kChunk) * kStride
                             : coef + (size_t)(v.x + t) * kCoef;
          float l[5];
          if (depth_at(g, px, yf[i], zc[i], ZCLIP, l) != best[i]) continue;
          const float inv_s = 1.0f / ((l[0] + l[1]) + l[2]);
#pragma unroll
          for (int k = 0; k < 5; ++k) {
            const float aa = __int_as_float(g[16 + 3 * k]);
            const float ab = __int_as_float(g[17 + 3 * k]);
            const float ac = __int_as_float(g[18 + 3 * k]);
            const float val = (aa * px + (ab * yf[i] + ac)) * inv_s;
            sel[k] = first ? val : max_nan(sel[k], val);
          }
          first = false;
        }
        if (n_win < cs) {
#pragma unroll
          for (int k = 0; k < 5; ++k) sel[k] = max_nan(sel[k], kNeg);
        }
#pragma unroll
        for (int k = 0; k < 5; ++k) acc_a[k][i] = sel[k];
      }
    }
    __syncthreads();   // the ring and the list are free again
  }

#pragma unroll
  for (int i = 0; i < K; ++i) {
    const size_t p = (size_t)(py0 + my0 + i) * w_pad + x;
    depth[p] = acc_d[i];
    vis[p] = acc_v[i];
    if (ATTR) {
#pragma unroll
      for (int k = 0; k < 5; ++k) attr[k * plane + p] = acc_a[k][i];
    }
  }
}

}  // namespace chord_raster
