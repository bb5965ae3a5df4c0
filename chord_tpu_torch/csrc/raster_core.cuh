// Shared core of the raster kernels K1 (raster.cu), K7 (raster_bricks.cu)
// and K8 (raster_subtile.cu), which compute one function (ops/raster.py
// _eval_items) over three visit lists (_groups, _brick_groups,
// _subtile_groups), K7 in its own plane association (a plane policy,
// below).
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
// 1e29, else no cull: no product or sum overflows), so the plane,
// evaluated as the test evaluates it (each correctly rounded product and
// sum is monotone in x and y in the direction of the sign of a or b), is
// largest at that corner over the whole rectangle; if it is negative
// there the triangle fails the test at every pixel of the rectangle and
// is skipped. A skipped triangle is never covered, so it never wins and
// the result is unchanged. The survivors (a ballot mask) are tested per
// pixel: the row-free part of each plane once per triangle (a*px), l0..l2
// for each row, then l3, l4 and the IEEE divide only where l0..l2 cover.
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
// association, built with -fmad=false: l = plane(a, b, c) in the kernel's
// policy (K1, K8: a*px + (b*yf + c); K7: (a*xl + b*yl) + (b*yb + (c +
// a*xoff))), cand = l3 / l4 (IEEE), inv_s = 1 / ((l0 + l1) + l2),
// attribute plane(aa, ab, ac) * inv_s. So the planes equal the plain
// version's bit for bit.

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

// The plane policies: how a kernel associates l = plane(a, b, c) at a
// pixel, which decides its bits at a razor edge. A policy holds one
// thread's column and its K rows and gives, per triangle and plane, the
// part that does not depend on the row (tri) and the plane at row i from
// it (row); at() is the same value in one expression, and misses() the
// corner cull of the warp's rectangle (32 columns from xw0, rows lo..hi-1
// of the thread's K) in the same association.

// K1 and K8: l = a*x + (b*y + c).
template <int K>
struct PlanesXY {
  struct Tri {
    float ax, c;
  };
  float px, x_lo, x_hi, y[K];

  // x: the thread's column, xw0: the warp's first column, y0: the first
  // of the thread's K rows (screen coordinates; px0, the tile's first
  // column, is not read)
  __device__ PlanesXY(int x, int xw0, int px0, int y0) {
    (void)px0;
    px = (float)x;
    x_lo = (float)xw0;
    x_hi = x_lo + 31.0f;
#pragma unroll
    for (int i = 0; i < K; ++i) y[i] = (float)(y0 + i);
  }
  __device__ Tri tri(float a, float b, float c) const {
    (void)b;
    return {a * px, c};
  }
  __device__ float row(const Tri& t, float b, int i) const {
    return t.ax + (b * y[i] + t.c);
  }
  __device__ float at(float a, float b, float c, int i) const {
    return a * px + (b * y[i] + c);
  }
  __device__ bool misses(float a, float b, float c, int lo, int hi) const {
    const float xs = a >= 0.0f ? x_hi : x_lo;
    const float ys = b >= 0.0f ? y[0] + (float)(hi - 1) : y[0] + (float)lo;
    return a * xs + (b * ys + c) < 0.0f;
  }
};

// K7: l = (a*xl + b*yl) + (b*yb + (c + a*xoff)), where xoff = 32*bx is
// the column brick's offset in its tile, xl = x - xoff (the tile's first
// column plus the lane), yl = y mod 4 and yb = y - yl. A thread's K rows
// start at a multiple of K and K divides 4, so they lie in one 4-row
// brick row: yb is one value, and b*yb + (c + a*xoff) is computed once
// per triangle. The cull's corner (xl at the high end when a >= 0, yl
// when b >= 0, at the warp's one yb) is a pixel of the rectangle.
template <int K>
struct PlanesBrick {
  static_assert(4 % K == 0, "a thread's rows must share a brick row");
  struct Tri {
    float ax, k;
  };
  float xl, xoff, yb, xl_lo, xl_hi, yl[K];

  __device__ PlanesBrick(int x, int xw0, int px0, int y0) {
    xoff = (float)(xw0 - px0);
    xl = (float)(x - (xw0 - px0));
    xl_lo = (float)px0;
    xl_hi = xl_lo + 31.0f;
    yb = (float)(y0 - y0 % 4);
#pragma unroll
    for (int i = 0; i < K; ++i) yl[i] = (float)((y0 + i) % 4);
  }
  __device__ Tri tri(float a, float b, float c) const {
    return {a * xl, b * yb + (c + a * xoff)};
  }
  __device__ float row(const Tri& t, float b, int i) const {
    return (t.ax + b * yl[i]) + t.k;
  }
  __device__ float at(float a, float b, float c, int i) const {
    return (a * xl + b * yl[i]) + (b * yb + (c + a * xoff));
  }
  __device__ bool misses(float a, float b, float c, int lo, int hi) const {
    const float xs = a >= 0.0f ? xl_hi : xl_lo;
    const float ys =
        b >= 0.0f ? yl[0] + (float)(hi - 1) : yl[0] + (float)lo;
    return (a * xs + b * ys) + (b * yb + (c + a * xoff)) < 0.0f;
  }
};

// True when the plane is negative on the whole rectangle of the warp's
// rows lo..hi-1 (see the header); coefficients above kCullMax are not
// culled.
template <class Planes>
__device__ __forceinline__ bool edge_misses(const Planes& pl, int ai, int bi,
                                            int ci, int lo, int hi) {
  const float a = __int_as_float(ai), b = __int_as_float(bi),
              c = __int_as_float(ci);
  if (!(fabsf(a) <= kCullMax && fabsf(b) <= kCullMax && fabsf(c) <= kCullMax))
    return false;
  return pl.misses(a, b, c, lo, hi);
}

// A triangle's depth at the thread's row i: 0 where not covered (or
// z-clipped). `g` points at its words, in shared or global memory.
template <class Planes>
__device__ __forceinline__ float depth_at(const Planes& pl, const int* g,
                                          int i, float zc, bool zclip,
                                          float* l) {
  for (int k = 0; k < 5; ++k)
    l[k] = pl.at(__int_as_float(g[k]), __int_as_float(g[5 + k]),
                 __int_as_float(g[10 + k]), i);
  const bool covered = (l[0] >= 0.0f) && (l[1] >= 0.0f) && (l[2] >= 0.0f) &&
                       (l[4] > 0.0f) && (l[3] > 0.0f) && (l[3] <= l[4]);
  float cand = covered ? l[3] / l[4] : 0.0f;
  if (zclip && !(cand < zc)) cand = 0.0f;
  return cand;
}

// One block's band: see the header. `q` yields the candidates of the tile
// (q.size(), q.visit(j, &v): v.x the first triangle, v.y = r0 << 16 | r1);
// Planes is the kernel's plane policy; x0 is the block's first column,
// px0 the tile's.
template <int K, int WX, int WY, bool ATTR, bool ZCLIP,
          template <int> class Planes, class Queue>
__device__ __forceinline__ void raster_band(
    const Queue& q, int cs, const int* __restrict__ coef,
    const float* __restrict__ seed_depth, const int* __restrict__ seed_vis,
    const float* __restrict__ seed_attr, const float* __restrict__ zclip,
    float* __restrict__ depth, int* __restrict__ vis,
    float* __restrict__ attr, int py0, int px0, int x0, int band0,
    int w_pad, size_t plane) {
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
  const Planes<K> pl(x, x0 + 32 * wx, px0, py0 + my0);
  const unsigned below = (1u << lane) - 1u;

  float acc_d[K], zc[K];
  int acc_v[K];
  float acc_a[5][K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int row = my0 + i;
    const size_t p = (size_t)(py0 + row) * w_pad + x;
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
        live = !(edge_misses(pl, w0.x, w1.y, w2.z, lo, hi) ||
                 edge_misses(pl, w0.y, w1.z, w2.w, lo, hi) ||
                 edge_misses(pl, w0.z, w1.w, w3.x, lo, hi));
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
        const auto t0 = pl.tri(a0, b0, c0), t1 = pl.tri(a1, b1, c1),
                   t2 = pl.tri(a2, b2, c2);
        const auto t3 = pl.tri(a3, b3, c3), t4 = pl.tri(a4, b4, c4);
#pragma unroll
        for (int i = 0; i < K; ++i) {
          if (i < lo || i >= hi) continue;
          const float l0 = pl.row(t0, b0, i);
          const float l1 = pl.row(t1, b1, i);
          const float l2 = pl.row(t2, b2, i);
          if (!(l0 >= 0.0f && l1 >= 0.0f && l2 >= 0.0f)) continue;
          const float l3 = pl.row(t3, b3, i);
          const float l4 = pl.row(t4, b4, i);
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
          if (depth_at(pl, g, i, zc[i], ZCLIP, l) != best[i]) continue;
          const float inv_s = 1.0f / ((l[0] + l[1]) + l[2]);
#pragma unroll
          for (int k = 0; k < 5; ++k) {
            const float val = pl.at(__int_as_float(g[16 + 3 * k]),
                                    __int_as_float(g[17 + 3 * k]),
                                    __int_as_float(g[18 + 3 * k]), i) *
                              inv_s;
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
