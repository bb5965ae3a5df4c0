// Kernel K10: the palette paged sampler of the paged-texture prototype.
//
// Replaces tools/proto_paged_tex.py::paged_sample_kernel (:70). The pool
// holds every (layer, mip) image cut into 32x32-texel tiles of packed RGBA
// (1024 int32 per tile, slot = (y%32)*32 + x%32); meta holds per entry the
// first tile, tiles per row, size and average colour. Per (32,128) pixel
// block only the K=6 smallest distinct tile ids the block asks for are
// served (the palette): a pixel whose tile is among them reads its texel
// (nearest), the others get the entry's average colour, and `cov` says
// which. The palette is the function here, not a layout: the prototype
// exists to measure what it covers, so the kernel computes it exactly.
//
// Bound by the bytes of u, v, lm, out and cov (20 B a pixel) only while
// the instructions stay few: with fmodf, general floor division and K
// full palette rounds a thread issues ~1,900 instructions, which take
// longer than the bytes. One block of 16 warps per pixel block; warp w takes rows w
// and w + 16, a lane 4 consecutive columns of each, so u, v and lm arrive
// as 16-B vectors and out and cov leave as 16-B vectors, all loads issued
// before any math. Each pixel's texel is gathered as soon as its tile and
// slot are known, before the palette is (the 1.47 MB pool stays in L2),
// so the gather's latency overlaps the palette. The palette takes two
// levels and one barrier: each warp finds the K smallest distinct ids of
// its 256 pixels by rounds of a warp-wide min, the 16 lists (96 ids,
// padded with BIG) go to shared memory, and every warp takes the K
// smallest distinct of those; the rounds stop at the first that finds
// only BIG. That is exact: the K smallest distinct ids of a union are
// among the union of each part's K smallest distinct ids
// (ops/proto_paged_tex.py palette states the rule; the tests hold it to
// the plain rounds). Ids at or above BIG are never served, so they enter
// the palette as BIG.
//
// Integer semantics follow jnp: floor division and modulo, remainder(u, 1)
// with the divisor's sign, float -> int32 truncating and saturating (NaN
// -> 0). Pages are read at clamp(id, 0, n_tiles-1) (the Pallas kernel
// reads min(id, n_tiles-1)); the two differ only for a negative id, which
// needs lm at or past the number of entries.
//
// Plain PyTorch version: chord_tpu_torch/ops/proto_paged_tex.py
// paged_sample_plain.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBH = 32;                  // pixel rows per block (BH)
constexpr int kBW = 128;                 // pixel columns per block
constexpr int kK = 6;                    // palette pages per block (K)
constexpr int kTexels = 1024;            // texels per tile
constexpr int kThreads = 512;
constexpr int kMinBlocks = 2;            // resident blocks an SM (64 registers)
constexpr int kWarps = kThreads / 32;    // 16
constexpr int kRows = kBH / kWarps;      // 2 rows a warp: w and w + 16
constexpr int kCols = 4;                 // consecutive columns a lane
constexpr int kPer = kRows * kCols;      // 8 pixels a thread
constexpr int kCand = kWarps * kK / 32;  // 3 palette candidates a lane
constexpr int kBig = 1 << 30;
static_assert(32 * kCols == kBW, "a warp spans the block's width");
static_assert(kWarps * kRows == kBH, "the warps span the block's rows");
static_assert(kWarps * kK % 32 == 0, "whole candidate rows");
static_assert(kThreads == 4 * 128, "one meta word a thread");

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);   // jnp.clip: max first, then min
}

// jnp.remainder(x, 1.0): fmod(x, 1), then + 1 where it is negative.
// fmod(x, 1) is x - trunc(x) exactly (the fraction of x is representable;
// NaN for NaN and inf), but for the sign of a zero, which the caller's
// product and truncation drop.
__device__ __forceinline__ float remainder1(float x) {
  float r = __fsub_rn(x, truncf(x));
  return r < 0.0f ? __fadd_rn(r, 1.0f) : r;
}

// 4 consecutive words: one 16-B load where every pointer is 16-B aligned,
// else four 4-B loads (an offset view)
template <bool kVec, typename T4, typename T>
__device__ __forceinline__ T4 load4(const T* p) {
  if constexpr (kVec) return __ldcs(reinterpret_cast<const T4*>(p));
  return T4{__ldcs(p), __ldcs(p + 1), __ldcs(p + 2), __ldcs(p + 3)};
}

template <bool kVec>
__device__ __forceinline__ void store4(int* p, int4 x) {
  if constexpr (kVec) {
    __stcs(reinterpret_cast<int4*>(p), x);
  } else {
    __stcs(p, x.x);
    __stcs(p + 1, x.y);
    __stcs(p + 2, x.z);
    __stcs(p + 3, x.w);
  }
}

template <typename T4>
__device__ __forceinline__ auto part(const T4& a, int c) {
  return c == 0 ? a.x : c == 1 ? a.y : c == 2 ? a.z : a.w;
}

// The K smallest distinct values of the warp's N values a lane, padded
// with kBig (values are at most kBig): rounds of a warp-wide min, each
// taking the round's value out, until K or only kBig are left.
template <int N>
__device__ __forceinline__ void warp_smallest(const int (&key)[N],
                                              int (&ids)[kK]) {
  int rem[N];
#pragma unroll
  for (int j = 0; j < N; ++j) rem[j] = key[j];
#pragma unroll
  for (int k = 0; k < kK; ++k) ids[k] = kBig;
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    int m = rem[0];
#pragma unroll
    for (int j = 1; j < N; ++j) m = min(m, rem[j]);
    m = __reduce_min_sync(0xffffffffu, m);
    if (m == kBig) break;             // warp-uniform
    ids[k] = m;
#pragma unroll
    for (int j = 0; j < N; ++j) rem[j] = rem[j] == m ? kBig : rem[j];
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
proto_paged_kernel(const int* __restrict__ pool, int n_tiles,
                   const int* __restrict__ meta, const float* __restrict__ u,
                   const float* __restrict__ v, const int* __restrict__ lm,
                   int w, int* __restrict__ out, int* __restrict__ cov) {
  __shared__ int s_meta[4 * 128];
  __shared__ int s_cand[kWarps * kK];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const size_t p0 = (size_t)(blockIdx.y * kBH + warp) * w +
                    blockIdx.x * kBW + lane * kCols;
  const size_t step = (size_t)kWarps * w;

  float4 uu[kRows], vv[kRows];
  int4 ll[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    uu[r] = load4<kVec, float4>(u + p0 + r * step);
    vv[r] = load4<kVec, float4>(v + p0 + r * step);
    ll[r] = load4<kVec, int4>(lm + p0 + r * step);
  }
  s_meta[threadIdx.x] = __ldg(meta + threadIdx.x);
  __syncthreads();

  // per pixel: its palette key (its tile, kBig if untextured or at or
  // above kBig), its texel (gathered now, used if the palette serves it)
  // and its entry (-1: untextured)
  int key[kPer], texel[kPer], entry[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int r = j / kCols, c = j % kCols;
    const int l = part(ll[r], c);
    const int lc = clampi(l, 0, 127);
    const int base = s_meta[lc], tiles_x = s_meta[128 + lc];
    const int size = s_meta[256 + lc];
    const float sf = (float)size;
    const int xt = clampi(
        __float2int_rz(__fmul_rn(remainder1(part(uu[r], c)), sf)), 0,
        size - 1);
    const int yt = clampi(
        __float2int_rz(__fmul_rn(remainder1(part(vv[r], c)), sf)), 0,
        size - 1);
    // floor division and modulo by 32: an arithmetic shift and a mask
    const int t = base + (yt >> 5) * tiles_x + (xt >> 5);
    const int slot = (yt & 31) * 32 + (xt & 31);
    entry[j] = l < 0 ? -1 : lc;
    key[j] = l < 0 ? kBig : min(t, kBig);
    texel[j] = key[j] < kBig
                   ? __ldg(pool + (size_t)clampi(t, 0, n_tiles - 1) * kTexels +
                           slot)
                   : 0;
  }

  // the palette: each warp's K smallest distinct ids, then the K smallest
  // distinct of the 16 lists
  int ids[kK];
  warp_smallest(key, ids);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kK; ++k) s_cand[warp * kK + k] = ids[k];
  }
  __syncthreads();
  int cand[kCand];
#pragma unroll
  for (int q = 0; q < kCand; ++q)
    cand[q] = s_cand[lane + 32 * q];
  warp_smallest(cand, ids);

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    int o[kCols], cv[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int j = r * kCols + c;
      bool hit = false;
#pragma unroll
      for (int k = 0; k < kK; ++k) hit = hit || key[j] == ids[k];
      const bool covered = hit && key[j] < kBig;
      o[c] = entry[j] < 0 ? -1 : covered ? texel[j] : s_meta[384 + entry[j]];
      cv[c] = (covered || entry[j] < 0) ? 1 : 0;
    }
    store4<kVec>(out + p0 + r * step, int4{o[0], o[1], o[2], o[3]});
    store4<kVec>(cov + p0 + r * step, int4{cv[0], cv[1], cv[2], cv[3]});
  }
}

}  // namespace

extern "C" int chord_proto_paged_sample(const void* pool, int n_tiles,
                                        const void* meta, const void* u,
                                        const void* v, const void* lm, int h,
                                        int w, void* out, void* cov,
                                        void* stream) {
  if (h <= 0 || w <= 0) return 0;
  dim3 grid(w / kBW, h / kBH);
  // rows are 512 B multiples (w % 128 == 0): the bases decide alignment
  const bool vec = ((uintptr_t)u | (uintptr_t)v | (uintptr_t)lm |
                    (uintptr_t)out | (uintptr_t)cov) % 16 == 0;
  auto kernel = vec ? proto_paged_kernel<true> : proto_paged_kernel<false>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)pool, n_tiles, (const int*)meta, (const float*)u,
      (const float*)v, (const int*)lm, w, (int*)out, (int*)cov);
  return (int)cudaGetLastError();
}
