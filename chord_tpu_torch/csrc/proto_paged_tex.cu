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
// One block of 512 threads per pixel block, 8 pixels a thread (column
// tid%128, rows tid/128 + 4j): the index math in registers, six rounds of
// a block-wide min (warp reduce + shared memory) over the remaining tile
// ids, then every pixel resolves against the six ids and reads its texel
// from the pool in device memory (1.47 MB at the tool's size: L2-resident).
// Bound by the bytes of u, v, lm, out and cov.
//
// Integer semantics follow jnp: floor division and modulo, remainder(u, 1)
// with the divisor's sign, float -> int32 truncating and saturating (NaN
// -> 0). Pages are read at clamp(id, 0, n_tiles-1) (the Pallas kernel
// reads min(id, n_tiles-1)); the two differ only for a negative id, which
// needs lm at or past the number of entries.
//
// Plain PyTorch version: chord_tpu_torch/ops/proto_paged_tex.py
// paged_sample_plain.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kBH = 32;           // pixel rows per block (BH)
constexpr int kBW = 128;          // pixel columns per block
constexpr int kK = 6;             // palette pages per block (K)
constexpr int kTexels = 1024;     // texels per tile
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kThreads / kBW;       // 4 rows per pass
constexpr int kPer = kBH / kRows;           // 8 pixels per thread
constexpr int kBig = 1 << 30;

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int floormod(int a, int b) {
  int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);   // jnp.clip: max first, then min
}

// jnp.remainder(x, 1.0): fmod, then + 1 where the result is negative
__device__ __forceinline__ float remainder1(float x) {
  float r = fmodf(x, 1.0f);
  return r < 0.0f ? __fadd_rn(r, 1.0f) : r;
}

__device__ __forceinline__ int block_min(int v, int* red) {
  v = __reduce_min_sync(0xffffffffu, v);
  int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = threadIdx.x < kWarps ? red[threadIdx.x] : INT_MAX;
    w = __reduce_min_sync(0xffffffffu, w);
    if (threadIdx.x == 0) red[kWarps] = w;
  }
  __syncthreads();
  return red[kWarps];
}

__global__ void __launch_bounds__(kThreads)
proto_paged_kernel(const int* __restrict__ pool, int n_tiles,
                   const int* __restrict__ meta, const float* __restrict__ u,
                   const float* __restrict__ v, const int* __restrict__ lm,
                   int w, int* __restrict__ out, int* __restrict__ cov) {
  __shared__ int s_meta[4 * 128];
  __shared__ int s_red[kWarps + 1];
  for (int i = threadIdx.x; i < 4 * 128; i += kThreads) s_meta[i] = meta[i];
  __syncthreads();

  const int col = blockIdx.x * kBW + threadIdx.x % kBW;
  const int row0 = blockIdx.y * kBH + threadIdx.x / kBW;
  int tile[kPer], slot[kPer], avg[kPer];
  bool untextured[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    size_t p = (size_t)(row0 + kRows * j) * w + col;
    int l = lm[p];
    int lc = clampi(l, 0, 127);
    int base = s_meta[lc], tiles_x = s_meta[128 + lc];
    int size = s_meta[256 + lc];
    avg[j] = s_meta[384 + lc];
    float sf = (float)size;
    int xt = clampi(__float2int_rz(__fmul_rn(remainder1(u[p]), sf)), 0,
                    size - 1);
    int yt = clampi(__float2int_rz(__fmul_rn(remainder1(v[p]), sf)), 0,
                    size - 1);
    int t = base + floordiv(yt, 32) * tiles_x + floordiv(xt, 32);
    slot[j] = floormod(yt, 32) * 32 + floormod(xt, 32);
    untextured[j] = l < 0;
    tile[j] = untextured[j] ? kBig : t;
  }

  // the palette: the K smallest distinct tile ids of the block
  int ids[kK];
  int remaining[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) remaining[j] = tile[j];
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    int m = remaining[0];
#pragma unroll
    for (int j = 1; j < kPer; ++j) m = min(m, remaining[j]);
    int cur = block_min(m, s_red);
    ids[k] = cur;
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      remaining[j] = remaining[j] == cur ? kBig : remaining[j];
    __syncthreads();    // s_red is written again in the next round
  }

#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    size_t p = (size_t)(row0 + kRows * j) * w + col;
    bool covered = false;
    int texel = 0;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      if (tile[j] == ids[k]) {
        covered = true;
        int page = clampi(ids[k], 0, n_tiles - 1);
        texel = pool[(size_t)page * kTexels + slot[j]];
      }
    }
    covered = covered && tile[j] < kBig;
    int o = covered ? texel : avg[j];
    out[p] = untextured[j] ? -1 : o;
    cov[p] = (covered || untextured[j]) ? 1 : 0;
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
  proto_paged_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)pool, n_tiles, (const int*)meta, (const float*)u,
      (const float*)v, (const int*)lm, w, (int*)out, (int*)cov);
  return (int)cudaGetLastError();
}
