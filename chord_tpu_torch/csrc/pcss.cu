// Kernel K6: PCSS sun visibility (blocker search, penumbra, variable-radius
// PCF) over the cascaded shadow-map stack.
//
// Replaces chord_tpu/ops/shadow_kernel.py::_pcss_kernel (:145, reached through
// evaluate_shadow_pallas :254). That kernel picks one cascade per 32x32 tile,
// decimates the map to a level pyramid, DMAs a 128x384 window per tile and
// resolves every tap with one-hot matmuls, all because the TPU cannot
// gather. None of that is the function: the function is evaluate_shadow
// (chord_tpu/ops/shadow.py:199-316), per pixel: read the prepass values
// (cascade, u, v, z_cmp, z_recv, disk rotation ca/sa, the cascade's depth
// span and texel size), make the blocker taps, the penumbra and the PCF
// taps straight from maps[c*R*R + y*R + x], and write `lit` (1 outside
// every cascade).
//
// Bound: at the bench size the eval grid is 90x160 and the stack 4x1024^2
// f32 (16.8 MB, resident in the 50 MB L2 after the cascade raster wrote
// it), of which the taps touch well under a megabyte. The call is latency
// bound: three dependent rounds of loads (the prepass, the blocker taps,
// the PCF taps, whose radius needs the blocker average) behind the launch.
// So every round is issued at once: the prepass loads go out with the
// cascade's, before the branch on it, and the cascade's depth span and
// texel size with the blocker taps; the tap counts are template
// arguments, so each tap loop unrolls and its loads are in flight
// together; and small blocks (225 of 64 threads at the bench size)
// spread the gathers over the SMs. The bench's counts (5, 6) have their own
// instance; every other count in [1, 16] runs the generic one (counts at
// run time, loops unrolled to 16 with an exit).
//
// Numerics follow the plain version (chord_tpu_torch/ops/shadow.py
// pcss_plain) operation for operation: taps truncate (u+du) toward zero
// (saturating, NaN -> 0) and clamp to [0, R-1]; the penumbra is
// max(avg-z,0)*depth_span*light_size/max(texel,1e-6) left to right; every
// division is IEEE; built with -fmad=false, so results are bit-equal.

#include <cuda_runtime.h>

// the fixed disk offsets and scalars, by value (global scope so the
// exported entry point's parameter type is visible to the linker)
struct PcssParams {
  float blk[16][2];    // blocker offsets, pre-scaled by the search radius
  float pcf[16][2];    // PCF offsets, scaled per pixel by the PCF radius
  int n_blk;
  int n_pcf;
  float pcf_radius;    // base PCF radius (texels)
  float pcf_radius_max;
  float light_size;    // tan(sun half-angle) in world units per unit depth
};

namespace {

constexpr int kThreads = 64;
constexpr int kMaxTaps = 16;

// torch.clamp semantics: a NaN input stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ int tap_coord(float a, int r) {
  int i = __float2int_rz(a);  // toward zero, saturating; NaN -> 0
  return i < 0 ? 0 : (i > r - 1 ? r - 1 : i);
}

// kNB / kNP: the tap counts, 0 for p.n_blk / p.n_pcf at run time
template <int kNB, int kNP>
__global__ void __launch_bounds__(kThreads)
pcss_kernel(const float* __restrict__ maps, int r,
            const int* __restrict__ cascade, const float* __restrict__ u,
            const float* __restrict__ v, const float* __restrict__ z_cmp,
            const float* __restrict__ z_recv, const float* __restrict__ ca,
            const float* __restrict__ sa,
            const float* __restrict__ depth_range,
            const float* __restrict__ texel, int npix, const PcssParams p,
            float* __restrict__ out) {
  const int nb = kNB > 0 ? kNB : p.n_blk;
  const int np = kNP > 0 ? kNP : p.n_pcf;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= npix) return;
  const int c = cascade[i];
  const float pu = u[i], pv = v[i], zc = z_cmp[i], zr = z_recv[i];
  const float cs = ca[i], sn = sa[i];
  if (c < 0) {
    out[i] = 1.0f;
    return;
  }
  // the cascade's scalars load beside the blocker taps, not after them
  const float span = depth_range[c], tx = texel[c];
  const float* map = maps + (size_t)c * r * r;

  float bsum = 0.0f, bcnt = 0.0f;
#pragma unroll
  for (int s = 0; s < (kNB > 0 ? kNB : kMaxTaps); ++s) {
    if (s >= nb) break;
    float ox = p.blk[s][0] * cs - p.blk[s][1] * sn;
    float oy = p.blk[s][0] * sn + p.blk[s][1] * cs;
    float zs = map[tap_coord(pv + oy, r) * r + tap_coord(pu + ox, r)];
    if (zs > zc) {  // reverse-Z: nearer the light
      bsum = bsum + zs;
      bcnt = bcnt + 1.0f;
    }
  }
  float pen = 0.0f;
  if (bcnt > 0.0f) {
    float avg = bsum / clamp_min(bcnt, 1.0f);
    float delta = clamp_min(avg - zr, 0.0f) * span;
    pen = delta * p.light_size / clamp_min(tx, 1e-6f);
  }
  float pcf_r = clamp(p.pcf_radius + pen, 1.0f, p.pcf_radius_max);

  float lit = 0.0f;
#pragma unroll
  for (int s = 0; s < (kNP > 0 ? kNP : kMaxTaps); ++s) {
    if (s >= np) break;
    float ox = (p.pcf[s][0] * cs - p.pcf[s][1] * sn) * pcf_r;
    float oy = (p.pcf[s][0] * sn + p.pcf[s][1] * cs) * pcf_r;
    float zs = map[tap_coord(pv + oy, r) * r + tap_coord(pu + ox, r)];
    lit = lit + (zc >= zs ? 1.0f : 0.0f);
  }
  out[i] = lit / (float)np;
}

}  // namespace

extern "C" int chord_pcss(const void* maps, int r, const void* cascade,
                          const void* u, const void* v, const void* z_cmp,
                          const void* z_recv, const void* ca, const void* sa,
                          const void* depth_range, const void* texel,
                          int npix, PcssParams params, void* out,
                          void* stream) {
  if (npix <= 0) return 0;
  auto kernel = params.n_blk == 5 && params.n_pcf == 6 ? pcss_kernel<5, 6>
                                                       : pcss_kernel<0, 0>;
  kernel<<<(npix + kThreads - 1) / kThreads, kThreads, 0,
           (cudaStream_t)stream>>>(
      (const float*)maps, r, (const int*)cascade, (const float*)u,
      (const float*)v, (const float*)z_cmp, (const float*)z_recv,
      (const float*)ca, (const float*)sa, (const float*)depth_range,
      (const float*)texel, npix, params, (float*)out);
  return (int)cudaGetLastError();
}
