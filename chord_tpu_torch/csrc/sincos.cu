// The sincos kernel: f32 sin and cos as chord_tpu's XLA computes them.
//
// Replaces no Pallas kernel. chord_tpu's XLA calls the C library's sinf
// and cosf for an f32 sin or cos on the CPU, where its goldens are made;
// CUDA's sinf and cosf (and PyTorch's) round otherwise, which moved RTAO's
// and the specular GI's ray directions by an ulp on 7-10% of rays. This
// kernel is glibc's sinf / cosf (>= 2.28, ARM's optimized-routines
// algorithm) in f64 with the library's own constants: the tiny and small
// branches, the fast reduction by pi/2 below 120 and the 4/pi integer
// reduction above, one rounding an operation (built with -fmad=false). The
// library's FMA build (what an x86-64 CPU with FMA runs) fuses the fast
// reduction x - n * pi/2; it is computed here exactly as (x - n * hi) -
// n * lo with pi/2 = hi + lo split into 26 and 27 significant bits (both
// products and the first difference exact). Its fused polynomial steps
// change no f32 result in (-120, 120), so they stay unfused (ops/_util.py
// says more).
// One launch returns both planes: the reduction and the quadrant are
// shared, each thread evaluates both polynomials.
//
// What bounds it on the H100: 12 bytes an element (4 in, 8 out), about 24
// f64 operations; at the frame's planes (90x160 for the PCSS rotation and
// the GGX azimuth at 1280x720, 360x640 for each RTAO ray) the launch, not
// either: 0.0025-0.0033 ms a call against a 0.0020 ms launch floor, about
// half of torch.sin + torch.cos (PERF.md). One element a thread,
// 256-thread blocks, 32-bit indices.
//
// Plain PyTorch version: chord_tpu_torch/ops/_util.py sincosf_plain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__constant__ uint32_t kInvPio4[24] = {
    0xa2u,       0xa2f9u,     0xa2f983u,   0xa2f9836eu, 0xf9836e4eu,
    0x836e4e44u, 0x6e4e4415u, 0x4e441529u, 0x441529fcu, 0x1529fc27u,
    0x29fc2757u, 0xfc2757d1u, 0x2757d1f5u, 0x57d1f534u, 0xd1f534ddu,
    0xf534ddc0u, 0x34ddc0dbu, 0xddc0db62u, 0xc0db6295u, 0xdb629599u,
    0x6295993cu, 0x95993c43u, 0x993c4390u, 0x3c439041u};

constexpr double kHpiInv = 0x1.45f306dc9c883p+23;   // 2^24 * 2 / pi
constexpr double kHpiHi = 0x1.921fb5p+0;            // pi / 2 = hi + lo
constexpr double kHpiLo = 0x1.110b46p-26;
constexpr double kPi63 = 0x1.921fb54442d18p-62;
constexpr double kC0 = 0x1p+0, kC1 = -0x1.ffffffd0c621cp-2,
                 kC2 = 0x1.55553e1068f19p-5, kC3 = -0x1.6c087e89a359dp-10,
                 kC4 = 0x1.99343027bf8c3p-16;
constexpr double kS1 = -0x1.555545995a603p-3, kS2 = 0x1.1107605230bc4p-7,
                 kS3 = -0x1.994eb3774cf24p-13;

__device__ __forceinline__ uint32_t top12(uint32_t bits) {
  return (bits >> 20) & 0x7ff;
}

// glibc's sinf_poly of table 0: the sine and the cosine polynomial
__device__ __forceinline__ void poly(double x, double x2, double* sn,
                                     double* cs) {
  const double x3 = x * x2;
  const double ps = kS2 + x2 * kS3;
  const double x7 = x3 * x2;
  const double s = x + x3 * kS1;
  *sn = s + x7 * ps;
  const double x4 = x2 * x2;
  const double pc2 = kC3 + x2 * kC4;
  const double pc1 = kC0 + x2 * kC1;
  const double x6 = x4 * x2;
  const double c = pc1 + x4 * kC2;
  *cs = c + x6 * pc2;
}

// glibc's reduce_large: x's mantissa times 96 bits of 4/pi
__device__ __forceinline__ double reduce_large(uint32_t xi, int* np) {
  const uint32_t* arr = &kInvPio4[(xi >> 26) & 15];
  const int shift = (xi >> 23) & 7;
  xi = (xi & 0xffffff) | 0x800000;
  xi <<= shift;
  uint64_t res0 = xi * arr[0];
  const uint64_t res1 = (uint64_t)xi * arr[4];
  const uint64_t res2 = (uint64_t)xi * arr[8];
  res0 = (res2 >> 32) | (res0 << 32);
  res0 += res1;
  const uint64_t n = (res0 + (1ull << 61)) >> 62;
  res0 -= n << 62;
  *np = (int)n;
  return (double)(int64_t)res0 * kPi63;
}

__global__ void __launch_bounds__(kThreads)
sincos_kernel(const float* __restrict__ in, float* __restrict__ out_sin,
              float* __restrict__ out_cos, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float y = in[i];
  const uint32_t bits = __float_as_uint(y);
  const uint32_t top = top12(bits);
  double x = (double)y;
  float s_out, c_out;
  if (top < 0x3f4) {                       // |y| < 0.75
    if (top < 0x398) {                     // |y| < 2^-12
      s_out = y;
      c_out = 1.0f;
    } else {
      double sn, cs;
      poly(x, x * x, &sn, &cs);
      s_out = (float)sn;
      c_out = (float)cs;
    }
  } else if (top < 0x7f8) {                // finite
    int n, q;
    if (top < 0x42f) {                     // |y| < 120: reduce_fast
      const double r = x * kHpiInv;
      n = ((int32_t)r + 0x800000) >> 24;
      x = (x - n * kHpiHi) - n * kHpiLo;
      q = n;
    } else {
      x = reduce_large(bits, &n);
      q = n + (int)(bits >> 31);
    }
    q &= 3;
    const double sign = (q == 1 || q == 2) ? -1.0 : 1.0;
    double sn, cs;
    poly(x * sign, x * x, &sn, &cs);
    if (q & 2) cs = -cs;                   // table 1: cosine negated
    if (n & 1) {
      s_out = (float)cs;
      c_out = (float)sn;
    } else {
      s_out = (float)sn;
      c_out = (float)cs;
    }
  } else {                                 // inf, nan
    s_out = c_out = __int_as_float(0x7fc00000);
  }
  out_sin[i] = s_out;
  out_cos[i] = c_out;
}

}  // namespace

extern "C" int chord_sincosf(const float* in, float* out_sin, float* out_cos,
                             int n, void* stream) {
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  sincos_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      in, out_sin, out_cos, n);
  return (int)cudaGetLastError();
}
