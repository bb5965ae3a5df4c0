// The powf kernel: f32 x ** y for a float y as chord_tpu's XLA computes it.
//
// Replaces no Pallas kernel. chord_tpu's `x ** 8.0` (the specular filters'
// edge weight, chord_tpu/ops/screen_probe.py:631) is an XLA power, which
// its CPU build, where its goldens are made, computes by the C library's
// powf; CUDA's powf (and PyTorch's pow) round otherwise. This kernel is
// glibc's powf (>= 2.28, ARM's optimized-routines algorithm) in f64 with
// the library's own constants: log2(x) from a 16-entry table and a degree-5
// polynomial, times y, then 2^(y log2 x) from a 32-entry table and a
// cubic, one rounding an operation (built with -fmad=false). The library's
// FMA build fuses the reduction r = z * invc - 1; it is computed here
// exactly as (z * hi - 1) + z * lo with invc = hi + lo split into 26 and 27
// significant bits (z has 24: both products and the difference exact).
// Its fused polynomial steps change no f32 result on the inputs checked
// (every f32 in [2^-126, 1] with y = 8), so they stay unfused. As XLA's
// threads run with FTZ and DAZ, a zero or subnormal x gives 0 and a result
// below 2^-126 is flushed to 0 (ops/_util.py says more).
//
// What bounds it on the H100: 8 bytes an element (4 in, 4 out), about 30
// f64 operations; at the frame's planes (the specular filters' 8 and 12
// weight planes of 90x160 at 1280x720) the launch. One element a thread,
// 256-thread blocks, 32-bit indices.
//
// Plain PyTorch version: chord_tpu_torch/ops/_util.py powf_plain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// __powf_log2_data: logc, invc; the poly
__constant__ double kLogc[16] = {
    -0x1.efec65b963019p-2, -0x1.b0b6832d4fca4p-2, -0x1.7418b0a1fb77bp-2,
    -0x1.39de91a6dcf7bp-2, -0x1.01d9bf3f2b631p-2, -0x1.97c1d1b3b7afp-3,
    -0x1.2f9e393af3c9fp-3, -0x1.960cbbf788d5cp-4, -0x1.a6f9db6475fcep-5,
    0x0p+0,                0x1.338ca9f24f53dp-4,  0x1.476a9543891bap-3,
    0x1.e840b4ac4e4d2p-3,  0x1.40645f0c6651cp-2,  0x1.88e9c2c1b9ff8p-2,
    0x1.ce0a44eb17bccp-2};
__constant__ double kInvc[16] = {
    0x1.661ec79f8f3bep+0, 0x1.571ed4aaf883dp+0, 0x1.49539f0f010bp+0,
    0x1.3c995b0b80385p+0, 0x1.30d190c8864a5p+0, 0x1.25e227b0b8eap+0,
    0x1.1bb4a4a1a343fp+0, 0x1.12358f08ae5bap+0, 0x1.0953f419900a7p+0,
    0x1p+0,               0x1.e608cfd9a47acp-1, 0x1.ca4b31f026aap-1,
    0x1.b2036576afce6p-1, 0x1.9c2d163a1aa2dp-1, 0x1.886e6037841edp-1,
    0x1.767dcf5534862p-1};
constexpr double kA0 = 0x1.27616c9496e0bp-2, kA1 = -0x1.71969a075c67ap-2,
                 kA2 = 0x1.ec70a6ca7baddp-2, kA3 = -0x1.7154748bef6c8p-1,
                 kA4 = 0x1.71547652ab82bp0;
// __exp2f_data: tab[i] = bits(2^(i/32)) - (i << 47); the poly
__constant__ uint64_t kExp2[32] = {
    0x3ff0000000000000ull, 0x3fefd9b0d3158574ull, 0x3fefb5586cf9890full,
    0x3fef9301d0125b51ull, 0x3fef72b83c7d517bull, 0x3fef54873168b9aaull,
    0x3fef387a6e756238ull, 0x3fef1e9df51fdee1ull, 0x3fef06fe0a31b715ull,
    0x3feef1a7373aa9cbull, 0x3feedea64c123422ull, 0x3feece086061892dull,
    0x3feebfdad5362a27ull, 0x3feeb42b569d4f82ull, 0x3feeab07dd485429ull,
    0x3feea47eb03a5585ull, 0x3feea09e667f3bcdull, 0x3fee9f75e8ec5f74ull,
    0x3feea11473eb0187ull, 0x3feea589994cce13ull, 0x3feeace5422aa0dbull,
    0x3feeb737b0cdc5e5ull, 0x3feec49182a3f090ull, 0x3feed503b23e255dull,
    0x3feee89f995ad3adull, 0x3feeff76f2fb5e47ull, 0x3fef199bdd85529cull,
    0x3fef3720dcef9069ull, 0x3fef5818dcfba487ull, 0x3fef7c97337b9b5full,
    0x3fefa4afa2a490daull, 0x3fefd0765b6e4540ull};
constexpr double kC0 = 0x1.c6af84b912394p-5, kC1 = 0x1.ebfce50fac4f3p-3,
                 kC2 = 0x1.62e42ff0c52d6p-1;
constexpr double kShift = 0x1.8p+47;      // 0x1.8p52 / 32
constexpr double kOflow = 0x1.fffffffd1d571p+6;

__device__ __forceinline__ void split26(double v, double* hi, double* lo) {
  const double c = v * 134217729.0;
  *hi = c - (c - v);
  *lo = v - *hi;
}

__global__ void __launch_bounds__(kThreads)
powf_kernel(const float* __restrict__ in, float* __restrict__ out, float yf,
            int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float x = in[i];
  const uint32_t ix = __float_as_uint(x);
  float res;
  if (x != x || x < 0.0f) {
    res = __int_as_float(0x7fc00000);
  } else if (x < 0x1p-126f) {              // zero, or flushed (DAZ)
    res = 0.0f;
  } else if (ix == 0x7f800000u) {
    res = __int_as_float(0x7f800000);
  } else {
    const uint32_t tmp = ix - 0x3f330000u;
    const int j = (tmp >> 19) & 15;
    const uint32_t top = tmp & 0xff800000u;
    const double z = (double)__uint_as_float(ix - top);
    const int k = (int32_t)top >> 23;
    double hi, lo;
    split26(kInvc[j], &hi, &lo);
    const double r = (z * hi - 1.0) + z * lo;
    const double r2 = r * r;
    double lg = kA0 * r + kA1;
    const double p = kA2 * r + kA3;
    const double r4 = r2 * r2;
    double q = kA4 * r + (kLogc[j] + (double)k);
    q = p * r2 + q;
    lg = lg * r4 + q;
    const double e = (double)yf * lg;
    if (e > kOflow) {
      res = __int_as_float(0x7f800000);
    } else if (e <= -150.0) {
      res = 0.0f;
    } else {
      const double kd = (e + kShift) - kShift;
      const double rr = e - kd;
      const int64_t kk = (int64_t)(kd * 32.0);
      const uint64_t t = kExp2[kk & 31] + (uint64_t)(kk * (1ll << 47));
      const double s = __longlong_as_double((long long)t);
      const double zz = kC0 * rr + kC1;
      double v = zz * (rr * rr) + (kC2 * rr + 1.0);
      res = (float)(v * s);
      if (res < 0x1p-126f) res = 0.0f;     // FTZ
    }
  }
  out[i] = res;
}

}  // namespace

extern "C" int chord_powf(const float* in, float* out, float y, int n,
                          void* stream) {
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  powf_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(in, out, y, n);
  return (int)cudaGetLastError();
}
