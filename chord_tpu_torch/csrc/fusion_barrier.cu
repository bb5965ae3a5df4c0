// Kernel K9: the fusion barrier, a byte-exact copy into a new buffer.
//
// Replaces chord_tpu/ops/fusion_barrier.py::_copy_kernel (:29), a Pallas
// identity copy whose custom call ends an XLA fusion. Here it is an opaque,
// materialising copy: the result is a new allocation that no producer
// writes into and no consumer reads through (it is opaque to torch.compile
// too, which cannot trace a ctypes launch).
//
// What bounds it on the H100: at its one caller's size (the repro tool's
// tm_pallas, 129,600 B) the launch and one memory round trip, not the
// bytes (0.00008 ms at the memory rate). One 16-byte vector a thread in
// 256-thread blocks with 32-bit indices, when both pointers are 16-byte
// aligned; the last block's first threads copy the bytes past the last
// whole vector. An unaligned buffer is copied byte by byte. The previous
// design (a 64-bit grid-stride loop, then a grid-stride loop over the
// tail) took 0.00211 ms where this one takes 0.00193 and x.clone()
// 0.00195; 128-thread blocks (64 blocks), 2 or 4 vectors a thread with
// the loads before the stores, and 64-thread blocks were no faster (H100
// 80GB HBM3 at 700 W, kernel_ab.py, the designs and clone in turns;
// PERF.md section 6).
//
// Plain PyTorch version: chord_tpu_torch/ops/fusion_barrier.py
// fusion_barrier_plain (x.clone()).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
copy16_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
              unsigned nvec, const unsigned char* __restrict__ src_b,
              unsigned char* __restrict__ dst_b, unsigned tail) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i < nvec) dst[i] = src[i];
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x < tail) {
    const size_t b = (size_t)nvec * 16 + threadIdx.x;
    dst_b[b] = src_b[b];
  }
}

__global__ void __launch_bounds__(kThreads)
copy1_kernel(const unsigned char* __restrict__ src,
             unsigned char* __restrict__ dst, long long nbytes) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
       b < nbytes; b += stride)
    dst[b] = src[b];
}

}  // namespace

extern "C" int chord_fusion_barrier(const void* src, void* dst,
                                    long long nbytes, void* stream) {
  if (nbytes <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const auto* s = (const unsigned char*)src;
  auto* d = (unsigned char*)dst;
  if ((uintptr_t)src % 16 == 0 && (uintptr_t)dst % 16 == 0) {
    const long long nvec = nbytes / 16;
    if (nvec >= (1ll << 32)) return (int)cudaErrorInvalidValue;
    const unsigned blocks = nvec ? (unsigned)((nvec + kThreads - 1) / kThreads)
                                 : 1u;
    copy16_kernel<<<blocks, kThreads, 0, st>>>(
        (const uint4*)src, (uint4*)dst, (unsigned)nvec, s, d,
        (unsigned)(nbytes % 16));
  } else {
    const long long blocks = (nbytes + kThreads - 1) / kThreads;
    copy1_kernel<<<(unsigned)(blocks < 132 * 16 ? blocks : 132 * 16),
                   kThreads, 0, st>>>(s, d, nbytes);
  }
  return (int)cudaGetLastError();
}
