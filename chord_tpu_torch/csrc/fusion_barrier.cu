// Kernel K9: the fusion barrier, a byte-exact copy into a new buffer.
//
// Replaces chord_tpu/ops/fusion_barrier.py::_copy_kernel (:29), a Pallas
// identity copy whose custom call ends an XLA fusion. Here it is an opaque,
// materialising copy: the result is a new allocation that no producer
// writes into and no consumer reads through (it is opaque to torch.compile
// too, which cannot trace a ctypes launch).
//
// Grid-stride loop over 16-byte vectors when both pointers are 16-byte
// aligned, then the bytes past the last whole vector one at a time; an
// unaligned buffer is copied byte by byte. Bound by the bytes it moves
// (each byte read once and written once).
//
// Plain PyTorch version: chord_tpu_torch/ops/fusion_barrier.py
// fusion_barrier_plain (x.clone()).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;   // 16 blocks per SM

__global__ void __launch_bounds__(kThreads)
copy_kernel(const uint4* __restrict__ src16, uint4* __restrict__ dst16,
            long long nvec, const unsigned char* __restrict__ src,
            unsigned char* __restrict__ dst, long long tail_start,
            long long nbytes) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long k = i; k < nvec; k += stride) dst16[k] = src16[k];
  for (long long b = tail_start + i; b < nbytes; b += stride) dst[b] = src[b];
}

}  // namespace

extern "C" int chord_fusion_barrier(const void* src, void* dst,
                                    long long nbytes, void* stream) {
  if (nbytes <= 0) return 0;
  bool aligned = ((uintptr_t)src % 16 == 0) && ((uintptr_t)dst % 16 == 0);
  long long nvec = aligned ? nbytes / 16 : 0;
  long long tail_start = nvec * 16;
  long long work = nvec > nbytes - tail_start ? nvec : nbytes - tail_start;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  copy_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)src, (uint4*)dst, nvec, (const unsigned char*)src,
      (unsigned char*)dst, tail_start, nbytes);
  return (int)cudaGetLastError();
}
