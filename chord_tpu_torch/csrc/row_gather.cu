// Kernel K3: slot-indexed row-table fetch.
//
// Replaces chord_tpu/ops/row_gather.py::_kernel (:71), a Pallas bank sweep
// built to avoid TPU gathers. Here: one thread per pixel, 16 channel loads
// from a (16, N) int32 table that stays in L1/L2 (2560 rows x 64 B at the
// bench size), 16 coalesced int32 plane stores. Bound by the 64 B/pixel of
// output writes. Values are int32 bit patterns end to end: exact.
// Negative slots clamp to row 0; slots >= N read zeros.
//
// Plain PyTorch version: chord_tpu_torch/ops/row_gather.py
// gather_rows_plain.

#include <cuda_runtime.h>

namespace {

constexpr int kChannels = 16;

__global__ void row_gather_kernel(const int* __restrict__ table, int n,
                                  const int* __restrict__ slot, int npix,
                                  int* __restrict__ out) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npix) return;
  int s = slot[p];
  s = s < 0 ? 0 : s;
  bool in_table = s < n;
  for (int c = 0; c < kChannels; ++c) {
    out[(size_t)c * npix + p] = in_table ? table[(size_t)c * n + s] : 0;
  }
}

}  // namespace

extern "C" int chord_row_gather(const void* table, int n, const void* slot,
                                int npix, void* out, void* stream) {
  if (npix <= 0) return 0;
  int threads = 256;
  int blocks = (npix + threads - 1) / threads;
  row_gather_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)table, n, (const int*)slot, npix, (int*)out);
  return (int)cudaGetLastError();
}
