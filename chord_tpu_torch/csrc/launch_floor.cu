// The launch floor: an empty kernel on a one-block grid.
//
// Not a port of a TPU kernel. chip_smoke.py times it as it times the
// kernels (queued behind a device-side sleep), so a kernel's time can be
// read against the least time any launch takes on the same card and
// stream: a bound below this floor cannot be reached by a launched grid.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int chord_launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
