// launch_floor: an empty kernel, to measure the fixed cost of a launch.
//
// A measuring aid, not the port of a TPU kernel. chip_smoke.py times one
// and two launches of it with the same cold-L2 CUDA-event method as the
// kernels (``launch_floor_ms``): the least time any kernel of the port can
// take by that method, against which a small kernel's time is read.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// Launches the empty kernel n times on `stream`, one CTA of one warp each.
// Returns cudaGetLastError() (0 = launched).
extern "C" int dmlc_empty_launches(int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < n; ++i) {
    empty_kernel<<<1, 32, 0, s>>>();
  }
  return static_cast<int>(cudaGetLastError());
}
