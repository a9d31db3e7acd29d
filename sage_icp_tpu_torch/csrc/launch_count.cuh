// The launch count of a kernel, kept on the device (ops/cuda_lib.py).
//
// Every kernel takes a pointer to its own 64-bit counter and calls
// count_launch first: the first thread of the first block adds one. A
// launch replayed from a captured CUDA graph is counted as one made from
// the host, and a launch that does no work (a stopped ICP loop) counts
// too. A null pointer counts nothing.

#pragma once

#include <cuda_runtime.h>

namespace sage {

__device__ __forceinline__ void count_launch(unsigned long long* launches) {
  if (launches != nullptr && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&
      threadIdx.x == 0 && threadIdx.y == 0 && threadIdx.z == 0) {
    atomicAdd(launches, 1ULL);
  }
}

}  // namespace sage
