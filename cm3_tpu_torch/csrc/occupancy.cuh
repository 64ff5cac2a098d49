// How a built kernel occupies an SM, for the wrappers' occupancy() (the C
// entries cm3_*_rollout_occupancy): out[0] registers per thread, out[1]
// resident blocks per SM at `threads` per block, out[2] threads per block,
// out[3] local memory bytes per thread (spills).  Returns a CUDA error
// code.
#pragma once
#include <cuda_runtime.h>

inline int kernel_occupancy(const void* kernel, int threads, int* out) {
  cudaFuncAttributes attr{};
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  out[1] = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kernel,
                                                        threads, 0);
  out[0] = attr.numRegs;
  out[2] = threads;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(err);
}
