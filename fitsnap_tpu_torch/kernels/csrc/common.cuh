// Shared helpers of the port's CUDA kernels (one shared library per source,
// plain C interface, loaded with ctypes by kernels/build.py).
#pragma once

#include <cuda_runtime.h>

// Text of a CUDA error code returned by one of the launch functions.
extern "C" const char* fs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Raise a kernel's dynamic shared memory limit when it needs more than the
// default 48 KB; returns the CUDA error code (0 on success).
template <typename Kernel>
static int fs_allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}
