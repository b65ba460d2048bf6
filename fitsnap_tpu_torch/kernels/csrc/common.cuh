// Shared helpers of the port's CUDA kernels (one shared library per source,
// plain C interface, loaded with ctypes by kernels/build.py).
#pragma once

#include <cuda_runtime.h>

// Text of a CUDA error code returned by one of the launch functions.
extern "C" const char* fs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of shared memory one H100 block can use (kernels/launch.py's
// SMEM_LIMIT).
constexpr size_t FS_SMEM_LIMIT = 232448;

// Raise a kernel's dynamic shared memory limit when it needs more than the
// default 48 KB; returns the CUDA error code (0 on success).
template <typename Kernel>
static int fs_allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

// Asynchronous copy of one double (one int) from global to shared memory
// (through L1), and the wait for every copy this thread has issued.
__device__ __forceinline__ void fs_cp_async8(double* dst, const double* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void fs_cp_async4(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void fs_cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
