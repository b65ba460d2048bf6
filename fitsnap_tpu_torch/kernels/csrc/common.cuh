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

// The working type of a kernel that has a float32 instantiation beside its
// float64 one (the streamed linear SNAP fit, kernels/snap_kernels.py): each
// step of an expression written with these is rounded to nearest on its
// own, so nvcc never contracts it into an FMA (the TwoSum chains and the
// squared distances of K8 are written so), at either type.
__device__ __forceinline__ double fs_add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float fs_add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double fs_sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float fs_sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double fs_mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float fs_mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double fs_div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float fs_div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}

// Asynchronous copy of one element (4 or 8 bytes) from global to shared
// memory, through L1.
__device__ __forceinline__ void fs_cp_async_elem(double* dst,
                                                 const double* src) {
  fs_cp_async8(dst, src);
}
__device__ __forceinline__ void fs_cp_async_elem(float* dst,
                                                 const float* src) {
  fs_cp_async4(reinterpret_cast<int*>(dst),
               reinterpret_cast<const int*>(src));
}
