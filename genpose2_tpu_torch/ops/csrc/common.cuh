// Helpers shared by the port's kernels. Each kernel source is built on its own
// by nvcc into a shared library with a plain C interface (ops/_cuda.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

// Every library exports the CUDA error text for the codes its launch
// functions return.
extern "C" const char* gp2_strerror(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Number of floats rounded up to a multiple of 4, so that every section of a
// shared-memory layout starts 16-byte aligned.
__host__ __device__ __forceinline__ int align4(int n) { return (n + 3) & ~3; }

// Squared distance ((dx*dx + dy*dy) + dz*dz), every operation rounded on its
// own and never contracted into an FMA: the JAX reference's order and
// rounding, so that radius tests and argmax ties agree bit for bit.
__device__ __forceinline__ float sq_dist(float x, float y, float z,
                                         float cx, float cy, float cz) {
  const float dx = __fsub_rn(x, cx), dy = __fsub_rn(y, cy), dz = __fsub_rn(z, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// Set a kernel's dynamic shared memory limit when it asks for more than 48 KB.
template <typename K>
static inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
