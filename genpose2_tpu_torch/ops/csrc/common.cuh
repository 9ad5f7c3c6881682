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

// A matmul operand rounded to the compute type T and held as float: the JAX
// reference casts the left operand to the weights' dtype before each dot
// (jnp.dot(h.astype(W.dtype), W, preferred_element_type=f32)). A bf16 x bf16
// product is exact in f32, so only the order of the f32 sums differs.
template <typename T> __device__ __forceinline__ float as_operand(float v);
template <> __device__ __forceinline__ float as_operand<float>(float v) { return v; }
template <> __device__ __forceinline__ float as_operand<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Squared distance ((dx*dx + dy*dy) + dz*dz), every operation rounded on its
// own and never contracted into an FMA: the JAX reference's order and
// rounding, so that radius tests and argmax ties agree bit for bit.
__device__ __forceinline__ float sq_dist(float x, float y, float z,
                                         float cx, float cy, float cz) {
  const float dx = __fsub_rn(x, cx), dy = __fsub_rn(y, cy), dz = __fsub_rn(z, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// One output column for ROWS rows: acc[r] = sum_k H[k * ROWS + r] * W[k * ldw + col].
// H is k-major in shared memory (16-byte aligned), so the ROWS values of one k
// are float4 broadcasts to the whole warp; W is row-major in device memory and
// neighbouring threads read neighbouring columns.
template <int ROWS, typename T>
__device__ __forceinline__ void dot_rows(const float* __restrict__ H, int K,
                                         const T* __restrict__ W, int ldw, int col,
                                         float (&acc)[ROWS]) {
  static_assert(ROWS % 4 == 0, "ROWS must be a multiple of 4");
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
  const float4* H4 = reinterpret_cast<const float4*>(H);
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float w = to_f32(W[static_cast<size_t>(k) * ldw + col]);
#pragma unroll
    for (int r4 = 0; r4 < ROWS / 4; ++r4) {
      const float4 h = H4[k * (ROWS / 4) + r4];
      acc[4 * r4 + 0] = fmaf(h.x, w, acc[4 * r4 + 0]);
      acc[4 * r4 + 1] = fmaf(h.y, w, acc[4 * r4 + 1]);
      acc[4 * r4 + 2] = fmaf(h.z, w, acc[4 * r4 + 2]);
      acc[4 * r4 + 3] = fmaf(h.w, w, acc[4 * r4 + 3]);
    }
  }
}

// Set a kernel's dynamic shared memory limit when it asks for more than 48 KB.
template <typename K>
static inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
