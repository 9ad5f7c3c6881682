// LayerNorm over rows, with or without a residual add, three entry points:
//   gp2_residual_ln: ln = LN(x + h)
//   gp2_add_ln:      x2 = x + gamma * h, ln = LN(x2)
//   gp2_ln:          ln = LN(x)
//
// Replaces: genpose2_tpu/ops/layernorm.py:fast_residual_layernorm
// (_residual_ln_kernel), fast_add_layernorm (_add_ln_kernel) and
// fast_layernorm (_ln_kernel), row tiles of a (B*N, D) array in VMEM.
//
// Semantics: the sum is taken in float32 (x + h*gamma, each operation rounded
// on its own; gp2_ln takes x as it is), mean and variance are float32 over
// that unrounded sum (two passes over registers: mean, then the mean of
// squared deviations), eps as
// given (1e-6, flax's default), y = (s - mu) * rsqrt(var + eps) * scale + bias.
// x2 and ln are written in the input type T (bf16 rounds only at the write).
//
// What bounds it on this card: bytes. Each row is read once and written once
// or twice; the arithmetic is a few operations per element. At the ViT shape
// (64 x 272 rows of 384 bf16) add_ln moves 53 MB, ln 26.7 MB (0.008 ms at
// 3.35 TB/s).
//
// Design: one warp per row, 8 rows per 256-thread block. A lane holds the
// elements lane, lane+32, ... of its row in registers (VPT of them, D <= 32 *
// VPT), so the row is read from memory once; the two sums are warp shuffles.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

template <typename T, int VPT>
__global__ void __launch_bounds__(kThreads)
ln_kernel(const T* __restrict__ x, const T* __restrict__ h, const float* __restrict__ gamma,
          const float* __restrict__ scale, const float* __restrict__ bias,
          T* __restrict__ x2_out, T* __restrict__ ln_out, int rows, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * D;
  float v[VPT];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int c = lane + 32 * k;
    v[k] = 0.f;
    if (c < D) {
      v[k] = to_f32(x[base + c]);
      if (h != nullptr) {
        float hv = to_f32(h[base + c]);
        if (gamma != nullptr) hv = __fmul_rn(hv, gamma[c]);
        v[k] = __fadd_rn(v[k], hv);
      }
      sum += v[k];
    }
  }
  const float mu = warp_sum(sum) / static_cast<float>(D);
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int c = lane + 32 * k;
    if (c < D) {
      const float d = v[k] - mu;
      sq += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(D) + eps);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int c = lane + 32 * k;
    if (c < D) {
      ln_out[base + c] = from_f32<T>((v[k] - mu) * rstd * scale[c] + bias[c]);
      if (x2_out != nullptr) x2_out[base + c] = from_f32<T>(v[k]);
    }
  }
}

template <typename T, int VPT>
cudaError_t launch_vpt(const void* x, const void* h, const float* gamma, const float* scale,
                       const float* bias, void* x2, void* ln, int rows, int D, float eps,
                       cudaStream_t stream) {
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  ln_kernel<T, VPT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(h), gamma, scale, bias,
      static_cast<T*>(x2), static_cast<T*>(ln), rows, D, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* h, const float* gamma, const float* scale,
                   const float* bias, void* x2, void* ln, int rows, int D, float eps,
                   cudaStream_t stream) {
  if (D <= 128) return launch_vpt<T, 4>(x, h, gamma, scale, bias, x2, ln, rows, D, eps, stream);
  if (D <= 256) return launch_vpt<T, 8>(x, h, gamma, scale, bias, x2, ln, rows, D, eps, stream);
  if (D <= 384) return launch_vpt<T, 12>(x, h, gamma, scale, bias, x2, ln, rows, D, eps, stream);
  if (D <= 512) return launch_vpt<T, 16>(x, h, gamma, scale, bias, x2, ln, rows, D, eps, stream);
  if (D <= 1024) return launch_vpt<T, 32>(x, h, gamma, scale, bias, x2, ln, rows, D, eps, stream);
  return cudaErrorInvalidValue;
}

int dispatch(const void* x, const void* h, const float* gamma, const float* scale,
             const float* bias, void* x2, void* ln, int rows, int D, float eps, int bf16,
             void* stream) {
  if (rows <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(x, h, gamma, scale, bias, x2, ln, rows, D, eps, s)
           : launch<float>(x, h, gamma, scale, bias, x2, ln, rows, D, eps, s);
  return static_cast<int>(err);
}

}  // namespace

// x, h, ln (rows, D) in float32 (bf16 = 0) or bfloat16 (bf16 = 1); scale, bias
// (D,) float32. D <= 1024. Returns a CUDA error code.
extern "C" int gp2_residual_ln(const void* x, const void* h, const float* scale,
                               const float* bias, void* ln, int rows, int D, float eps,
                               int bf16, void* stream) {
  return dispatch(x, h, nullptr, scale, bias, nullptr, ln, rows, D, eps, bf16, stream);
}

// As gp2_residual_ln, with gamma (D,) float32 scaling h and the sum written to x2.
extern "C" int gp2_add_ln(const void* x, const void* h, const float* gamma, const float* scale,
                          const float* bias, void* x2, void* ln, int rows, int D, float eps,
                          int bf16, void* stream) {
  return dispatch(x, h, gamma, scale, bias, x2, ln, rows, D, eps, bf16, stream);
}

// ln = LN(x): x, ln (rows, D) in float32 (bf16 = 0) or bfloat16 (bf16 = 1);
// scale, bias (D,) float32. D <= 1024. Returns a CUDA error code.
extern "C" int gp2_ln(const void* x, const float* scale, const float* bias, void* ln, int rows,
                      int D, float eps, int bf16, void* stream) {
  return dispatch(x, nullptr, nullptr, scale, bias, nullptr, ln, rows, D, eps, bf16, stream);
}
