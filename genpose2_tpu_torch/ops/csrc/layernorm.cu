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
// Design: a warp a row, 8 rows a 256-thread block, the row read from memory
// once into registers; the two sums are warp shuffles. Two routes:
// - vector (D a multiple of 4, 16-byte aligned rows and vectors): a lane
//   holds pieces of 4 consecutive elements (pieces lane, lane + 32, ...:
//   8-byte loads and stores in bf16, 16-byte in float32; at D = 384 three
//   pieces a lane), and scale, bias and gamma as float4 reads that L1 serves
//   after a block's first row.
// - scalar: a lane holds the elements lane, lane + 32, ... (VPT of them).
// Every entry takes the vector route where D and the pointers allow it, the
// scalar route otherwise (any D to 1,024). Timed against each other on the
// H100 at the paths' shapes (PERF.md section 6), both near the bytes' bound
// by device time: the vector route 3% faster for gp2_add_ln (bf16), 0-4% a
// shape for gp2_residual_ln and even for gp2_ln. More rows a warp in flight,
// or a grid of resident blocks striding over the rows, were slower.
#include <stdint.h>

#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

// 4 consecutive elements of T as float32, and back (the store rounds each).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&a);
  u.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// The vector route: PPL pieces of 4 a lane (D <= 128 PPL).
template <typename T, int PPL>
__global__ void __launch_bounds__(kThreads)
ln_vec_kernel(const T* __restrict__ x, const T* __restrict__ h, const float* __restrict__ gamma,
              const float* __restrict__ scale, const float* __restrict__ bias,
              T* __restrict__ x2_out, T* __restrict__ ln_out, int rows, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * D;
  float4 v[PPL];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < PPL; ++k) {
    const int c = 4 * (lane + 32 * k);
    v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < D) {
      v[k] = load4(x + base + c);
      if (h != nullptr) {
        float4 hv = load4(h + base + c);
        if (gamma != nullptr) {
          const float4 g = __ldg(reinterpret_cast<const float4*>(gamma + c));
          hv = make_float4(__fmul_rn(hv.x, g.x), __fmul_rn(hv.y, g.y), __fmul_rn(hv.z, g.z),
                           __fmul_rn(hv.w, g.w));
        }
        v[k] = make_float4(__fadd_rn(v[k].x, hv.x), __fadd_rn(v[k].y, hv.y),
                           __fadd_rn(v[k].z, hv.z), __fadd_rn(v[k].w, hv.w));
      }
      sum += (v[k].x + v[k].y) + (v[k].z + v[k].w);
    }
  }
  const float mu = warp_sum(sum) / static_cast<float>(D);
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < PPL; ++k) {
    if (4 * (lane + 32 * k) < D) {
      const float a = v[k].x - mu, b = v[k].y - mu, c = v[k].z - mu, d = v[k].w - mu;
      sq += (a * a + b * b) + (c * c + d * d);
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(D) + eps);
#pragma unroll
  for (int k = 0; k < PPL; ++k) {
    const int c = 4 * (lane + 32 * k);
    if (c >= D) continue;
    const float4 sc = __ldg(reinterpret_cast<const float4*>(scale + c));
    const float4 bi = __ldg(reinterpret_cast<const float4*>(bias + c));
    const float4 e = v[k];
    store4(ln_out + base + c,
           make_float4((e.x - mu) * rstd * sc.x + bi.x, (e.y - mu) * rstd * sc.y + bi.y,
                       (e.z - mu) * rstd * sc.z + bi.z, (e.w - mu) * rstd * sc.w + bi.w));
    if (x2_out != nullptr) store4(x2_out + base + c, e);
  }
}

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

template <typename T, int PPL>
cudaError_t launch_vec(const void* x, const void* h, const float* gamma, const float* scale,
                       const float* bias, void* x2, void* ln, int rows, int D, float eps,
                       cudaStream_t stream) {
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  ln_vec_kernel<T, PPL><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(h), gamma, scale, bias,
      static_cast<T*>(x2), static_cast<T*>(ln), rows, D, eps);
  return cudaGetLastError();
}

// The vector route takes D a multiple of 4 with every pointer 16-byte aligned.
bool vector_route(int D, std::initializer_list<const void*> ptrs) {
  if (D % 4 != 0) return false;
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  }
  return true;
}

template <typename T>
cudaError_t launch(const void* x, const void* h, const float* gamma, const float* scale,
                   const float* bias, void* x2, void* ln, int rows, int D, float eps,
                   cudaStream_t stream) {
  if (vector_route(D, {x, h, gamma, scale, bias, x2, ln})) {
    if (D <= 128) return launch_vec<T, 1>(x, h, gamma, scale, bias, x2, ln, rows, D, eps, stream);
    if (D <= 256) return launch_vec<T, 2>(x, h, gamma, scale, bias, x2, ln, rows, D, eps, stream);
    if (D <= 384) return launch_vec<T, 3>(x, h, gamma, scale, bias, x2, ln, rows, D, eps, stream);
    if (D <= 512) return launch_vec<T, 4>(x, h, gamma, scale, bias, x2, ln, rows, D, eps, stream);
    if (D <= 1024) return launch_vec<T, 8>(x, h, gamma, scale, bias, x2, ln, rows, D, eps, stream);
    return cudaErrorInvalidValue;
  }
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
