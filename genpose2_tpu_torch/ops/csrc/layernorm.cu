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
// scalar route otherwise (any D to 1,024; plan.cuh:ln_plan picks the
// instantiation). Timed against each other on the
// H100 at the paths' shapes (PERF.md section 6), both near the bytes' bound
// by device time: the vector route 3% faster for gp2_add_ln (bf16), 0-4% a
// shape for gp2_residual_ln and even for gp2_ln. More rows a warp in flight,
// or a grid of resident blocks striding over the rows, were slower.
//
// Rows wider than 1,024 (the DINOv3 ViT-7B's 4,096) take the wide route: a
// 256-thread block a row, a thread holding PPT pieces (tid, tid + 256, ...)
// of 4 elements where the vector route's conditions hold, of 1 otherwise;
// each of the two sums is a warp shuffle, then the 8 warps' partial sums
// through shared memory, added in the same order by every thread. Up to
// 8,192 elements a row (PPT 8 pieces of 4, or 32 of 1). At 128 x 272 rows of
// 4,096 bf16, add_ln moves 1.14 GB (0.34 ms at 3.35 TB/s).
#include <stdint.h>

#include <initializer_list>

#include "common.cuh"
#include "plan.cuh"

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

// Piece k of a thread: kE consecutive elements as float32, and back.
template <typename T>
__device__ __forceinline__ void get(const T* p, float (&e)[4]) {
  const float4 f = load4(p);
  e[0] = f.x, e[1] = f.y, e[2] = f.z, e[3] = f.w;
}
template <typename T>
__device__ __forceinline__ void get(const T* p, float (&e)[1]) { e[0] = to_f32(*p); }
template <typename T>
__device__ __forceinline__ void put(T* p, const float (&e)[4]) {
  store4(p, make_float4(e[0], e[1], e[2], e[3]));
}
template <typename T>
__device__ __forceinline__ void put(T* p, const float (&e)[1]) { *p = from_f32<T>(e[0]); }

// The block's sum of v: warp shuffles, then the warps' partial sums in warp
// order (the same total in every thread). `red` holds kRowsPerBlock floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kRowsPerBlock; ++w) s += red[w];
  __syncthreads();  // red is written again by the next sum
  return s;
}

// The wide route: one row a block, PPT pieces of kE elements a thread.
template <typename T, int PPT, int kE>
__global__ void __launch_bounds__(kThreads)
ln_wide_kernel(const T* __restrict__ x, const T* __restrict__ h,
               const float* __restrict__ gamma, const float* __restrict__ scale,
               const float* __restrict__ bias, T* __restrict__ x2_out, T* __restrict__ ln_out,
               int D, float eps) {
  __shared__ float red[kRowsPerBlock];
  const size_t base = static_cast<size_t>(blockIdx.x) * D;
  float v[PPT][kE];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int c = kE * (threadIdx.x + kThreads * k);
#pragma unroll
    for (int i = 0; i < kE; ++i) v[k][i] = 0.f;
    if (c < D) {
      get(x + base + c, v[k]);
      if (h != nullptr) {
        float hv[kE];
        get(h + base + c, hv);
        if (gamma != nullptr) {
          float g[kE];
          get(gamma + c, g);
#pragma unroll
          for (int i = 0; i < kE; ++i) hv[i] = __fmul_rn(hv[i], g[i]);
        }
#pragma unroll
        for (int i = 0; i < kE; ++i) v[k][i] = __fadd_rn(v[k][i], hv[i]);
      }
#pragma unroll
      for (int i = 0; i < kE; ++i) sum += v[k][i];
    }
  }
  const float mu = block_sum(sum, red) / static_cast<float>(D);
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    if (kE * (threadIdx.x + kThreads * k) < D) {
#pragma unroll
      for (int i = 0; i < kE; ++i) {
        const float d = v[k][i] - mu;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(block_sum(sq, red) / static_cast<float>(D) + eps);
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int c = kE * (threadIdx.x + kThreads * k);
    if (c >= D) continue;
    float sc[kE], bi[kE], y[kE];
    get(scale + c, sc);
    get(bias + c, bi);
#pragma unroll
    for (int i = 0; i < kE; ++i) y[i] = (v[k][i] - mu) * rstd * sc[i] + bi[i];
    put(ln_out + base + c, y);
    if (x2_out != nullptr) put(x2_out + base + c, v[k]);
  }
}

template <typename T, int PPT, int kE>
cudaError_t launch_wide_ppt(const void* x, const void* h, const float* gamma,
                            const float* scale, const float* bias, void* x2, void* ln, int rows,
                            int D, float eps, cudaStream_t stream) {
  ln_wide_kernel<T, PPT, kE><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(h), gamma, scale, bias,
      static_cast<T*>(x2), static_cast<T*>(ln), D, eps);
  return cudaGetLastError();
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

// The route of plan.cuh:ln_plan: a warp a row (pieces of 4, or of 1), or a
// block a row past 1,024 elements.
template <typename T>
cudaError_t launch(const void* x, const void* h, const float* gamma, const float* scale,
                   const float* bias, void* x2, void* ln, int rows, int D, float eps,
                   cudaStream_t s) {
  LnPlan p;
  if (ln_plan(D, vector_route(D, {x, h, gamma, scale, bias, x2, ln}), &p) != 0) {
    return cudaErrorInvalidValue;
  }
#define GP2_LN(fn, ...) return fn<T, __VA_ARGS__>(x, h, gamma, scale, bias, x2, ln, rows, D, eps, s)
  if (p.wide && p.piece == 4) {
    switch (p.pieces) {
      case 2: GP2_LN(launch_wide_ppt, 2, 4);
      case 4: GP2_LN(launch_wide_ppt, 4, 4);
      case 8: GP2_LN(launch_wide_ppt, 8, 4);
    }
  } else if (p.wide) {
    switch (p.pieces) {
      case 8: GP2_LN(launch_wide_ppt, 8, 1);
      case 16: GP2_LN(launch_wide_ppt, 16, 1);
      case 32: GP2_LN(launch_wide_ppt, 32, 1);
    }
  } else if (p.piece == 4) {
    switch (p.pieces) {
      case 1: GP2_LN(launch_vec, 1);
      case 2: GP2_LN(launch_vec, 2);
      case 3: GP2_LN(launch_vec, 3);
      case 4: GP2_LN(launch_vec, 4);
      case 8: GP2_LN(launch_vec, 8);
    }
  } else {
    switch (p.pieces) {
      case 4: GP2_LN(launch_vpt, 4);
      case 8: GP2_LN(launch_vpt, 8);
      case 12: GP2_LN(launch_vpt, 12);
      case 16: GP2_LN(launch_vpt, 16);
      case 32: GP2_LN(launch_vpt, 32);
    }
  }
#undef GP2_LN
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
// (D,) float32. D <= 8192. Returns a CUDA error code.
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
// scale, bias (D,) float32. D <= 8192. Returns a CUDA error code.
extern "C" int gp2_ln(const void* x, const float* scale, const float* bias, void* ln, int rows,
                      int D, float eps, int bf16, void* stream) {
  return dispatch(x, nullptr, nullptr, scale, bias, nullptr, ln, rows, D, eps, bf16, stream);
}
