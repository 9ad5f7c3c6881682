// Token-major multi-head self-attention of the ViT backbone.
//
// Replaces: genpose2_tpu/ops/vit_attention.py:vit_attention_tm (_kernel_tm,
// rope=False), which keeps RB batch rows of q/k/v in VMEM and loops over heads.
//
// Semantics: q, k, v (B, N, C) token-major, head h = columns h*D .. h*D+D-1;
// s = (q_h k_h^T) * scale (scale = 1/sqrt(D), applied after the product), keys
// j >= n_valid get -1e9 added; softmax in float32; p rounded to v's type; out =
// p v_h summed in float32, written float32. Query rows >= n_valid are computed
// like the others (the caller slices them off).
//
// What bounds it on this card: at the ViT shape (64 objects, 272 tokens, 6
// heads of 64, bf16) the bytes are 53 MB of q/k/v and 27 MB of float32 output,
// ~0.024 ms; the two products are 2 * 2 * 64 * 6 * 272^2 * 64 = 7.3 GFLOP,
// 0.007 ms on the bf16 tensor cores. This first kernel runs the products on
// the float32 pipes (no tensor cores), so operations bound it in practice.
//
// Design: one block per (query tile of 16, head, object). The head's K (d-major)
// and V sit in shared memory in the input type (272 x 64 bf16 = 35 KB each);
// each thread owns one key and keeps the 16 scores of the tile in registers;
// one warp per query row does the softmax; in the PV product each thread owns
// 4 query rows x 2 columns (attention.cuh).
#include "attention.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTQ = 16;

template <typename T>
__global__ void __launch_bounds__(kThreads)
vit_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     float* __restrict__ out, int N, int C, int D, int n_valid, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int i0 = blockIdx.x * kTQ, h = blockIdx.y, b = blockIdx.z;
  const int nq = min(kTQ, N - i0);
  float* qt = smem;
  float* st = qt + align4(D * kTQ);
  float* red = st + align4(N * kStride<kTQ>);
  T* kt = reinterpret_cast<T*>(red + align4(kRedFloats * kThreads));
  T* vs = kt + N * D;

  stage_head<T, kTQ>(q, k, v, b, h, i0, nq, N, C, D, qt, kt, vs);
  __syncthreads();
  head_scores<T, kTQ>(qt, kt, N, D, scale, st,
                      [n_valid](int, int j) { return j < n_valid ? 0.f : -1e9f; });
  __syncthreads();
  softmax_rows<T, kTQ>(st, N, nq);
  __syncthreads();
  head_pv<T, kTQ>(st, vs, N, D, nq, red,
                  out + (static_cast<size_t>(b) * N + i0) * C + h * D, C);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, float* out, int B, int N,
                   int C, int H, int n_valid, float scale, cudaStream_t stream) {
  const int D = C / H;
  const size_t smem = head_smem_bytes<T, kTQ>(N, D, kThreads);
  cudaError_t err = allow_smem(vit_attention_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTQ - 1) / kTQ, H, B);
  vit_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), out, N, C,
      D, n_valid, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v (B, N, C) float32 (bf16 = 0) or bfloat16 (bf16 = 1), C = H * D;
// out (B, N, C) float32. Returns a CUDA error code.
extern "C" int gp2_vit_attention(const void* q, const void* k, const void* v, float* out, int B,
                                 int N, int C, int H, int n_valid, float scale, int bf16,
                                 void* stream) {
  if (H <= 0 || C % H != 0 || (C / H) % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(q, k, v, out, B, N, C, H, n_valid, scale, s)
           : launch<float>(q, k, v, out, B, N, C, H, n_valid, scale, s);
  return static_cast<int>(err);
}
