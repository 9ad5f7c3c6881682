// Token-major multi-head self-attention of the ViT backbone, three entries:
//   gp2_vit_attention           N padded to the sublane tile, keys >= n_valid masked
//   gp2_vit_attention_unpadded  any N >= 1 (the route for an unpadded token axis)
//   gp2_vit_attention_rope      as gp2_vit_attention, RoPE applied to q and k inside
//
// Replaces: genpose2_tpu/ops/vit_attention.py:vit_attention_tm (_kernel_tm,
// rope=False and rope=True), which keeps RB batch rows of q/k/v in VMEM and
// loops over heads, and vit_attention (_kernel), which transposes q/k/v to
// head-major and pads N to the sublane tile before the kernel. Those two are
// layouts Mosaic needs, not semantics: this kernel reads the token-major
// tensors as the qkv projection writes them, guards the partial last query
// tile (nq rows) and loops over exactly the N keys, so one template serves the
// padded and the unpadded token axis.
//
// Semantics: q, k, v (B, N, C) token-major, head h = columns h*D .. h*D+D-1;
// s = (q_h k_h^T) * scale (scale = 1/sqrt(D), applied after the product), keys
// j >= n_valid get -1e9 added; softmax in float32; p rounded to v's type; out =
// p v_h summed in float32, written float32. Query rows >= n_valid are computed
// like the others (the caller slices them off). With RoPE, sin and cos are
// (N, D) float32 tables, the same for every head: each q and k row becomes
// x * cos + rotate_half(x) * sin in float32 (rotate_half(x) = [-x2, x1] of the
// head's halves; each product and the sum rounded on their own, no FMA),
// rounded back to the input type, as the TPU kernel's roped() does.
//
// What bounds it on this card: at the ViT shape (64 objects, 272 tokens, 6
// heads of 64, bf16) the bytes are 53 MB of q/k/v and 27 MB of float32 output,
// ~0.024 ms; the two products are 2 * 2 * 64 * 6 * 272^2 * 64 = 7.3 GFLOP,
// 0.007 ms on the bf16 tensor cores. This first kernel runs the products on
// the float32 pipes (no tensor cores), so operations bound it in practice. The
// rotation adds 6 operations per q and k element, and the tables 2 * N * D * 4
// bytes (read from L2 by every block).
//
// Design: one block per (query tile of 16, head, object). The head's K (d-major)
// and V sit in shared memory in the input type (272 x 64 bf16 = 35 KB each);
// with RoPE the staged q tile and K are rotated in place there, pair (d, d+D/2)
// by one thread; each thread owns one key and keeps the 16 scores of the tile
// in registers; one warp per query row does the softmax; in the PV product each
// thread owns 4 query rows x 2 columns (attention.cuh).
#include "attention.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTQ = 16;

// x * c + rotate_half(x) * s for the pair (x1 at d, x2 at d + D/2): the first
// element's rotated partner is -x2, the second's x1.
__device__ __forceinline__ float2 rotate_pair(float x1, float x2, float c1, float s1, float c2,
                                              float s2) {
  return make_float2(__fadd_rn(__fmul_rn(x1, c1), __fmul_rn(-x2, s1)),
                     __fadd_rn(__fmul_rn(x2, c2), __fmul_rn(x1, s2)));
}

// RoPE on the staged head in shared memory: the q tile (qt [D][TQ] float, its
// nq real rows, tokens i0..) and K (kt [D][M] T, all M keys), each value
// rotated in float32 and rounded to T.
template <typename T, int TQ>
__device__ __forceinline__ void rope_head(const float* __restrict__ sn,
                                          const float* __restrict__ cs, int i0, int nq, int M,
                                          int D, float* qt, T* kt) {
  const int h2 = D / 2;
  for (int e = threadIdx.x; e < (nq + M) * h2; e += blockDim.x) {
    const int row = e / h2, d = e - row * h2;
    const bool is_q = row < nq;
    const int tok = is_q ? i0 + row : row - nq;
    const size_t t0 = static_cast<size_t>(tok) * D;
    float x1, x2;
    if (is_q) {
      x1 = qt[d * TQ + row];
      x2 = qt[(d + h2) * TQ + row];
    } else {
      x1 = to_f32(kt[d * M + tok]);
      x2 = to_f32(kt[(d + h2) * M + tok]);
    }
    const float2 y = rotate_pair(x1, x2, __ldg(cs + t0 + d), __ldg(sn + t0 + d),
                                 __ldg(cs + t0 + d + h2), __ldg(sn + t0 + d + h2));
    if (is_q) {
      qt[d * TQ + row] = as_operand<T>(y.x);
      qt[(d + h2) * TQ + row] = as_operand<T>(y.y);
    } else {
      kt[d * M + tok] = from_f32<T>(y.x);
      kt[(d + h2) * M + tok] = from_f32<T>(y.y);
    }
  }
}

template <typename T, bool kRope>
__global__ void __launch_bounds__(kThreads)
vit_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ sn, const float* __restrict__ cs,
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
  if constexpr (kRope) {
    rope_head<T, kTQ>(sn, cs, i0, nq, N, D, qt, kt);
    __syncthreads();
  }
  head_scores<T, kTQ>(qt, kt, N, D, scale, st,
                      [n_valid](int, int j) { return j < n_valid ? 0.f : -1e9f; });
  __syncthreads();
  softmax_rows<T, kTQ>(st, N, nq);
  __syncthreads();
  head_pv<T, kTQ>(st, vs, N, D, nq, red,
                  out + (static_cast<size_t>(b) * N + i0) * C + h * D, C);
}

template <typename T, bool kRope>
cudaError_t launch(const void* q, const void* k, const void* v, const float* sn,
                   const float* cs, float* out, int B, int N, int C, int H, int n_valid,
                   float scale, cudaStream_t stream) {
  const int D = C / H;
  const size_t smem = head_smem_bytes<T, kTQ>(N, D, kThreads);
  cudaError_t err = allow_smem(vit_attention_kernel<T, kRope>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTQ - 1) / kTQ, H, B);
  vit_attention_kernel<T, kRope><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), sn, cs, out,
      N, C, D, n_valid, scale);
  return cudaGetLastError();
}

template <bool kRope>
int dispatch(const void* q, const void* k, const void* v, const float* sn, const float* cs,
             float* out, int B, int N, int C, int H, int n_valid, float scale, int bf16,
             void* stream) {
  if (H <= 0 || C % H != 0 || (C / H) % 2 != 0 || N <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16, kRope>(q, k, v, sn, cs, out, B, N, C, H, n_valid, scale, s)
           : launch<float, kRope>(q, k, v, sn, cs, out, B, N, C, H, n_valid, scale, s);
  return static_cast<int>(err);
}

}  // namespace

// q, k, v (B, N, C) float32 (bf16 = 0) or bfloat16 (bf16 = 1), C = H * D;
// out (B, N, C) float32. Returns a CUDA error code.
extern "C" int gp2_vit_attention(const void* q, const void* k, const void* v, float* out, int B,
                                 int N, int C, int H, int n_valid, float scale, int bf16,
                                 void* stream) {
  return dispatch<false>(q, k, v, nullptr, nullptr, out, B, N, C, H, n_valid, scale, bf16,
                         stream);
}

// As gp2_vit_attention, for a token axis of any length N >= 1 (not padded).
extern "C" int gp2_vit_attention_unpadded(const void* q, const void* k, const void* v,
                                          float* out, int B, int N, int C, int H, int n_valid,
                                          float scale, int bf16, void* stream) {
  return dispatch<false>(q, k, v, nullptr, nullptr, out, B, N, C, H, n_valid, scale, bf16,
                         stream);
}

// As gp2_vit_attention, with the sin and cos tables (N, C / H) float32
// rotating q and k.
extern "C" int gp2_vit_attention_rope(const void* q, const void* k, const void* v,
                                      const float* sin_tab, const float* cos_tab, float* out,
                                      int B, int N, int C, int H, int n_valid, float scale,
                                      int bf16, void* stream) {
  return dispatch<true>(q, k, v, sin_tab, cos_tab, out, B, N, C, H, n_valid, scale, bf16,
                        stream);
}
