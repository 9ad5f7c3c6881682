// Attention with a relative-position bias built from the points' coordinates.
//
// Replaces: genpose2_tpu/ops/relpe_attention.py:relpe_attention (_kernel), which
// builds the bias tile of a (batch row, query tile) on the fly from xyz and
// never writes a (B, H, M, M) tensor.
//
// Semantics, per object, query i, key j and head h:
//   rel = xyz_j - xyz_i, dist = |rel|, u = rel / (dist + 1e-7) (as rel * inv)
//   hd_c = relu(dist * w1d_c + b1d_c), hr_c = relu(u . w1r_c + b1r_c), c < 16
//   bias_h = bc_h + sum_c (hd_c * wfd[c][h] + hr_c * wfr[c][h])
//   s = (q_h . k_h) * scale + bias_h, scale = 1/sqrt(D); p = softmax_j(s) in
//   float32, rounded to v's type; out_h = p v_h in float32.
// wfd = W2d @ Wf[:H], wfr = W2r @ Wf[H:], bc = b2d @ Wf[:H] + b2r @ Wf[H:] + bf
// are folded on the host (ops/relpe_attention.py:fold_pe): the bias is linear
// in the two second layers and the fusion layer.
//
// What bounds it on this card: operations on the float32 pipes. At the Fus
// encoder's stage 0 (64 objects, M = 512, C = 96, H = 8, D = 12) the bias is
// ~16.8 M pairs x ~690 operations = 11.6 GFLOP and the two products another
// 6.4 GFLOP, against 38 MB of q/k/v/out; the later stages have fewer pairs and
// wider heads.
//
// Design: one block per (query tile, object), 256 threads. The block first
// builds the bias of all H heads for its TQ queries and M keys in shared memory
// (the 16 hidden channels of a pair are computed once for all heads: a thread
// owns a pair and keeps the H sums in registers), then runs the heads one
// after the other through attention.cuh: K (d-major) and V of the head in
// shared memory, one key per thread with the TQ scores in registers, one warp
// per query row for the softmax, then the PV product. TQ is 16, or 8 where the
// bias of 16 queries does not fit in shared memory (stage 0).
#include "attention.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kHid = 16;
constexpr int kHeads = 8;
constexpr int kSmemLimit = 227 * 1024;

// Folded constants, float32: w1d[16] b1d[16] w1r[3][16] b1r[16] wfd[16][H]
// wfr[16][H] bc[H].
__host__ __device__ constexpr int pe_floats(int H) { return 6 * kHid + 2 * kHid * H + H; }

template <int TQ>
__host__ __device__ __forceinline__ size_t bias_floats(int M, int H) {
  return static_cast<size_t>(align4(pe_floats(H))) + align4(3 * M) + align4(3 * TQ) +
         align4(H * TQ * M);
}

template <typename T, int H, int TQ>
size_t smem_bytes(int M, int D) {
  return bias_floats<TQ>(M, H) * sizeof(float) + head_smem_bytes<T, TQ>(M, D, kThreads);
}

template <typename T, int H, int TQ>
__global__ void __launch_bounds__(kThreads)
relpe_kernel(const float* __restrict__ xyz, const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ pe, float* __restrict__ out,
             int M, int C, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int D = C / H;
  const int i0 = blockIdx.x * TQ, b = blockIdx.y;
  const int nq = min(TQ, M - i0);
  float* cst = smem;
  float* kx = cst + align4(pe_floats(H));
  float* qx = kx + align4(3 * M);
  float* bias = qx + align4(3 * TQ);  // [h][r][j]
  float* qt = bias + align4(H * TQ * M);
  float* st = qt + align4(D * TQ);
  float* red = st + align4(M * kStride<TQ>);
  T* kt = reinterpret_cast<T*>(red + align4(kRedFloats * kThreads));
  T* vs = kt + M * D;

  const float* p = xyz + static_cast<size_t>(b) * M * 3;
  for (int e = threadIdx.x; e < pe_floats(H); e += kThreads) cst[e] = pe[e];
  for (int e = threadIdx.x; e < 3 * M; e += kThreads) kx[e] = p[e];
  for (int e = threadIdx.x; e < 3 * TQ; e += kThreads) qx[e] = e < 3 * nq ? p[3 * i0 + e] : 0.f;
  __syncthreads();

  const float* w1d = cst;
  const float* b1d = w1d + kHid;
  const float* w1r = b1d + kHid;
  const float* b1r = w1r + 3 * kHid;
  const float* wfd = b1r + kHid;
  const float* wfr = wfd + kHid * H;
  const float* bc = wfr + kHid * H;
  for (int e = threadIdx.x; e < nq * M; e += kThreads) {
    const int r = e / M, j = e - r * M;
    const float rx = kx[3 * j + 0] - qx[3 * r + 0];  // rel = xyz_j - xyz_i
    const float ry = kx[3 * j + 1] - qx[3 * r + 1];
    const float rz = kx[3 * j + 2] - qx[3 * r + 2];
    const float dist = sqrtf(rx * rx + ry * ry + rz * rz);
    const float inv = 1.f / (dist + 1e-7f);
    const float ux = rx * inv, uy = ry * inv, uz = rz * inv;
    float acc[H];
#pragma unroll
    for (int h = 0; h < H; ++h) acc[h] = bc[h];
#pragma unroll 4
    for (int c = 0; c < kHid; ++c) {
      const float hd = fmaxf(dist * w1d[c] + b1d[c], 0.f);
      const float hr = fmaxf(ux * w1r[c] + uy * w1r[kHid + c] + uz * w1r[2 * kHid + c] + b1r[c], 0.f);
#pragma unroll
      for (int h = 0; h < H; ++h) acc[h] = acc[h] + hd * wfd[c * H + h] + hr * wfr[c * H + h];
    }
#pragma unroll
    for (int h = 0; h < H; ++h) bias[(h * TQ + r) * M + j] = acc[h];
  }

  for (int h = 0; h < H; ++h) {
    __syncthreads();  // the bias is complete; the previous head is done with qt/kt/vs/st
    stage_head<T, TQ>(q, k, v, b, h, i0, nq, M, C, D, qt, kt, vs);
    __syncthreads();
    const float* bh = bias + h * TQ * M;
    head_scores<T, TQ>(qt, kt, M, D, scale, st, [bh, M](int r, int j) { return bh[r * M + j]; });
    __syncthreads();
    softmax_rows<T, TQ>(st, M, nq);
    __syncthreads();
    head_pv<T, TQ>(st, vs, M, D, nq, red,
                   out + (static_cast<size_t>(b) * M + i0) * C + h * D, C);
  }
}

template <typename T, int H, int TQ>
cudaError_t launch_tq(const float* xyz, const void* q, const void* k, const void* v,
                      const float* pe, float* out, int B, int M, int C, float scale,
                      cudaStream_t stream) {
  const size_t smem = smem_bytes<T, H, TQ>(M, C / H);
  cudaError_t err = allow_smem(relpe_kernel<T, H, TQ>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + TQ - 1) / TQ, B);
  relpe_kernel<T, H, TQ><<<grid, kThreads, smem, stream>>>(
      xyz, static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pe, out,
      M, C, scale);
  return cudaGetLastError();
}

template <typename T, int H>
cudaError_t launch(const float* xyz, const void* q, const void* k, const void* v,
                   const float* pe, float* out, int B, int M, int C, float scale,
                   cudaStream_t stream) {
  if (smem_bytes<T, H, 16>(M, C / H) <= kSmemLimit)
    return launch_tq<T, H, 16>(xyz, q, k, v, pe, out, B, M, C, scale, stream);
  if (smem_bytes<T, H, 8>(M, C / H) <= kSmemLimit)
    return launch_tq<T, H, 8>(xyz, q, k, v, pe, out, B, M, C, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// xyz (B, M, 3) float32; q, k, v (B, M, C) float32 (bf16 = 0) or bfloat16
// (bf16 = 1), C = H * D with H = 8 (the encoder's num_heads) and D even; pe
// the folded constants (pe_floats(8) float32); out (B, M, C) float32.
// Returns a CUDA error code.
extern "C" int gp2_relpe_attention(const float* xyz, const void* q, const void* k, const void* v,
                                   const float* pe, float* out, int B, int M, int C, int H,
                                   float scale, int bf16, void* stream) {
  if (H != kHeads || C % H != 0 || (C / H) % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16, kHeads>(xyz, q, k, v, pe, out, B, M, C, scale, s)
           : launch<float, kHeads>(xyz, q, k, v, pe, out, B, M, C, scale, s);
  return static_cast<int>(err);
}
