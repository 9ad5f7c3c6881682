// The whole fixed-grid RK4 integration of the probability-flow ODE in one
// launch, with the score net folded (models/scorenet.py:fast_score_weights).
//
// Replaces: genpose2_tpu/ops/ode_rk4.py:fused_rk4_integrate (_kernel).
//
// Semantics, per step i with stage times j = (0, 1, 1, 2) and c = (0, .5, .5, 1):
//   xt  = x + c_s * h * k_{s-1}
//   pf  = relu(relu(xt W0 + b0) W1p + b1p)
//   hid = relu(pf Wpose + static + trow[i, j])
//   k_s = (hid W2 + b2) * q[i, j] + a[i, j] * xt
//   x   = x + h / 6 * (k0 + 2 k1 + 2 k2 + k3)
// trow, q, a and h come from ops/ode_rk4.py:_time_tables, computed in torch
// before the launch. Matmul operands are rounded to the compute type (f32 or
// bf16), sums are f32, and x and all glue stay f32, as in the TPU kernel.
//
// What bounds it on this card: operations. At the main path's shape (3200
// rows of 9, H1 = 768, 50 steps) one call is ~3.5e11 FLOP: 0.35 ms at the
// bf16 tensor-core peak, 5.2 ms at the f32 peak; this kernel runs on the f32
// pipes. Tensor-core tiles are later work.
//
// Design: one block per kTR rows, so the 3200 rows make 200 blocks over the
// 132 SMs; the rows' state and every intermediate stay in shared memory for
// all 50 steps (k-major, so the rows of one k are float4 broadcasts). The
// folded weights (~270k values: 1.1 MB in f32, 0.54 MB in bf16) do not fit
// in shared memory and are read from L2 in every stage; each thread owns one
// output column at a time and neighbouring threads read neighbouring weights.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTR = 16;  // rows per block

struct Params {
  const float* x0;     // (R, D)
  float* out;          // (R, D)
  const float* stat;   // (R, H1) pts-feature part of the heads' first layer
  const float* trows;  // (n, 3, H1) t-embedding through the heads' first layer
  const float* scal;   // (n, 7): h, q0, q1, q2, a0, a1, a2
  const void* w0;      // (D, P1)
  const float* b0;
  const void* w1;      // (P1, P2)
  const float* b1;
  const void* wp;      // (P2, H1)
  const void* w2;      // (H1, D)
  const float* b2;
  int R, D, P1, P2, H1, n;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) rk4_kernel(const Params P) {
  extern __shared__ __align__(16) float smem[];
  const int D = P.D, P1 = P.P1, P2 = P.P2, H1 = P.H1;
  const int DR = ((D + 3) / 4 * 4) * kTR;  // one k-major (D, kTR) plane, padded
  float* X = smem;                 // state x
  float* XT = X + DR;              // stage input, f32
  float* XO = XT + DR;             // stage input, as a matmul operand
  float* KS = XO + DR;             // the four stage slopes
  float* A = KS + 4 * DR;          // (P1, kTR)
  float* Bf = A + P1 * kTR;        // (P2, kTR)
  float* HD = Bf + P2 * kTR;       // (H1, kTR)
  const int r0 = blockIdx.x * kTR;
  const T* w0 = static_cast<const T*>(P.w0);
  const T* w1 = static_cast<const T*>(P.w1);
  const T* wp = static_cast<const T*>(P.wp);
  const T* w2 = static_cast<const T*>(P.w2);

  for (int e = threadIdx.x; e < DR; e += blockDim.x) {
    const int d = e / kTR, r = e % kTR;
    X[e] = (d < D && r0 + r < P.R) ? P.x0[static_cast<size_t>(r0 + r) * D + d] : 0.f;
  }
  __syncthreads();

  const int stage_j[4] = {0, 1, 1, 2};
  const float stage_c[4] = {0.f, 0.5f, 0.5f, 1.f};
  for (int i = 0; i < P.n; ++i) {
    const float* sc = P.scal + 7 * i;
    const float h = sc[0];
    for (int s = 0; s < 4; ++s) {
      const int j = stage_j[s];
      const float cs = stage_c[s] * h;
      for (int e = threadIdx.x; e < D * kTR; e += blockDim.x) {
        const float xt = s == 0 ? X[e] : X[e] + cs * KS[(s - 1) * DR + e];
        XT[e] = xt;
        XO[e] = as_operand<T>(xt);
      }
      __syncthreads();
      for (int o = threadIdx.x; o < P1; o += blockDim.x) {
        float z[kTR];
        dot_rows<kTR, T>(XO, D, w0, P1, o, z);
        const float bo = P.b0[o];
#pragma unroll
        for (int r = 0; r < kTR; ++r) A[o * kTR + r] = as_operand<T>(fmaxf(z[r] + bo, 0.f));
      }
      __syncthreads();
      for (int o = threadIdx.x; o < P2; o += blockDim.x) {
        float z[kTR];
        dot_rows<kTR, T>(A, P1, w1, P2, o, z);
        const float bo = P.b1[o];
#pragma unroll
        for (int r = 0; r < kTR; ++r) Bf[o * kTR + r] = as_operand<T>(fmaxf(z[r] + bo, 0.f));
      }
      __syncthreads();
      const float* trow = P.trows + (static_cast<size_t>(i) * 3 + j) * H1;
      for (int o = threadIdx.x; o < H1; o += blockDim.x) {
        float z[kTR];
        dot_rows<kTR, T>(Bf, P2, wp, H1, o, z);
        const float t = trow[o];
#pragma unroll
        for (int r = 0; r < kTR; ++r) {
          const float st = r0 + r < P.R ? P.stat[static_cast<size_t>(r0 + r) * H1 + o] : 0.f;
          HD[o * kTR + r] = as_operand<T>(fmaxf((z[r] + st) + t, 0.f));
        }
      }
      __syncthreads();
      const float q = sc[1 + j], a = sc[4 + j];
      for (int e = threadIdx.x; e < D * kTR; e += blockDim.x) {
        const int d = e / kTR, r = e % kTR;
        float sum = 0.f;
        for (int k = 0; k < H1; ++k)
          sum = fmaf(HD[k * kTR + r], to_f32(w2[static_cast<size_t>(k) * D + d]), sum);
        const float heads = sum + P.b2[d];
        KS[s * DR + e] = heads * q + a * XT[e];
      }
      __syncthreads();
    }
    const float h6 = h / 6.f;
    for (int e = threadIdx.x; e < D * kTR; e += blockDim.x)
      X[e] = X[e] + h6 * (((KS[e] + 2.f * KS[DR + e]) + 2.f * KS[2 * DR + e]) + KS[3 * DR + e]);
    __syncthreads();
  }

  for (int e = threadIdx.x; e < D * kTR; e += blockDim.x) {
    const int d = e / kTR, r = e % kTR;
    if (r0 + r < P.R) P.out[static_cast<size_t>(r0 + r) * D + d] = X[e];
  }
}

size_t smem_bytes(int D, int P1, int P2, int H1) {
  const size_t DR = static_cast<size_t>((D + 3) / 4 * 4) * kTR;
  return sizeof(float) * (7 * DR + static_cast<size_t>(P1 + P2 + H1) * kTR);
}

}  // namespace

// One fused integration; see Params for the layouts. bf16 != 0: the four
// weight matrices are bf16, otherwise f32. Returns a CUDA error code.
extern "C" int gp2_rk4(const float* x0, float* out, const float* stat, const float* trows,
                       const float* scal, const void* w0, const float* b0, const void* w1,
                       const float* b1, const void* wp, const void* w2, const float* b2,
                       int R, int D, int P1, int P2, int H1, int n, int bf16, void* stream) {
  const Params P = {x0, out, stat, trows, scal, w0, b0, w1, b1, wp, w2, b2, R, D, P1, P2, H1, n};
  const size_t smem = smem_bytes(D, P1, P2, H1);
  const int grid = (R + kTR - 1) / kTR;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    err = allow_smem(rk4_kernel<__nv_bfloat16>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    rk4_kernel<__nv_bfloat16><<<grid, kThreads, smem, st>>>(P);
  } else {
    err = allow_smem(rk4_kernel<float>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    rk4_kernel<float><<<grid, kThreads, smem, st>>>(P);
  }
  return static_cast<int>(cudaGetLastError());
}
