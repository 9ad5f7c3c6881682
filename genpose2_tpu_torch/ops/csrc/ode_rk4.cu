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
// What bounds it on this card. At the main path's shape (3,200 rows of 9,
// P1 = P2 = 256, H1 = 768, 50 steps) one call is ~3.5e11 FLOP: 0.35 ms at the
// bf16 tensor-core peak, 2.1 ms at 3xTF32's (a third of TF32's 495 TFLOP/s).
// The folded weights (540 KB in bf16, 1.08 MB in float32) do not fit in
// shared memory, so every block streams all of them from L2 in every one of
// the 200 stages: 10.8 GB per bf16 call at 32 rows a block. That stream sets
// the pace: on the H100 a block takes a stage's 540 KB in 34-42 us (13-16
// GB/s) whatever the ring's depth (2-4 tiles in flight measured alike), and
// variants that drop the copies halve the time (PERF.md, section 6). The design
// keeps the weights' bytes per row low (32-row tiles where the grid allows)
// and the copies ahead of the products; the products themselves, on the
// tensor cores, are the smaller part.
//
// Design:
// - one block of 16 warps per `rows` rows (plan.cuh:rk4_plan: 32 or 16, the
//   tile that leaves the fewest rows on the busiest SM, ties to 32): 3,200
//   rows make 100 blocks of 32, one round on 132 SMs; a tracking call's 600
//   rows 38 blocks of 16;
// - the rows' state x, the stage input and the four slopes stay in shared
//   memory (float32) for the whole integration; each product's input is a
//   row-major operand buffer in the compute type, and its output the next
//   one's input (two buffers, P and Q, alternate);
// - the weights stream through a ring of 2-3 shared-memory tiles by cp.async
//   (mma.cuh:Stream), nbuf - 1 tiles ahead, one barrier per tile; the
//   sequence runs on across products, stages and steps, so the first tile of
//   a product is in flight during the previous one's epilogue;
// - the three wide products on the tensor cores (mma.cuh: bf16 mma.sync
//   m16n8k16; float32 3xTF32 on m16n8k8), 256 output columns a pass, a warp
//   owning 32 columns of 16 rows (16 columns at 16 rows a block); product
//   3's sums start from the row's static part, loaded before the products;
// - the last product (H1 -> D, D <= 16, W2bd zero-padded to 16 columns) as
//   2 x rows/16 mma tiles, its depth split over the warps (8 or 4 ways), the
//   partial sums added in a fixed order; W2 stays in shared memory for the
//   whole call where it fits (bf16), else it streams with the rest;
// - widths that are not a multiple of 16 (D = 9, the tests' widths) are
//   zero-filled in the operand buffers and in the staged tiles: the wrapper
//   pads nothing.
// A thread block cluster that splits Wpose's 768 columns over 2-4 blocks, its
// activations exchanged through distributed shared memory, would cut each
// SM's share of the weight stream, and with it the tracking shape's time
// (38 blocks of 16 rows: 29% of the SMs); it is not built in this version
// (PERF.md records the tracking shape's time and the reason).
#include "mma.cuh"

namespace {

using mma::kThreads;

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
  Rk4Plan plan;
};

template <typename T, int MT>
__global__ void __launch_bounds__(kThreads) rk4_kernel(const Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kRows = 16 * MT;
  constexpr int kM = mma::WarpTile<MT>::kM;  // m-tiles of a warp
  constexpr int kStep = sizeof(T) == 2 ? 16 : 8;  // mma depth
  const Rk4Plan& pl = P.plan;
  const int D = P.D, H1 = P.H1, dp = pl.dpad;
  float* X = reinterpret_cast<float*>(smem + pl.off_state);  // x
  float* XT = X + kRows * dp;                                // stage input, f32
  float* KS = XT + kRows * dp;                               // the four slopes
  float* scr = reinterpret_cast<float*>(smem + pl.off_scratch);
  T* Pb = reinterpret_cast<T*>(smem + pl.off_p);  // xt operand, then pf
  T* Qb = reinterpret_cast<T*>(smem + pl.off_q);  // relu(xt W0 + b0), then hid
  const int r0 = blockIdx.x * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const int re = pl.ring_elems, es = sizeof(T);
  const mma::Prod prods[4] = {
      mma::make_prod(P.w0, D, P.P1, es, re), mma::make_prod(P.w1, P.P1, P.P2, es, re),
      mma::make_prod(P.wp, P.P2, H1, es, re), mma::make_prod(P.w2, H1, D, es, re)};
  // W2 resident (plan.cuh) or streamed as the fourth product
  const int nprod = pl.w2_rows > 0 ? 3 : 4;
  mma::Stream<T> ws = {reinterpret_cast<T*>(smem + pl.off_ring), pl.ring_elems, pl.nbuf};
  ws.start(prods, nprod, mma::pass_tiles(prods, nprod) * 4 * P.n);
  T* W2s = reinterpret_cast<T*>(smem + pl.off_w2);
  const int ldw2 = tile_ld(D);
  if (pl.w2_rows > 0) {
    const T* w2 = static_cast<const T*>(P.w2);
    for (int e = threadIdx.x; e < pl.w2_rows * 16; e += blockDim.x) {
      const int k = e / 16, d = e % 16;
      W2s[k * ldw2 + d] = k < H1 && d < D ? w2[static_cast<size_t>(k) * D + d] : from_f32<T>(0.f);
    }
  }

  for (int e = threadIdx.x; e < kRows * dp; e += blockDim.x) {
    const int r = e / dp, d = e % dp;
    X[e] = (d < D && r0 + r < P.R) ? P.x0[static_cast<size_t>(r0 + r) * D + d] : 0.f;
  }
  __syncthreads();

  // the last product's warps: (m-tile, n-tile) pairs, the depth split kg ways
  constexpr int kUnits = 2 * MT, kSplit = mma::kWarps / kUnits;
  const int u_mt = (warp % kUnits) / 2, u_nt = warp % 2, u_kg = warp / kUnits;

  const int stage_j[4] = {0, 1, 1, 2};
  const float stage_c[4] = {0.f, 0.5f, 0.5f, 1.f};
  float h6 = 0.f;  // h / 6 of the step before
  for (int i = 0; i < P.n; ++i) {
    const float* sc = P.scal + 7 * i;
    const float h = sc[0];
    for (int s = 0; s < 4; ++s) {
      const int j = stage_j[s];
      const float cs = stage_c[s] * h;
      // glue: the RK4 update of the step before, the stage input; operand
      // columns D..15 zero. Ordered before product 1 by Stream::next.
      const int ldp = pl.ldp;
      for (int e = threadIdx.x; e < kRows * 16; e += blockDim.x) {
        const int r = e / 16, d = e % 16;
        float xt = 0.f;
        if (d < D) {
          const int k = r * dp + d;
          if (s == 0) {
            if (i > 0) {
              const int q = kRows * dp;
              X[k] = X[k] + h6 * (((KS[k] + 2.f * KS[q + k]) + 2.f * KS[2 * q + k]) +
                                  KS[3 * q + k]);
            }
            xt = X[k];
          } else {
            xt = X[k] + cs * KS[(s - 1) * kRows * dp + k];
          }
          XT[k] = xt;
        }
        Pb[r * ldp + d] = from_f32<T>(xt);
      }

      // products 1-3: xt -> Q, Q -> P, P -> Q
      const float* trow = P.trows + (static_cast<size_t>(i) * 3 + j) * H1;
      for (int l = 0; l < 3; ++l) {
        const mma::Prod& pr = prods[l];
        const T* Ain = l == 1 ? Qb : Pb;
        T* Aout = l == 1 ? Pb : Qb;
        const int lda = l == 1 ? pl.ldq : pl.ldp, ldo = l == 1 ? pl.ldp : pl.ldq;
        const int K16 = round_up(pr.K, 16);
        for (int c = 0; c < pr.nch; ++c) {
          int cols, kt, nkt;
          pr.chunk(c, cols, kt, nkt);
          const int cols16 = round_up(cols, 16), ldw = tile_ld(cols);
          const mma::WarpTile<MT> wt = mma::warp_tile<MT>(cols);
          const int n0 = c * kChunkCols + wt.n0 + 2 * (lane & 3);  // + 8 j + (e & 1)
          const int rw = (lane >> 2) + 16 * wt.mg;                     // + 16 nmg i + 8 (e >> 1)
          // the epilogue's operands, loaded before the products so that their
          // latency hides behind them: each column's bias (product 3: its t
          // row); product 3's sums start from each element's static part
          const float* colp = l == 0 ? P.b0 : l == 1 ? P.b1 : trow;
          float colv[4][2];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int o = n0 + 8 * jj + u;
              colv[jj][u] = wt.active && o < pr.N ? colp[o] : 0.f;
            }
          float acc[kM][4][4];
#pragma unroll
          for (int i = 0; i < kM; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int o = n0 + 8 * jj + (e & 1), r = r0 + rw + 16 * wt.nmg * i + 8 * (e >> 1);
                acc[i][jj][e] = l == 2 && wt.active && wt.has_m(i) && jj < wt.kNT && o < pr.N &&
                                        r < P.R
                                    ? P.stat[static_cast<size_t>(r) * H1 + o]
                                    : 0.f;
              }
          for (int ti = 0; ti < nkt; ++ti) {
            const int k0 = ti * kt;
            const T* Wt = ws.next();
            if (wt.active)
              mma::tile_mma<T, MT>(acc, wt, Ain, lda, k0, Wt, ldw, min(kt, K16 - k0), cols16);
          }
          if (!wt.active) continue;
          // columns past N hold zeros: the next product's padded depth
#pragma unroll
          for (int i = 0; i < kM; ++i) {
            if (!wt.has_m(i)) continue;
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              if (!wt.has_n(jj, cols16)) continue;
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int o = n0 + 8 * jj + (e & 1), r = rw + 16 * wt.nmg * i + 8 * (e >> 1);
                const float v = fmaxf(acc[i][jj][e] + colv[jj][e & 1], 0.f);
                Aout[r * ldo + o] = from_f32<T>(o < pr.N ? v : 0.f);
              }
            }
          }
        }
      }

      // product 4: hid (Q) W2 -> the slope. Q is complete once every warp
      // is past product 3's epilogue (a resident W2 has no Stream::next)
      __syncthreads();
      {
        const int K16 = round_up(H1, 16);
        int cols, kt, nkt;  // one chunk of D columns
        prods[3].chunk(0, cols, kt, nkt);
        if (pl.w2_rows > 0) kt = K16, nkt = 1;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int ti = 0; ti < nkt; ++ti) {
          const int k0 = ti * kt;
          const T* Wt = pl.w2_rows > 0 ? W2s : ws.next();
          const int kn = min(kt, K16 - k0);
          for (int kk = u_kg * kStep; kk < kn; kk += kSplit * kStep)
            mma::mma_one(acc, Qb, pl.ldq, 16 * u_mt, k0 + kk, Wt, ldw2, kk, 8 * u_nt);
        }
        // the depth split's partial sums, then their sum in a fixed order
        const int g = lane >> 2, t = lane & 3;
        float* part = scr + u_kg * kRows * 16;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part[(16 * u_mt + g + 8 * (e >> 1)) * 16 + 8 * u_nt + 2 * t + (e & 1)] = acc[e];
        __syncthreads();
        const float q = sc[1 + j], a = sc[4 + j];
        for (int e = threadIdx.x; e < kRows * D; e += blockDim.x) {
          const int r = e / D, d = e % D;
          float sum = 0.f;
          for (int kg = 0; kg < kSplit; ++kg) sum += scr[(kg * kRows + r) * 16 + d];
          const int k = r * dp + d;
          KS[s * kRows * dp + k] = (sum + P.b2[d]) * q + a * XT[k];
        }
        __syncthreads();
      }
    }
    h6 = h / 6.f;
  }

  for (int e = threadIdx.x; e < kRows * D; e += blockDim.x) {
    const int r = e / D, d = e % D;
    const int k = r * dp + d, q = kRows * dp;
    const float x = P.n == 0 ? X[k]
                             : X[k] + h6 * (((KS[k] + 2.f * KS[q + k]) + 2.f * KS[2 * q + k]) +
                                            KS[3 * q + k]);
    if (r0 + r < P.R) P.out[static_cast<size_t>(r0 + r) * D + d] = x;
  }
}

template <typename T, int MT>
cudaError_t launch_typed(const Params& P, cudaStream_t st) {
  cudaError_t err = allow_smem(rk4_kernel<T, MT>, P.plan.smem_bytes);
  if (err != cudaSuccess) return err;
  const int grid = (P.R + 16 * MT - 1) / (16 * MT);
  rk4_kernel<T, MT><<<grid, kThreads, P.plan.smem_bytes, st>>>(P);
  return cudaGetLastError();
}

}  // namespace

// One fused integration; see Params for the layouts. bf16 != 0: the four
// weight matrices are bf16, otherwise f32. Returns a CUDA error code, or -1
// for shapes the kernel does not take (D above 16).
extern "C" int gp2_rk4(const float* x0, float* out, const float* stat, const float* trows,
                       const float* scal, const void* w0, const float* b0, const void* w1,
                       const float* b1, const void* wp, const void* w2, const float* b2,
                       int R, int D, int P1, int P2, int H1, int n, int bf16, void* stream) {
  Params P = {x0, out, stat, trows, scal, w0, b0, w1, b1, wp, w2, b2, R, D, P1, P2, H1, n};
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rk4_plan(R, D, P1, P2, H1, bf16, sms, &P.plan) != 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    err = P.plan.rows == 32 ? launch_typed<__nv_bfloat16, 2>(P, st)
                            : launch_typed<__nv_bfloat16, 1>(P, st);
  else
    err = P.plan.rows == 32 ? launch_typed<float, 2>(P, st) : launch_typed<float, 1>(P, st);
  return static_cast<int>(err);
}
