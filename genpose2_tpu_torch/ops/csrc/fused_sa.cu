// Fused set abstraction: grouping of the projected features, centering,
// folded-BN affine, the SharedMLP chain and the max over slots, in three
// entries that share one kernel template:
//
// - gp2_sa_stage: every MSG scale of one stage in one launch, hits from the
//   in-kernel ball query.
//   Replaces: genpose2_tpu/ops/fused_sa.py:fused_sa_stage (_sa_stage_kernel).
// - gp2_sa_scale: one scale, hits from the in-kernel ball query; the route the
//   JAX package takes when a stage's VMEM estimate is over 12 MB (at 2,048
//   points, stage 0 of every PointNet++ encoder).
//   Replaces: genpose2_tpu/ops/fused_sa.py:fused_sa_scale (_sa_scale_kernel).
// - gp2_group_mlp_pool: one scale, hits read from precomputed indices.
//   Replaces: genpose2_tpu/ops/fused_sa.py:fused_group_mlp_pool (_kernel).
//
// Semantics, per scale and centroid. Ball-query hits: the first `nsample`
// points with d2 < r2, in ascending index order; slots past the hit count
// repeat the first hit, and a centroid with no hit groups point 0 in every
// slot. Index hits: the `nsample` given indices, where an index outside
// [0, N) groups a zero row (the TPU kernel's one-hot product selects
// nothing). Each slot's row g runs h = relu((g - center) * a0 + c0), then
// h = relu((h W_l) * a_l + c_l) per layer, and the output is the max over
// slots. A slot that repeats an earlier slot's point yields the same row, so
// the max needs each distinct point once: the kernel evaluates exactly the
// min(count, nsample) real ball-query rows (or the one point-0 row), and the
// distinct indices of an index list. This is the GPU form of the TPU
// kernels' dynamic slot-chunk skip, and it is exact.
//
// What bounds it on this card. The MLP chain is ~98% of the work (~1.9e11
// FLOP per encoder forward at the main path's shape, every slot real): on the
// tensor cores 0.2 ms in bf16 and 1.2 ms at 3xTF32's rate (a third of TF32's
// 495 TFLOP/s). The weights of stage 3 (256x384 + 384x512 per scale, 590 KB
// in bf16) do not fit in shared memory, so the TPU's all-resident design does
// not carry over: each 64-row chunk streams its scale's weights from L2
// again, and as in ode_rk4.cu that stream, not the products, sets the pace at
// stages 2 and 3 (PERF.md, section 6). At stage 0 (widths 16-64) the ball-query
// scan and the gather do. The scan is a warp per centroid over the points
// until every scale is full: at 2,048 points (the dense configuration's stage
// 0) twice the 1,024-point scan; the per-scale entry scans once per scale
// where the stage entry shares one scan between its scales.
//
// Design:
// - one block of 16 warps per (object, tile of 16 centroids; 8 or 4 where
//   the plan needs the room, as float32's stage 3 does), all scales in the
//   block; for ball-query hits the object's points are staged in shared
//   memory once and shared by all scales (the TPU kernel's shared distance
//   matrix);
// - hit lists: one warp per centroid scans the points in order, 32 at a
//   time; __ballot_sync + __popc give each hit its rank, the first nsample
//   are kept, and the scan stops once every scale is full. Index lists: one
//   warp per centroid, each lane tests one slot against the earlier slots and
//   a ballot compacts the distinct ones;
// - the real rows of the tile, grouped by centroid, go through the chain
//   `rows` at a time (plan.cuh:sa_plan: 64, or 32 where 64 does not fit):
//   layer 0 gathers, centers and applies the affine into a row-major operand
//   buffer in the compute type; each later layer is a (rows x K) x (K x N)
//   product on the tensor cores (mma.cuh: bf16 mma.sync m16n8k16, float32
//   3xTF32 on m16n8k8), 256 output columns a pass, a warp owning 32 columns
//   of half the rows (narrow layers: the rows split between more warps),
//   whose epilogue applies the affine + relu in registers and writes the next
//   operand (two buffers alternate);
// - the weights stream through a ring of 2-3 shared-memory tiles by cp.async
//   (mma.cuh:Stream), ahead across layers and row chunks; widths that are not
//   a multiple of 16 (196 at stage 2, the tests' 40, 48) are zero-filled
//   while staging and in the operand buffers;
// - the last layer max-reduces into the centroids' pooled outputs in shared
//   memory: every value is >= 0 after the relu and the outputs start at +0,
//   so a signed atomicMax on the float's bits is exact in any order; where
//   all 16 rows of an mma tile belong to one centroid (the common case: full
//   scales have 16 or 32 rows) a warp max over the tile's rows comes first
//   and one lane in eight issues the atomic.
#include "mma.cuh"

namespace {

using mma::kThreads;
constexpr int kMaxScales = kSaMaxScales;
constexpr int kMaxLayers = kSaMaxLayers;
constexpr int kPtrsPerScale = 4 + 3 * kMaxLayers;

struct Scale {
  const void* proj;      // (B, N, width[0]) in the compute type
  const float* center;   // (B, M, width[0])
  const float* a0;       // (width[0],) folded BN of the projection
  const float* c0;
  const void* W[kMaxLayers];  // (width[l], width[l+1]) in the compute type
  const float* a[kMaxLayers];
  const float* c[kMaxLayers];
  int width[kMaxLayers + 1];
  int num_layers;
  int nsample;
  int idx_off;  // this scale's slots in a centroid's hit list
  int out_off;  // this scale's channels in the output
  float r2;
};

struct Params {
  Scale s[kMaxScales];
  const int* idx;  // (B, M, nsample) given indices (index hits only)
  int n_scales;
  int B, N, M, C_total;
  SaPlan plan;
};

// Hit lists from the ball query: all scales from one distance per
// (centroid, point). Writes hits[] and the real row count of each scale.
template <int kS>
__device__ void ball_hits(const Params& P, const float* xs, const float* ys, const float* zs,
                          const float* q, int* hits, int* nrow) {
  const int lane = threadIdx.x & 31;
  const unsigned lt_mask = (1u << lane) - 1u;
  const float cx = q[0], cy = q[1], cz = q[2];
  int cnt[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) cnt[s] = 0;
  for (int p0 = 0; p0 < P.N; p0 += 32) {
    const int p = p0 + lane;
    const float d2 = p < P.N ? sq_dist(xs[p], ys[p], zs[p], cx, cy, cz) : 0.f;
    bool full = true;
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      if (s < P.n_scales) {
        const bool hit = p < P.N && d2 < P.s[s].r2;
        const unsigned ballot = __ballot_sync(0xffffffffu, hit);
        const int rank = cnt[s] + __popc(ballot & lt_mask);
        if (hit && rank < P.s[s].nsample) hits[P.s[s].idx_off + rank] = p;
        cnt[s] += __popc(ballot);
        full = full && cnt[s] >= P.s[s].nsample;
      }
    }
    if (full) break;  // warp-uniform: only the first nsample hits matter
  }
  if (lane == 0) {
    for (int s = 0; s < P.n_scales; ++s) {
      int n = min(cnt[s], P.s[s].nsample);
      if (n == 0) {  // no hit: every slot groups point 0
        hits[P.s[s].idx_off] = 0;
        n = 1;
      }
      nrow[s] = n;
    }
  }
}

// Hit list from given indices (one scale): the distinct entries in slot
// order, every index outside [0, N) folded into one -1 (a zero row).
__device__ void index_hits(const Params& P, const int* given, int* hits, int* nrow) {
  const int lane = threadIdx.x & 31;
  const unsigned lt_mask = (1u << lane) - 1u;
  const int S = P.s[0].nsample, N = P.N;
  int cnt = 0;
  for (int j0 = 0; j0 < S; j0 += 32) {
    const int j = j0 + lane;
    bool keep = false;
    int p = -1;
    if (j < S) {
      p = given[j];
      if (p < 0 || p >= N) p = -1;
      keep = true;
      for (int k = 0; k < j && keep; ++k) {
        int e = given[k];
        if (e < 0 || e >= N) e = -1;
        keep = e != p;
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (keep) hits[cnt + __popc(ballot & lt_mask)] = p;
    cnt += __popc(ballot);
  }
  if (lane == 0) nrow[0] = cnt;
}

// The last layer's epilogue for one warp: relu(z * a + c) of each row,
// max-reduced into pooled[centroid * cout + o] (int bits of floats >= 0).
// o0: the column of n-tile 0's first pair in this lane; ca, cc: the affine of
// the warp's columns (n-tile j, pair member u), 0 past N.
template <int MT>
__device__ __forceinline__ void pool_max(const float (&z)[mma::WarpTile<MT>::kM][4][4],
                                         const mma::WarpTile<MT>& w,
                                         int cols16, int o0, int N, const float (&ca)[4][2],
                                         const float (&cc)[4][2], const int* row_c, int* pooled,
                                         int cout) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
#pragma unroll
  for (int i = 0; i < mma::WarpTile<MT>::kM; ++i) {
    if (!w.has_m(i)) continue;
    const int m0 = 16 * (w.mg + i * w.nmg);
    const int c_first = row_c[m0], c_lo = row_c[m0 + g], c_hi = row_c[m0 + g + 8];
    const bool one = c_first >= 0 && c_first == row_c[m0 + 15];  // warp-uniform
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!w.has_n(j, cols16)) continue;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int o = o0 + 8 * j + u;
        const bool in = o < N;
        const float v_lo = fmaxf(z[i][j][u] * ca[j][u] + cc[j][u], 0.f);
        const float v_hi = fmaxf(z[i][j][2 + u] * ca[j][u] + cc[j][u], 0.f);
        if (one) {
          float v = fmaxf(v_lo, v_hi);
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
          if (g == 0 && in) atomicMax(pooled + c_first * cout + o, __float_as_int(v));
        } else if (in) {
          if (c_lo >= 0) atomicMax(pooled + c_lo * cout + o, __float_as_int(v_lo));
          if (c_hi >= 0) atomicMax(pooled + c_hi * cout + o, __float_as_int(v_hi));
        }
      }
    }
  }
}

// kS: the most scales the instance takes (1: the per-scale entries);
// kIndexed: hits from P.idx instead of the ball query; MT: 16-row mma tiles
// of a row chunk.
template <typename T, int kS, bool kIndexed, int MT>
__global__ void __launch_bounds__(kThreads)
sa_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
          float* __restrict__ out, const Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kRC = 16 * MT;  // rows per chunk
  const SaPlan& pl = P.plan;
  const int N = P.N, M = P.M;
  const int n_staged = kIndexed ? 0 : round_up(N, 4);
  const int tc = pl.centroids;  // centroids of the block
  const int b = blockIdx.y, m0 = blockIdx.x * tc;
  float* acc = reinterpret_cast<float*>(smem + pl.off_acc);  // (tc, cout) pooled outputs
  float* xs = reinterpret_cast<float*>(smem + pl.off_xyz);
  float* ys = xs + n_staged;
  float* zs = ys + n_staged;
  int* idx = reinterpret_cast<int*>(smem + pl.off_idx);    // (tc, idx_stride)
  int* nrow = reinterpret_cast<int*>(smem + pl.off_nrow);  // (tc, kS) rows per centroid
  int* rstart = reinterpret_cast<int*>(smem + pl.off_rstart);
  int* row_c = reinterpret_cast<int*>(smem + pl.off_rowc);
  int* row_p = reinterpret_cast<int*>(smem + pl.off_rowp);
  T* bufA = reinterpret_cast<T*>(smem + pl.off_a);
  T* bufB = reinterpret_cast<T*>(smem + pl.off_b);

  if (!kIndexed) {
    const float* pts = xyz + static_cast<size_t>(b) * N * 3;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      xs[i] = pts[3 * i + 0];
      ys[i] = pts[3 * i + 1];
      zs[i] = pts[3 * i + 2];
    }
    __syncthreads();
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int c = warp; c < tc; c += nwarps) {
    const int m = m0 + c;
    int* hits = idx + c * pl.idx_stride;
    if (m >= M) {
      if (lane < kS) nrow[c * kS + lane] = 0;
      continue;
    }
    if (kIndexed)
      index_hits(P, P.idx + (static_cast<size_t>(b) * M + m) * P.s[0].nsample, hits,
                 nrow + c * kS);
    else
      ball_hits<kS>(P, xs, ys, zs, new_xyz + (static_cast<size_t>(b) * M + m) * 3, hits,
                    nrow + c * kS);
  }
  __syncthreads();

  mma::Stream<T> ws = {reinterpret_cast<T*>(smem + pl.off_ring), pl.ring_elems, pl.nbuf};
  mma::Prod prods[kMaxLayers];
  for (int s = 0; s < P.n_scales; ++s) {
    const Scale& S = P.s[s];
    const T* proj = static_cast<const T*>(S.proj);
    const int L = S.num_layers;
    const int h1 = S.width[0];
    const int cout = S.width[L];
    if (threadIdx.x == 0) {
      int t = 0;
      for (int c = 0; c < tc; ++c) {
        rstart[c] = t;
        t += nrow[c * kS + s];
      }
      rstart[tc] = t;
    }
    for (int e = threadIdx.x; e < tc * cout; e += blockDim.x) acc[e] = 0.f;  // rows are >= 0
    __syncthreads();
    const int total = rstart[tc];

    for (int l = 0; l < L; ++l)
      prods[l] = mma::make_prod(S.W[l], S.width[l], S.width[l + 1], sizeof(T), pl.ring_elems);
    if (L > 0)
      ws.start(prods, L, mma::pass_tiles(prods, L) * ((total + kRC - 1) / kRC));

    for (int r0 = 0; r0 < total; r0 += kRC) {
      __syncthreads();  // the chunk before is done with row_c, row_p and bufA
      if (threadIdx.x < kRC) {
        const int r = r0 + threadIdx.x;
        int c = -1, p = 0;
        if (r < total) {
          c = 0;
          while (rstart[c + 1] <= r) ++c;
          p = idx[c * pl.idx_stride + S.idx_off + (r - rstart[c])];
        }
        row_c[threadIdx.x] = c;
        row_p[threadIdx.x] = p;  // -1: an index outside [0, N), a zero row
      }
      __syncthreads();

      if (L == 0) {  // no MLP layer: pool the projection itself
        for (int j = threadIdx.x; j < h1; j += blockDim.x) {
          for (int rr = 0; rr < kRC; ++rr) {
            const int c = row_c[rr];
            if (c < 0) continue;
            const int p = row_p[rr];
            const float g = p < 0 ? 0.f : to_f32(proj[(static_cast<size_t>(b) * N + p) * h1 + j]);
            const float ctr = S.center[(static_cast<size_t>(b) * M + m0 + c) * h1 + j];
            const float v = fmaxf((g - ctr) * S.a0[j] + S.c0[j], 0.f);
            acc[c * cout + j] = fmaxf(acc[c * cout + j], v);
          }
        }
        continue;
      }

      // layer 0: gather the projected row, center, folded BN, relu; the
      // operand's columns h1..K16-1 and the rows past the last zero.
      // Ordered before the first product by Stream::next.
      const int h16 = round_up(h1, 16);
      for (int e = threadIdx.x; e < kRC * h16; e += blockDim.x) {
        const int rr = e / h16, j = e % h16;
        const int c = row_c[rr];
        float v = 0.f;
        if (c >= 0 && j < h1) {
          const int p = row_p[rr];
          const float g = p < 0 ? 0.f : to_f32(proj[(static_cast<size_t>(b) * N + p) * h1 + j]);
          const float ctr = S.center[(static_cast<size_t>(b) * M + m0 + c) * h1 + j];
          v = fmaxf((g - ctr) * S.a0[j] + S.c0[j], 0.f);
        }
        bufA[rr * pl.lda + j] = from_f32<T>(v);
      }

      for (int l = 0; l < L; ++l) {
        const int K = S.width[l], Nl = S.width[l + 1], K16 = round_up(K, 16);
        const T* hin = l % 2 == 0 ? bufA : bufB;
        T* hout = l % 2 == 0 ? bufB : bufA;
        const int ldi = l % 2 == 0 ? pl.lda : pl.ldb, ldo = l % 2 == 0 ? pl.ldb : pl.lda;
        const float* al = S.a[l];
        const float* cl = S.c[l];
        for (int c = 0; c < prods[l].nch; ++c) {
          int cols, kt, nkt;
          prods[l].chunk(c, cols, kt, nkt);
          const int cols16 = round_up(cols, 16), ldw = tile_ld(cols);
          const mma::WarpTile<MT> wt = mma::warp_tile<MT>(cols);
          // this lane's first column; the affine of its columns, loaded
          // before the product so that the loads' latency hides behind it
          const int o0 = c * kChunkCols + wt.n0 + 2 * (lane & 3);
          float ca[4][2], cc[4][2];
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const bool in = wt.active && o0 + 8 * j + u < Nl;
              ca[j][u] = in ? al[o0 + 8 * j + u] : 0.f;
              cc[j][u] = in ? cl[o0 + 8 * j + u] : 0.f;
            }
          float z[mma::WarpTile<MT>::kM][4][4];
          mma::zero(z);
          for (int ti = 0; ti < nkt; ++ti) {
            const int k0 = ti * kt;
            const T* Wt = ws.next();
            if (wt.active)
              mma::tile_mma<T, MT>(z, wt, hin, ldi, k0, Wt, ldw, min(kt, K16 - k0), cols16);
          }
          if (!wt.active) continue;
          if (l == L - 1) {
            pool_max(z, wt, cols16, o0, Nl, ca, cc, row_c, reinterpret_cast<int*>(acc), cout);
            continue;
          }
          // columns past N hold zeros: the next layer's padded depth
          const int rw = (lane >> 2) + 16 * wt.mg;
#pragma unroll
          for (int i = 0; i < mma::WarpTile<MT>::kM; ++i) {
            if (!wt.has_m(i)) continue;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (!wt.has_n(j, cols16)) continue;
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int o = o0 + 8 * j + (e & 1), r = rw + 16 * wt.nmg * i + 8 * (e >> 1);
                const float v = fmaxf(z[i][j][e] * ca[j][e & 1] + cc[j][e & 1], 0.f);
                hout[r * ldo + o] = from_f32<T>(o < Nl ? v : 0.f);
              }
            }
          }
        }
      }
    }
    __syncthreads();

    for (int e = threadIdx.x; e < tc * cout; e += blockDim.x) {
      const int c = e / cout, o = e % cout;
      if (m0 + c < M)
        out[(static_cast<size_t>(b) * M + m0 + c) * P.C_total + S.out_off + o] = acc[e];
    }
    __syncthreads();
  }
}

// Fill the scales of P from the flat argument arrays (see the entries) and
// the plan; returns false for a configuration the kernel does not take.
bool fill_params(Params& P, int n_scales, int B, int N, int M, int C_total,
                 const float* r2, const int* nsample, const int* num_layers, const int* widths,
                 const void* const* ptrs, bool indexed, int bf16) {
  if (sa_plan(n_scales, nsample, num_layers, widths, indexed ? 0 : N, bf16, &P.plan) != 0)
    return false;
  P.n_scales = n_scales;
  P.B = B;
  P.N = N;
  P.M = M;
  P.C_total = C_total;
  int idx_off = 0, out_off = 0;
  for (int s = 0; s < n_scales; ++s) {
    Scale& S = P.s[s];
    const void* const* p = ptrs + s * kPtrsPerScale;
    S.proj = p[0];
    S.center = static_cast<const float*>(p[1]);
    S.a0 = static_cast<const float*>(p[2]);
    S.c0 = static_cast<const float*>(p[3]);
    S.num_layers = num_layers[s];
    for (int l = 0; l <= S.num_layers; ++l) S.width[l] = widths[s * (kMaxLayers + 1) + l];
    for (int l = 0; l < S.num_layers; ++l) {
      S.W[l] = p[4 + 3 * l];
      S.a[l] = static_cast<const float*>(p[5 + 3 * l]);
      S.c[l] = static_cast<const float*>(p[6 + 3 * l]);
    }
    S.nsample = nsample[s];
    S.r2 = r2 == nullptr ? 0.f : r2[s];
    S.idx_off = idx_off;
    S.out_off = out_off;
    idx_off += S.nsample;
    out_off += S.width[S.num_layers];
  }
  return out_off == C_total;
}

template <typename T, int kS, bool kIndexed, int MT>
int launch_typed(const float* xyz, const float* new_xyz, float* out, const Params& P,
                 cudaStream_t st) {
  const size_t smem = P.plan.smem_bytes;
  cudaError_t err = allow_smem(sa_kernel<T, kS, kIndexed, MT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tc = P.plan.centroids;
  const dim3 grid((P.M + tc - 1) / tc, P.B);
  sa_kernel<T, kS, kIndexed, MT><<<grid, kThreads, smem, st>>>(xyz, new_xyz, out, P);
  return static_cast<int>(cudaGetLastError());
}

template <int kS, bool kIndexed>
int launch(const float* xyz, const float* new_xyz, float* out, const Params& P, int bf16,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = P.plan.rows == 64;
  if (bf16)
    return wide ? launch_typed<__nv_bfloat16, kS, kIndexed, 4>(xyz, new_xyz, out, P, st)
                : launch_typed<__nv_bfloat16, kS, kIndexed, 2>(xyz, new_xyz, out, P, st);
  return wide ? launch_typed<float, kS, kIndexed, 4>(xyz, new_xyz, out, P, st)
              : launch_typed<float, kS, kIndexed, 2>(xyz, new_xyz, out, P, st);
}

}  // namespace

// xyz (B, N, 3), new_xyz (B, M, 3) f32 -> out (B, M, C_total) f32.
// Per scale s: r2[s], nsample[s], num_layers[s], widths[s * 5 + 0..num_layers]
// and ptrs[s * 16 + ...] = proj, center, a0, c0, then W, a, c of each layer.
// bf16 != 0: proj and W are bf16, otherwise f32. Returns a CUDA error code,
// or -1 for a configuration the kernel does not take.
extern "C" int gp2_sa_stage(const float* xyz, const float* new_xyz, float* out, int B, int N,
                            int M, int C_total, int n_scales, const float* r2,
                            const int* nsample, const int* num_layers, const int* widths,
                            const void* const* ptrs, int bf16, void* stream) {
  Params P = {};
  if (!fill_params(P, n_scales, B, N, M, C_total, r2, nsample, num_layers, widths, ptrs, false,
                   bf16))
    return -1;
  return launch<kMaxScales, false>(xyz, new_xyz, out, P, bf16, stream);
}

// One scale of a stage: the arguments of gp2_sa_stage with one scale.
extern "C" int gp2_sa_scale(const float* xyz, const float* new_xyz, float* out, int B, int N,
                            int M, int C_out, float r2, int nsample, int num_layers,
                            const int* widths, const void* const* ptrs, int bf16, void* stream) {
  Params P = {};
  if (!fill_params(P, 1, B, N, M, C_out, &r2, &nsample, &num_layers, widths, ptrs, false, bf16))
    return -1;
  return launch<1, false>(xyz, new_xyz, out, P, bf16, stream);
}

// idx (B, M, S) int32 point indices, the projection rows proj (B, N, h1) ->
// out (B, M, C_out) f32; widths and ptrs as one scale of gp2_sa_stage.
extern "C" int gp2_group_mlp_pool(const int* idx, float* out, int B, int N, int M, int S,
                                  int C_out, int num_layers, const int* widths,
                                  const void* const* ptrs, int bf16, void* stream) {
  Params P = {};
  if (!fill_params(P, 1, B, N, M, C_out, nullptr, &S, &num_layers, widths, ptrs, true, bf16))
    return -1;
  P.idx = idx;
  return launch<1, true>(nullptr, nullptr, out, P, bf16, stream);
}
