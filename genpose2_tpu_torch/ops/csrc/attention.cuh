// One head of softmax attention for a tile of TQ queries, in shared memory.
// Shared by relpe_attention.cu and vit_attention.cu.
//
// Layouts (all in shared memory):
//   qt  [D][TQ]     float  the query tile, d-major (float4 broadcasts)
//   kt  [D][M]      T      the head's keys, d-major (lanes read neighbouring keys)
//   vs  [M][D]      T      the head's values, key-major
//   st  [M][TQ + 4] float  scores, then probabilities
//   red [8 * threads] float partial sums of the PV product
// q, k, v are token-major in device memory: element (b, j, h*D + d) at
// (b * M + j) * C + h * D + d.
#pragma once

#include "common.cuh"

// Row stride of st: TQ + 4 floats keeps every row 16-byte aligned (float4 reads
// of 4 queries' probabilities) and spreads a warp walking one query's column
// over 8 banks.
template <int TQ> constexpr int kStride = TQ + 4;

// Stage head h of object b: K and V of all M keys and Q of the tile's nq queries
// (rows nq..TQ-1 of qt are zero). Where a head's row is a whole number of
// 16-byte vectors (D a multiple of 16 / sizeof(T)), each thread issues four
// vector loads of K and four of V before it stores any: the copy is bound by
// the latency of device memory, and a scalar loop waits on one load at a time.
template <typename T, int TQ>
__device__ __forceinline__ void stage_head(const T* __restrict__ q, const T* __restrict__ k,
                                           const T* __restrict__ v, int b, int h, int i0,
                                           int nq, int M, int C, int D, float* qt, T* kt,
                                           T* vs) {
  constexpr int kVec = 16 / sizeof(T), kUnroll = 4;
  const size_t obj = static_cast<size_t>(b) * M;
  const bool aligned = (reinterpret_cast<size_t>(k) | reinterpret_cast<size_t>(v)) % 16 == 0;
  if (aligned && D % kVec == 0 && C % kVec == 0) {
    const int vd = D / kVec, total = M * vd;
    for (int e0 = threadIdx.x; e0 < total; e0 += kUnroll * blockDim.x) {
      uint4 kv[kUnroll], vv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = e0 + u * blockDim.x;
        if (e < total) {
          const int j = e / vd, d = (e - j * vd) * kVec;
          const size_t g = (obj + j) * C + h * D + d;
          kv[u] = __ldg(reinterpret_cast<const uint4*>(k + g));
          vv[u] = __ldg(reinterpret_cast<const uint4*>(v + g));
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = e0 + u * blockDim.x;
        if (e < total) {
          const int j = e / vd, d = (e - j * vd) * kVec;
          *reinterpret_cast<uint4*>(vs + j * D + d) = vv[u];
          const T* kk = reinterpret_cast<const T*>(&kv[u]);
#pragma unroll
          for (int i = 0; i < kVec; ++i) kt[(d + i) * M + j] = kk[i];
        }
      }
    }
  } else {
    for (int e = threadIdx.x; e < M * D; e += blockDim.x) {
      const int j = e / D, d = e - j * D;
      const size_t g = (obj + j) * C + h * D + d;
      kt[d * M + j] = k[g];
      vs[j * D + d] = v[g];
    }
  }
  for (int e = threadIdx.x; e < TQ * D; e += blockDim.x) {
    const int r = e / D, d = e - r * D;
    qt[d * TQ + r] = r < nq ? to_f32(q[(obj + i0 + r) * C + h * D + d]) : 0.f;
  }
}

// st[j][r] = (sum_d q[r][d] * k[j][d]) * scale + add(r, j): one thread per key,
// TQ sums in registers. The product of two bf16 values is exact in float32, so
// bf16 and float32 inputs differ from a float32 reference only in summation order.
template <typename T, int TQ, typename Add>
__device__ __forceinline__ void head_scores(const float* qt, const T* kt, int M, int D,
                                            float scale, float* st, Add add) {
  for (int j = threadIdx.x; j < M; j += blockDim.x) {
    float acc[TQ];
    dot_rows<TQ, T>(qt, D, kt, M, j, acc);
#pragma unroll
    for (int r = 0; r < TQ; ++r) st[j * kStride<TQ> + r] = acc[r] * scale + add(r, j);
  }
}

// Row softmax over the M keys of each of the nq queries, one warp per row:
// p = exp(s - max) / sum, in float32, then rounded to T (the PV product's
// operand type, as the reference casts p to v's dtype before that product).
template <typename T, int TQ>
__device__ __forceinline__ void softmax_rows(float* st, int M, int nq) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < nq; r += warps) {
    float mx = -3.0e38f;
    for (int j = lane; j < M; j += 32) mx = fmaxf(mx, st[j * kStride<TQ> + r]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < M; j += 32) {
      const float e = expf(st[j * kStride<TQ> + r] - mx);
      st[j * kStride<TQ> + r] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < M; j += 32) {
      st[j * kStride<TQ> + r] = to_f32(from_f32<T>(st[j * kStride<TQ> + r] / sum));
    }
  }
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// out[r * ldo + d] = sum_j p[r][j] * v[j][d] for r < nq, d < D (D even), in
// float32. Each thread owns a tile of 4 rows x 2 columns: per key one float4
// of p (a broadcast) and one pair of v feed 8 multiply-adds. When the block
// has fewer tiles than threads, the keys are split among groups of threads
// and the partial sums are added in order through red (kRedFloats per thread).
constexpr int kRedFloats = 8;

template <typename T, int TQ>
__device__ __forceinline__ void head_pv(const float* st, const T* vs, int M, int D, int nq,
                                        float* red, float* __restrict__ out, int ldo) {
  static_assert(TQ % 4 == 0, "TQ must be a multiple of 4");
  const int pairs = D / 2, tiles = (TQ / 4) * pairs;
  const int parts = blockDim.x >= 2 * tiles ? blockDim.x / tiles : 1;
  auto run = [&](int tile, int j0, int step, float (&acc)[8]) {
    const int r0 = 4 * (tile / pairs), d0 = 2 * (tile - (tile / pairs) * pairs);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
    for (int j = j0; j < M; j += step) {
      const float4 p = *reinterpret_cast<const float4*>(st + j * kStride<TQ> + r0);
      const float2 v = load_pair(vs + j * D + d0);
      acc[0] = fmaf(p.x, v.x, acc[0]); acc[1] = fmaf(p.x, v.y, acc[1]);
      acc[2] = fmaf(p.y, v.x, acc[2]); acc[3] = fmaf(p.y, v.y, acc[3]);
      acc[4] = fmaf(p.z, v.x, acc[4]); acc[5] = fmaf(p.z, v.y, acc[5]);
      acc[6] = fmaf(p.w, v.x, acc[6]); acc[7] = fmaf(p.w, v.y, acc[7]);
    }
  };
  auto store = [&](int tile, const float (&acc)[8]) {
    const int r0 = 4 * (tile / pairs), d0 = 2 * (tile - (tile / pairs) * pairs);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (r0 + i < nq) {
        out[static_cast<size_t>(r0 + i) * ldo + d0] = acc[2 * i];
        out[static_cast<size_t>(r0 + i) * ldo + d0 + 1] = acc[2 * i + 1];
      }
    }
  };
  float acc[8];
  if (parts == 1) {
    for (int tile = threadIdx.x; tile < tiles; tile += blockDim.x) {
      run(tile, 0, 1, acc);
      store(tile, acc);
    }
    return;
  }
  const int part = threadIdx.x / tiles, tile = threadIdx.x - part * tiles;
  if (part < parts) {
    run(tile, part, parts, acc);
#pragma unroll
    for (int e = 0; e < 8; ++e) red[(part * tiles + tile) * kRedFloats + e] = acc[e];
  }
  __syncthreads();
  if (threadIdx.x < tiles) {
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
    for (int p = 0; p < parts; ++p) {
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += red[(p * tiles + threadIdx.x) * kRedFloats + e];
    }
    store(threadIdx.x, acc);
  }
}

// Shared memory of one block: the float sections, then kt and vs in T.
template <typename T, int TQ>
__host__ __device__ __forceinline__ size_t head_smem_bytes(int M, int D, int threads) {
  const int floats = align4(D * TQ) + align4(M * kStride<TQ>) + align4(kRedFloats * threads);
  return static_cast<size_t>(floats) * sizeof(float) +
         static_cast<size_t>(align4(2 * M * D)) * sizeof(T);
}
