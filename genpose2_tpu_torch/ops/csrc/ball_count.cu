// In-radius point count per centroid.
//
// Replaces: genpose2_tpu/ops/ball_query_pallas.py:ball_count
// (_ball_count_kernel), a VMEM tile of (centroid, point) distances summed
// over the point axis.
//
// Semantics: out[b, m] = #{n : |xyz[b, n] - new_xyz[b, m]|^2 < r2}, with the
// distance summed in the JAX order (common.cuh:sq_dist, no FMA) and r2 =
// float32(radius * radius).
//
// What bounds it on this card: the issue of instructions. At the main path's
// shape (64 objects, 512 centroids, 1024 points) it is 33.5 M distance
// tests against 0.9 MB of input; a test is 8 float32 operations (3
// subtractions, 3 products, 2 sums, none fused), one more subtraction and
// a LEA.HI that adds its sign bit to the count (see hit()): 10
// instructions, one issue slot each, ~11 us on 132 SMs at 1.755 GHz.
//
// Design: plan.cuh:ball_count_plan. A block takes `centroids` centroids of
// one object and streams the object's cloud through shared memory in tiles
// of up to 2,048 points, staged as float4 (x, y, z, 0) from 16-byte loads,
// so that one shared-memory read brings a whole point. A thread holds `cpt`
// centroids in registers and tests each point it reads against all of them;
// the `splits` threads that hold the same centroids scan interleaved points
// (thread group s takes points s, s + splits, ...: a warp's groups read
// neighbouring points, free of bank conflicts), and their counts meet in
// shared memory by atomic adds: an integer count sums exactly in any order.
// The plan picks (lanes, cpt) so that the busiest SM holds the fewest
// centroids: 128 centroids a block at B = 64 (256 blocks), 16 at B = 12
// (384 blocks).
#include <stdint.h>

#include "common.cuh"
#include "plan.cuh"

namespace {

constexpr int kUnroll = 4;  // points read before they are tested

// 1 where d2 < r2, else 0: the sign bit of d2 - r2. The exact difference of
// two floats is a multiple of 2^-149, so it rounds to a negative number
// exactly when d2 < r2; d2 == r2 gives +0, a NaN the card's positive NaN.
// Two instructions (FADD, LEA.HI into the count) where a compare and a
// select take three: 11% less time on the H100 (PERF.md section 6).
__device__ __forceinline__ unsigned hit(float d2, float r2) {
  return __float_as_uint(__fsub_rn(d2, r2)) >> 31;
}

// Points [t0, t0 + n) of the object's cloud into shared memory as float4.
__device__ __forceinline__ void stage_tile(const float* p, int t0, int n, float4* pts) {
  const float* src = p + 3 * static_cast<size_t>(t0);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {  // 4 points from 3 16-byte loads
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int g = threadIdx.x; g < n / 4; g += blockDim.x) {
      const float4 a = __ldg(s4 + 3 * g), b = __ldg(s4 + 3 * g + 1), c = __ldg(s4 + 3 * g + 2);
      pts[4 * g + 0] = make_float4(a.x, a.y, a.z, 0.f);
      pts[4 * g + 1] = make_float4(a.w, b.x, b.y, 0.f);
      pts[4 * g + 2] = make_float4(b.z, b.w, c.x, 0.f);
      pts[4 * g + 3] = make_float4(c.y, c.z, c.w, 0.f);
    }
    done = n / 4 * 4;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) {
    pts[i] = make_float4(__ldg(src + 3 * i), __ldg(src + 3 * i + 1), __ldg(src + 3 * i + 2), 0.f);
  }
}

template <int CPT>
__global__ void __launch_bounds__(kBallCountThreads)
ball_count_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz, int N,
                  int M, float r2, BallCountPlan plan, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* pts = reinterpret_cast<float4*>(smem + plan.off_pts);
  int* counts = reinterpret_cast<int*>(smem + plan.off_cnt);
  const int b = blockIdx.y, m0 = blockIdx.x * plan.centroids;
  const int lane_c = threadIdx.x % plan.lanes, split = threadIdx.x / plan.lanes;
  for (int i = threadIdx.x; i < plan.centroids; i += blockDim.x) counts[i] = 0;

  float cx[CPT], cy[CPT], cz[CPT];
  unsigned cnt[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int m = min(m0 + c * plan.lanes + lane_c, M - 1);  // past M: counted, not written
    const float* q = new_xyz + (static_cast<size_t>(b) * M + m) * 3;
    cx[c] = q[0];
    cy[c] = q[1];
    cz[c] = q[2];
    cnt[c] = 0;
  }
  const float* cloud = xyz + static_cast<size_t>(b) * N * 3;
  const int S = plan.splits;
  for (int t0 = 0; t0 < N; t0 += plan.tile) {
    const int n = min(plan.tile, N - t0);
    if (t0 > 0) __syncthreads();  // every thread is done with the previous tile
    stage_tile(cloud, t0, n, pts);
    __syncthreads();
    int i = split;
    for (; i + (kUnroll - 1) * S < n; i += kUnroll * S) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = pts[i + u * S];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          cnt[c] += hit(sq_dist(v[u].x, v[u].y, v[u].z, cx[c], cy[c], cz[c]), r2);
        }
      }
    }
    for (; i < n; i += S) {
      const float4 v = pts[i];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        cnt[c] += hit(sq_dist(v.x, v.y, v.z, cx[c], cy[c], cz[c]), r2);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    atomicAdd(counts + c * plan.lanes + lane_c, static_cast<int>(cnt[c]));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < plan.centroids && m0 + i < M; i += blockDim.x) {
    out[static_cast<size_t>(b) * M + m0 + i] = counts[i];
  }
}

template <int CPT>
cudaError_t launch(const float* xyz, const float* new_xyz, int B, int N, int M, float r2,
                   const BallCountPlan& plan, int* out, cudaStream_t stream) {
  cudaError_t err = allow_smem(ball_count_kernel<CPT>, plan.smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + plan.centroids - 1) / plan.centroids, B);
  ball_count_kernel<CPT><<<grid, kBallCountThreads, plan.smem_bytes, stream>>>(
      xyz, new_xyz, N, M, r2, plan, out);
  return cudaGetLastError();
}

cudaError_t launch_plan(const float* xyz, const float* new_xyz, int B, int N, int M, float r2,
                        const BallCountPlan& plan, int* out, void* stream) {
  if (plan.smem_bytes > kSmemLimit || plan.lanes * plan.splits != kBallCountThreads)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (plan.cpt) {
    case 1: return launch<1>(xyz, new_xyz, B, N, M, r2, plan, out, s);
    case 2: return launch<2>(xyz, new_xyz, B, N, M, r2, plan, out, s);
    case 4: return launch<4>(xyz, new_xyz, B, N, M, r2, plan, out, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// xyz (B, N, 3), new_xyz (B, M, 3) f32 -> out (B, M) i32, on `stream`, with
// the plan of plan.cuh:ball_count_plan. Returns a CUDA error code.
extern "C" int gp2_ball_count(const float* xyz, const float* new_xyz, int B, int N, int M,
                              float r2, int* out, void* stream) {
  if (B == 0 || M == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  BallCountPlan plan;
  if (ball_count_plan(B, N, M, sms, &plan) != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_plan(xyz, new_xyz, B, N, M, r2, plan, out, stream));
}
