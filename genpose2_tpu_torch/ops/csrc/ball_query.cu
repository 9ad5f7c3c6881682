// Ball query: the first nsample in-radius points of each centroid.
//
// Replaces: genpose2_tpu/ops/ball_query_pallas.py:ball_query_pallas
// (_bq_kernel), which ranks the hits of a VMEM tile of (centroid, point)
// distances with a triangular-matmul prefix sum and extracts one slot per
// masked sum.
//
// Semantics: out[b, m, s] is the index of the (s+1)-th point n, in ascending
// order, with |xyz[b, n] - new_xyz[b, m]|^2 < r2 (the distance summed in the
// JAX order, r2 = float32(radius * radius)); slots past the hit count repeat
// the first hit; a centroid with no hit gets 0 in every slot.
//
// What bounds it on this card: operations. At the training path's densest
// stage (64 objects, 512 centroids, 1024 points) it is 33.5 M distance tests
// against 1.2 MB of input and 4.2 MB of output; a centroid stops scanning
// once it has nsample hits.
//
// Design: one block per (object, tile of centroids), a warp per centroid;
// plan.cuh:ball_query_plan gives a block 8 warps (fewer where the grid would
// leave SMs idle): timed on the H100, small blocks balance the card best,
// and staging a cloud costs less than a scan. The block stages its
// object's cloud once, as it lies in memory (3 floats a point, by 16-byte
// copies): a lane's stride-3 reads of it are free of bank conflicts, 3 being
// odd. A warp scans a window of 32 x W points a step (W = 4,
// plan.cuh:kBallQueryWindow): sub-slot w holds points
// base + 32 w + lane, so each lane makes W independent distance tests (W-way
// ILP), with no bounds test in a window that lies inside N. One vote a window
// skips the windows without a hit (most of them at the wide stages); else a
// ballot per sub-slot, and a hit's rank is the count so far, plus the
// popcounts of the window's earlier sub-slots, plus the popcount of the lower
// lanes' bits: hits are written in ascending order with no second pass, and
// the early exit is tested once a window.
//
// Any N: the block stages the cloud in tiles of plan.tile points
// (plan.cuh:kBallQueryTile; one tile, the whole cloud, to 4,096 points),
// scanned in ascending order. A warp keeps its count and first hit from one
// tile to the next, so hits stay in index order; a warp that has its nsample
// hits waits at the tile barriers and tests nothing more, and the block
// stops staging once every warp has them. A tile holds whole windows, so no
// window straddles two tiles.
#include <stdint.h>

#include "common.cuh"
#include "plan.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int W = kBallQueryWindow;

// Points [t0, t0 + n) of the object's cloud into shared memory as they lie
// in device memory (3 floats a point).
__device__ __forceinline__ void stage_tile(const float* p, int t0, int n, float* pts) {
  const float* src = p + 3 * static_cast<size_t>(t0);
  const int n3 = 3 * n;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* p4 = reinterpret_cast<const float4*>(src);
    float4* s4 = reinterpret_cast<float4*>(pts);
    for (int i = threadIdx.x; i < n3 / 4; i += blockDim.x) s4[i] = p4[i];
    for (int i = n3 / 4 * 4 + threadIdx.x; i < n3; i += blockDim.x) pts[i] = src[i];
  } else {  // an object that starts off a 16-byte boundary (odd N)
    for (int i = threadIdx.x; i < n3; i += blockDim.x) pts[i] = src[i];
  }
}

// Bit w: staged point base + 32 w + lane is a hit. CHECK: the window passes
// the n staged points.
template <bool CHECK>
__device__ __forceinline__ unsigned window_hits(const float* pts, int base, int lane, int n,
                                                float cx, float cy, float cz, float r2) {
  unsigned bits = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int i = base + 32 * w + lane;
    if ((!CHECK || i < n) &&
        sq_dist(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], cx, cy, cz) < r2)
      bits |= 1u << w;
  }
  return bits;
}

__global__ void __launch_bounds__(256)
ball_query_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz, int N,
                  int M, float r2, int nsample, BallQueryPlan plan, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* pts = reinterpret_cast<float*>(smem + plan.off_xyz);
  const int b = blockIdx.y;
  const float* cloud = xyz + static_cast<size_t>(b) * N * 3;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = blockIdx.x * plan.warps + warp;
  const bool active = m < M;  // the grid's last block may hold idle warps
  const unsigned lower = (1u << lane) - 1u;
  const float* c = new_xyz + (static_cast<size_t>(b) * M + (active ? m : 0)) * 3;
  const float cx = c[0], cy = c[1], cz = c[2];
  int* o = out + (static_cast<size_t>(b) * M + m) * nsample;
  int cnt = 0, first = -1;  // the same in every lane
  for (int t0 = 0; t0 < N; t0 += plan.tile) {
    const int t1 = min(t0 + plan.tile, N);
    // past the first tile: every warp has scanned the previous one; stop
    // once none needs more
    if (t0 > 0 && !__syncthreads_or(active && cnt < nsample)) break;
    stage_tile(cloud, t0, t1 - t0, pts);
    __syncthreads();
    if (!active) continue;
    const int n = t1 - t0;
    for (int base = t0; base < t1 && cnt < nsample; base += 32 * W) {
      const unsigned bits = base + 32 * W <= t1
                                ? window_hits<false>(pts, base - t0, lane, n, cx, cy, cz, r2)
                                : window_hits<true>(pts, base - t0, lane, n, cx, cy, cz, r2);
      if (!__any_sync(kFull, bits != 0u)) continue;  // most windows hold no hit
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const unsigned mask = __ballot_sync(kFull, (bits >> w) & 1u);
        if (mask == 0u) continue;
        const int rank = cnt + __popc(mask & lower);
        if (((bits >> w) & 1u) && rank < nsample) o[rank] = base + 32 * w + lane;
        if (first < 0) first = base + 32 * w + __ffs(mask) - 1;
        cnt += __popc(mask);
      }
    }
  }
  if (!active) return;
  if (first < 0) first = 0;
  for (int s = min(cnt, nsample) + lane; s < nsample; s += 32) o[s] = first;
}

cudaError_t launch_plan(const float* xyz, const float* new_xyz, int B, int N, int M, float r2,
                        int nsample, const BallQueryPlan& plan, int* out, void* stream) {
  if (plan.warps < 1 || plan.warps > 8 || plan.smem_bytes > kSmemLimit)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(ball_query_kernel, plan.smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + plan.warps - 1) / plan.warps, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ball_query_kernel<<<grid, plan.warps * 32, plan.smem_bytes, s>>>(xyz, new_xyz, N, M, r2,
                                                                   nsample, plan, out);
  return cudaGetLastError();
}

}  // namespace

// xyz (B, N, 3), new_xyz (B, M, 3) f32 -> out (B, M, nsample) i32, on
// `stream`, with the plan of plan.cuh:ball_query_plan. Returns a CUDA error
// code.
extern "C" int gp2_ball_query(const float* xyz, const float* new_xyz, int B, int N, int M,
                              float r2, int nsample, int* out, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  BallQueryPlan plan;
  if (ball_query_plan(B, N, M, nsample, sms, &plan) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_plan(xyz, new_xyz, B, N, M, r2, nsample, plan, out, stream));
}
