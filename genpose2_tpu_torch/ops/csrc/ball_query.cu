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
// Design: one block per (object, tile of kTile centroids); the block stages
// its object's points in shared memory (12 bytes a point). One warp per
// centroid scans the points 32 at a time: a ballot of the lanes' hits, and
// the popcount of the lower lanes' bits gives each hit its rank, so hits are
// written in ascending order with no second pass.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kTile = 32;  // centroids per block, kTile / kWarps per warp

__global__ void __launch_bounds__(kWarps * 32)
ball_query_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz, int N,
                  int M, float r2, int nsample, int* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* ys = xs + N;
  float* zs = ys + N;
  const int b = blockIdx.y;
  const float* p = xyz + static_cast<size_t>(b) * N * 3;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    xs[i] = p[3 * i + 0];
    ys[i] = p[3 * i + 1];
    zs[i] = p[3 * i + 2];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  for (int t = warp; t < kTile; t += kWarps) {
    const int m = blockIdx.x * kTile + t;
    if (m >= M) break;  // uniform across the warp
    const float* c = new_xyz + (static_cast<size_t>(b) * M + m) * 3;
    const float cx = c[0], cy = c[1], cz = c[2];
    int* o = out + (static_cast<size_t>(b) * M + m) * nsample;
    int cnt = 0, first = 0;  // the same in every lane
    for (int base = 0; base < N && cnt < nsample; base += 32) {
      const int i = base + lane;
      const bool hit = i < N && sq_dist(xs[i], ys[i], zs[i], cx, cy, cz) < r2;
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (mask == 0u) continue;
      if (cnt == 0) first = base + __ffs(mask) - 1;
      const int rank = cnt + __popc(mask & lower);
      if (hit && rank < nsample) o[rank] = i;
      cnt += __popc(mask);
    }
    for (int s = min(cnt, nsample) + lane; s < nsample; s += 32) o[s] = first;
  }
}

}  // namespace

// xyz (B, N, 3), new_xyz (B, M, 3) f32 -> out (B, M, nsample) i32, on
// `stream`. Returns a CUDA error code.
extern "C" int gp2_ball_query(const float* xyz, const float* new_xyz, int B, int N, int M,
                              float r2, int nsample, int* out, void* stream) {
  const size_t smem = static_cast<size_t>(3) * N * sizeof(float);
  cudaError_t err = allow_smem(ball_query_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + kTile - 1) / kTile, B);
  ball_query_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      xyz, new_xyz, N, M, r2, nsample, out);
  return static_cast<int>(cudaGetLastError());
}
