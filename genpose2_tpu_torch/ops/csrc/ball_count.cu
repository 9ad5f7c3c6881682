// In-radius point count per centroid.
//
// Replaces: genpose2_tpu/ops/ball_query_pallas.py:ball_count
// (_ball_count_kernel), a VMEM tile of (centroid, point) distances summed
// over the point axis.
//
// Semantics: out[b, m] = #{n : |xyz[b, n] - new_xyz[b, m]|^2 < r2}, with the
// distance summed in the JAX order and r2 = float32(radius * radius).
//
// What bounds it on this card: operations. At the main path's shape
// (64 objects, 512 centroids, 1024 points) it is 33.5 M distance tests,
// ~0.3 GFLOP of f32 work, against 0.9 MB of input.
//
// Design: one thread per (object, centroid); the block stages its object's
// points in shared memory and every thread walks them in order (the reads are
// broadcasts).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ball_count_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
                  int N, int M, float r2, int* __restrict__ out) {
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
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const float* c = new_xyz + (static_cast<size_t>(b) * M + m) * 3;
  const float cx = c[0], cy = c[1], cz = c[2];
  int cnt = 0;
  for (int i = 0; i < N; ++i) cnt += sq_dist(xs[i], ys[i], zs[i], cx, cy, cz) < r2;
  out[static_cast<size_t>(b) * M + m] = cnt;
}

}  // namespace

// xyz (B, N, 3), new_xyz (B, M, 3) f32 -> out (B, M) i32. Returns a CUDA error code.
extern "C" int gp2_ball_count(const float* xyz, const float* new_xyz, int B, int N, int M,
                              float r2, int* out, void* stream) {
  const size_t smem = static_cast<size_t>(3) * N * sizeof(float);
  cudaError_t err = allow_smem(ball_count_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + kThreads - 1) / kThreads, B);
  ball_count_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xyz, new_xyz, N, M, r2, out);
  return static_cast<int>(cudaGetLastError());
}
