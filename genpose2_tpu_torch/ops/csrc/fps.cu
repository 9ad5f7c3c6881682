// Furthest point sampling.
//
// Replaces: genpose2_tpu/ops/fps.py:fps_pallas (_fps_kernel), which keeps the
// coordinates and the running min distance in VMEM for all picks.
//
// Semantics: pick 0 is index 0; pick j is the argmax of the running min
// squared distance to the picks so far, ties to the lowest index.
//
// What bounds it on this card: latency, not bytes or operations. The npoint-1
// picks form one dependent chain; each is N distance updates followed by a
// block-wide argmax (warp shuffles, then shared memory) and two barriers.
// At the main path's shape (64 objects, 1024 points -> 512) the whole input is
// 0.8 MB and the arithmetic ~0.3 GFLOP, so both roofline bounds are a few
// microseconds while the chain is 511 rounds of barrier latency.
//
// Design: one block per object, everything in shared memory (16 bytes a
// point); each thread owns a strided subset of points. Objects run in
// parallel on separate SMs.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ void take_better(float& bv, int& bi, float v, int i) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, int N, int npoint, int* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* ys = xs + N;
  float* zs = ys + N;
  float* temp = zs + N;
  __shared__ float red_v[kThreads / 32];
  __shared__ int red_i[kThreads / 32];
  __shared__ int pick;

  const int b = blockIdx.x;
  const float* p = xyz + static_cast<size_t>(b) * N * 3;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    xs[i] = p[3 * i + 0];
    ys[i] = p[3 * i + 1];
    zs[i] = p[3 * i + 2];
    temp[i] = 1e10f;
  }
  int* o = out + static_cast<size_t>(b) * npoint;
  if (threadIdx.x == 0) o[0] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  int old = 0;
  for (int j = 1; j < npoint; ++j) {
    const float x1 = xs[old], y1 = ys[old], z1 = zs[old];
    float bv = -1.f;  // every running distance is >= 0
    int bi = N;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      const float t = fminf(temp[i], sq_dist(xs[i], ys[i], zs[i], x1, y1, z1));
      temp[i] = t;
      take_better(bv, bi, t, i);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float v = __shfl_down_sync(0xffffffffu, bv, off);
      const int i = __shfl_down_sync(0xffffffffu, bi, off);
      take_better(bv, bi, v, i);
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? red_v[lane] : -1.f;
      bi = lane < nwarps ? red_i[lane] : N;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float v = __shfl_down_sync(0xffffffffu, bv, off);
        const int i = __shfl_down_sync(0xffffffffu, bi, off);
        take_better(bv, bi, v, i);
      }
      if (lane == 0) {
        pick = bi;
        o[j] = bi;
      }
    }
    __syncthreads();
    old = pick;
  }
}

}  // namespace

// xyz (B, N, 3) f32 -> out (B, npoint) i32, on `stream`. Returns a CUDA error code.
extern "C" int gp2_fps(const float* xyz, int B, int N, int npoint, int* out, void* stream) {
  const size_t smem = static_cast<size_t>(4) * N * sizeof(float);
  cudaError_t err = allow_smem(fps_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fps_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(xyz, N, npoint, out);
  return static_cast<int>(cudaGetLastError());
}
