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
// block-wide argmax. At the main path's shape (64 objects, 1024 points -> 512)
// the whole input is 0.8 MB and the arithmetic ~0.3 GFLOP, so both roofline
// bounds are a few microseconds while the chain is 511 rounds of reduction
// and barrier latency.
//
// Design: one block per object (ops/csrc/plan.cuh:fps_plan picks its warps
// and the P points a thread owns). A thread keeps its P consecutive points
// and their running distances in registers; the cloud stays in shared memory
// only so that every thread can read the picked point (a broadcast load).
// A pick: P distance updates with P-way ILP, a tree argmax over the thread's
// points, then the warp's argmax in two redux.sync: the max of the values'
// bits (distances are >= 0, so their IEEE bits order as ints; pad slots hold
// -1.0f, whose bits order below every distance), then the min index over the
// lanes that hold it. One warp a block needs no barrier. With more, each warp
// writes its (value, index) into a slot of the pick's parity, one barrier,
// and every warp reduces the partials itself; the parity keeps the next
// pick's writes off the slots that slower warps may still be reading.
//
// Past kFpsMaxSlots (8,192) points the registers of one SM cannot hold the
// cloud: the wide route (plan.wide) gives an object 1,024 threads, thread t
// owning the points t, t + 1024, ... (coalesced reads). Its running
// distances live in a global scratch of N floats an object that the wrapper
// allocates (L2 holds them), and the coordinates are read from device memory
// at every pick (L1 holds a 16,384-point cloud, L2 any). The argmax is the
// one above, with 32 warps.
#include <limits.h>

#include "common.cuh"
#include "plan.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// (v, i) -> the warp's largest v, and the lowest i among the lanes that hold it.
__device__ __forceinline__ void warp_argmax(int& v, unsigned& i) {
  const int m = __reduce_max_sync(kFull, v);
  i = __reduce_min_sync(kFull, v == m ? i : 0xffffffffu);
  v = m;
}

template <int WARPS, int P>
__global__ void __launch_bounds__(WARPS * 32)
fps_kernel(const float* __restrict__ xyz, int N, int npoint, FpsPlan plan,
           int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem + plan.off_x);
  float* ys = reinterpret_cast<float*>(smem + plan.off_y);
  float* zs = reinterpret_cast<float*>(smem + plan.off_z);
  int* part_v = reinterpret_cast<int*>(smem + plan.off_val);
  unsigned* part_i = reinterpret_cast<unsigned*>(smem + plan.off_idx);

  const int b = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float* p = xyz + static_cast<size_t>(b) * N * 3;
  const int n0 = t * P;  // this thread's points: n0 .. n0 + P - 1
  float x[P], y[P], z[P], d[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = n0 + k;
    if (i < N) {
      x[k] = p[3 * i];
      y[k] = p[3 * i + 1];
      z[k] = p[3 * i + 2];
      d[k] = 1e10f;
      xs[i] = x[k];
      ys[i] = y[k];
      zs[i] = z[k];
    } else {  // a pad slot: never picked
      x[k] = y[k] = z[k] = 0.f;
      d[k] = -1.f;
    }
  }
  int* o = out + static_cast<size_t>(b) * npoint;
  if (t == 0) o[0] = 0;
  __syncthreads();

  unsigned old = 0;
  for (int j = 1; j < npoint; ++j) {
    const float cx = xs[old], cy = ys[old], cz = zs[old];
#pragma unroll
    for (int k = 0; k < P; ++k) d[k] = fminf(d[k], sq_dist(x[k], y[k], z[k], cx, cy, cz));
    // the thread's argmax: a tree over its points, lower indices on the left,
    // so that a strict > keeps the lowest index of a tie
    float v[P];
    int ki[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      v[k] = d[k];
      ki[k] = k;
    }
#pragma unroll
    for (int s = 1; s < P; s *= 2) {
#pragma unroll
      for (int k = 0; k < P; k += 2 * s) {
        if (v[k + s] > v[k]) {
          v[k] = v[k + s];
          ki[k] = ki[k + s];
        }
      }
    }
    int bv = __float_as_int(v[0]);
    unsigned bi = static_cast<unsigned>(n0 + ki[0]);
    warp_argmax(bv, bi);
    if (WARPS > 1) {
      int* slot = part_v + (j & 1) * WARPS;
      unsigned* islot = part_i + (j & 1) * WARPS;
      if (lane == 0) {
        slot[warp] = bv;
        islot[warp] = bi;
      }
      __syncthreads();
      bv = lane < WARPS ? slot[lane] : INT_MIN;
      bi = lane < WARPS ? islot[lane] : 0xffffffffu;
      warp_argmax(bv, bi);
    }
    old = bi;
    if (t == 0) o[j] = static_cast<int>(bi);
  }
}

// Block (object), kFpsWideWarps warps: thread t owns points t + 1024 k and
// their running distances in scratch (B x N).
__global__ void __launch_bounds__(kFpsWideWarps * 32)
fps_wide_kernel(const float* __restrict__ xyz, int N, int npoint, FpsPlan plan,
                float* __restrict__ scratch, int* __restrict__ out) {
  constexpr int kThreads = kFpsWideWarps * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  int* part_v = reinterpret_cast<int*>(smem + plan.off_val);
  unsigned* part_i = reinterpret_cast<unsigned*>(smem + plan.off_idx);

  const int b = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float* p = xyz + static_cast<size_t>(b) * N * 3;
  float* dist = scratch + static_cast<size_t>(b) * N;
  for (int i = t; i < N; i += kThreads) dist[i] = 1e10f;  // this thread's own slots
  int* o = out + static_cast<size_t>(b) * npoint;
  if (t == 0) o[0] = 0;

  unsigned old = 0;
  for (int j = 1; j < npoint; ++j) {
    const float cx = __ldg(p + 3 * old), cy = __ldg(p + 3 * old + 1), cz = __ldg(p + 3 * old + 2);
    // the thread's argmax over its points in ascending order: a strict >
    // keeps the lowest index of a tie; a thread without points (-1) never wins
    float bv = -1.f;
    unsigned bi = 0xffffffffu;
    for (int i = t; i < N; i += kThreads) {
      const float v = fminf(dist[i], sq_dist(__ldg(p + 3 * i), __ldg(p + 3 * i + 1),
                                             __ldg(p + 3 * i + 2), cx, cy, cz));
      dist[i] = v;
      if (v > bv) {
        bv = v;
        bi = static_cast<unsigned>(i);
      }
    }
    int v = __float_as_int(bv);
    warp_argmax(v, bi);
    int* slot = part_v + (j & 1) * kFpsWideWarps;
    unsigned* islot = part_i + (j & 1) * kFpsWideWarps;
    if (lane == 0) {
      slot[warp] = v;
      islot[warp] = bi;
    }
    __syncthreads();
    v = slot[lane];  // 32 warps: one partial a lane
    bi = islot[lane];
    warp_argmax(v, bi);
    old = bi;
    if (t == 0) o[j] = static_cast<int>(bi);
  }
}

template <int WARPS, int P>
cudaError_t launch(const float* xyz, int B, int N, int npoint, const FpsPlan& plan, int* out,
                   cudaStream_t stream) {
  cudaError_t err = allow_smem(fps_kernel<WARPS, P>, plan.smem_bytes);
  if (err != cudaSuccess) return err;
  fps_kernel<WARPS, P><<<B, WARPS * 32, plan.smem_bytes, stream>>>(xyz, N, npoint, plan, out);
  return cudaGetLastError();
}

template <int WARPS>
cudaError_t launch_p(const float* xyz, int B, int N, int npoint, const FpsPlan& plan, int* out,
                     cudaStream_t stream) {
  switch (plan.p) {
    case 4: return launch<WARPS, 4>(xyz, B, N, npoint, plan, out, stream);
    case 8: return launch<WARPS, 8>(xyz, B, N, npoint, plan, out, stream);
    case 16: return launch<WARPS, 16>(xyz, B, N, npoint, plan, out, stream);
    case 32:
      if constexpr (WARPS * 32 * 32 <= kFpsMaxSlots)
        return launch<WARPS, 32>(xyz, B, N, npoint, plan, out, stream);
  }
  return cudaErrorInvalidValue;
}

cudaError_t launch_plan(const float* xyz, int B, int N, int npoint, const FpsPlan& plan,
                        float* scratch, int* out, void* stream) {
  if (B < 1 || npoint < 1 || npoint > N || plan.smem_bytes > kSmemLimit)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plan.wide) {
    if (scratch == nullptr) return cudaErrorInvalidValue;
    fps_wide_kernel<<<B, kFpsWideWarps * 32, plan.smem_bytes, s>>>(xyz, N, npoint, plan,
                                                                   scratch, out);
    return cudaGetLastError();
  }
  if (plan.warps * 32 * plan.p < N) return cudaErrorInvalidValue;
  switch (plan.warps) {
    case 1: return launch_p<1>(xyz, B, N, npoint, plan, out, s);
    case 2: return launch_p<2>(xyz, B, N, npoint, plan, out, s);
    case 4: return launch_p<4>(xyz, B, N, npoint, plan, out, s);
    case 8: return launch_p<8>(xyz, B, N, npoint, plan, out, s);
    case 16: return launch_p<16>(xyz, B, N, npoint, plan, out, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// xyz (B, N, 3) f32 -> out (B, npoint) i32, on `stream`, with the plan of
// plan.cuh:fps_plan. scratch: B x N floats where N > kFpsMaxSlots (the wide
// route's running distances), else unused (may be null). Returns a CUDA
// error code.
extern "C" int gp2_fps(const float* xyz, int B, int N, int npoint, int* out, void* stream,
                       float* scratch) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  FpsPlan plan;
  if (fps_plan(N, B, sms, &plan) != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_plan(xyz, B, N, npoint, plan, scratch, out, stream));
}
