// Every MSG scale of one set-abstraction stage in one launch: ball query,
// grouping of the projected features, centering, folded-BN affine, the
// SharedMLP chain and the max over slots.
//
// Replaces: genpose2_tpu/ops/fused_sa.py:fused_sa_stage (_sa_stage_kernel).
//
// Semantics, per scale and centroid: the first `nsample` points with
// d2 < r2, in ascending index order; slots past the hit count repeat the
// first hit, and a centroid with no hit groups point 0 in every slot. Each
// slot's row g = proj[idx] runs h = relu((g - center) * a0 + c0), then
// h = relu((h W_l) * a_l + c_l) per layer, and the output is the max over
// slots. A repeated slot yields the same row as the slot it repeats, so the
// max needs only the min(count, nsample) real slots, or the one point-0 row
// when there is no hit: the kernel evaluates exactly those rows. This is the
// GPU form of the TPU kernel's dynamic slot-chunk skip, and it is exact.
//
// What bounds it on this card: operations. The MLP chain is ~98% of the
// work (~1.9e11 FLOP per encoder forward at the main path's shape with
// every slot real); this kernel runs it on the f32 pipes, not the tensor
// cores, so its floor is the 67 TFLOP/s f32 rate and it sits well above it.
// Tensor-core (mma/wgmma) tiles are later work.
//
// Design:
// - one block per (object, tile of kTC centroids), all scales in the block;
// - the object's points are staged in shared memory once and shared by all
//   scales (the TPU kernel's shared distance matrix);
// - hit lists: one warp per centroid scans the points in order, 32 at a
//   time; __ballot_sync + __popc give each hit its rank, the first nsample
//   are kept, and the scan stops once every scale is full;
// - the real rows of the tile are processed kRC at a time: layer 0 gathers
//   and centers into a k-major shared buffer, each later layer is a
//   column-per-thread product whose weights stream from L2 (the stage-3
//   weights, 256x384 + 384x512 per scale, do not fit in shared memory, so
//   the TPU's all-resident design does not carry over), and the last layer
//   max-reduces straight into a per-centroid accumulator in shared memory.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTC = 16;  // centroids per block
constexpr int kRC = 32;  // rows per chunk
constexpr int kMaxScales = 4;
constexpr int kMaxLayers = 4;

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
  int n_scales;
  int B, N, M, C_total;
  int idx_stride;  // sum of nsample over scales
  int max_width;   // widest row of any layer (a multiple of 4)
  int max_cout;    // widest scale output
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
sa_stage_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
                float* __restrict__ out, const Params P) {
  extern __shared__ __align__(16) float smem[];
  const int N = P.N, M = P.M;
  const int b = blockIdx.y, m0 = blockIdx.x * kTC;
  float* bufA = smem;                       // k-major (max_width, kRC)
  float* bufB = bufA + P.max_width * kRC;   // k-major (max_width, kRC)
  float* acc = bufB + P.max_width * kRC;    // (kTC, max_cout) pooled outputs
  float* xs = acc + kTC * P.max_cout;
  float* ys = xs + N;
  float* zs = ys + N;
  int* idx = reinterpret_cast<int*>(zs + N);  // (kTC, idx_stride)
  int* nrow = idx + kTC * P.idx_stride;        // (kTC, kMaxScales) rows per centroid
  __shared__ int rstart[kTC + 1];
  __shared__ int row_c[kRC];
  __shared__ int row_p[kRC];

  const float* pts = xyz + static_cast<size_t>(b) * N * 3;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    xs[i] = pts[3 * i + 0];
    ys[i] = pts[3 * i + 1];
    zs[i] = pts[3 * i + 2];
  }
  __syncthreads();

  // hit lists, all scales from one distance per (centroid, point)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  for (int c = warp; c < kTC; c += nwarps) {
    const int m = m0 + c;
    int* hits = idx + c * P.idx_stride;
    if (m >= M) {
      if (lane < kMaxScales) nrow[c * kMaxScales + lane] = 0;
      continue;
    }
    const float* q = new_xyz + (static_cast<size_t>(b) * M + m) * 3;
    const float cx = q[0], cy = q[1], cz = q[2];
    int cnt[kMaxScales] = {0, 0, 0, 0};
    for (int p0 = 0; p0 < N; p0 += 32) {
      const int p = p0 + lane;
      const float d2 = p < N ? sq_dist(xs[p], ys[p], zs[p], cx, cy, cz) : 0.f;
      bool full = true;
#pragma unroll
      for (int s = 0; s < kMaxScales; ++s) {
        if (s < P.n_scales) {
          const bool hit = p < N && d2 < P.s[s].r2;
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
        nrow[c * kMaxScales + s] = n;
      }
    }
  }
  __syncthreads();

  for (int s = 0; s < P.n_scales; ++s) {
    const Scale& S = P.s[s];
    const T* proj = static_cast<const T*>(S.proj);
    const int h1 = S.width[0];
    const int cout = S.width[S.num_layers];
    if (threadIdx.x == 0) {
      int t = 0;
      for (int c = 0; c < kTC; ++c) {
        rstart[c] = t;
        t += nrow[c * kMaxScales + s];
      }
      rstart[kTC] = t;
    }
    for (int e = threadIdx.x; e < kTC * cout; e += blockDim.x) acc[e] = 0.f;  // rows are >= 0
    __syncthreads();
    const int total = rstart[kTC];

    for (int r0 = 0; r0 < total; r0 += kRC) {
      if (threadIdx.x < kRC) {
        const int r = r0 + threadIdx.x;
        int c = -1, p = 0;
        if (r < total) {
          c = 0;
          while (rstart[c + 1] <= r) ++c;
          p = idx[c * P.idx_stride + S.idx_off + (r - rstart[c])];
        }
        row_c[threadIdx.x] = c;
        row_p[threadIdx.x] = p;
      }
      __syncthreads();

      // layer 0: gather the projected row, center, folded BN, relu
      if (S.num_layers > 0) {
        for (int e = threadIdx.x; e < h1 * kRC; e += blockDim.x) {
          const int j = e / kRC, rr = e % kRC;
          const int c = row_c[rr];
          float v = 0.f;
          if (c >= 0) {
            const float g = to_f32(proj[(static_cast<size_t>(b) * N + row_p[rr]) * h1 + j]);
            const float ctr = S.center[(static_cast<size_t>(b) * M + m0 + c) * h1 + j];
            v = fmaxf((g - ctr) * S.a0[j] + S.c0[j], 0.f);
          }
          bufA[e] = as_operand<T>(v);
        }
      } else {  // no MLP layer: pool the projection itself
        for (int j = threadIdx.x; j < h1; j += blockDim.x) {
          for (int rr = 0; rr < kRC; ++rr) {
            const int c = row_c[rr];
            if (c < 0) continue;
            const float g = to_f32(proj[(static_cast<size_t>(b) * N + row_p[rr]) * h1 + j]);
            const float ctr = S.center[(static_cast<size_t>(b) * M + m0 + c) * h1 + j];
            const float v = fmaxf((g - ctr) * S.a0[j] + S.c0[j], 0.f);
            acc[c * cout + j] = fmaxf(acc[c * cout + j], v);
          }
        }
      }
      __syncthreads();

      float* hin = bufA;
      float* hout = bufB;
      for (int l = 0; l < S.num_layers; ++l) {
        const int K = S.width[l], C = S.width[l + 1];
        const bool last = l == S.num_layers - 1;
        const T* W = static_cast<const T*>(S.W[l]);
        const float* al = S.a[l];
        const float* cl = S.c[l];
        for (int o = threadIdx.x; o < C; o += blockDim.x) {
          float z[kRC];
          dot_rows<kRC, T>(hin, K, W, C, o, z);
          const float ao = al[o], co = cl[o];
          if (last) {  // rows are grouped by centroid: running max per centroid
#pragma unroll
            for (int rr = 0; rr < kRC; ++rr) {
              const int c = row_c[rr];
              if (c >= 0) {
                const float v = fmaxf(z[rr] * ao + co, 0.f);
                acc[c * cout + o] = fmaxf(acc[c * cout + o], v);
              }
            }
          } else {
#pragma unroll
            for (int rr = 0; rr < kRC; ++rr)
              hout[o * kRC + rr] = as_operand<T>(fmaxf(z[rr] * ao + co, 0.f));
          }
        }
        __syncthreads();
        float* t = hin;
        hin = hout;
        hout = t;
      }
    }

    for (int e = threadIdx.x; e < kTC * cout; e += blockDim.x) {
      const int c = e / cout, o = e % cout;
      if (m0 + c < M)
        out[(static_cast<size_t>(b) * M + m0 + c) * P.C_total + S.out_off + o] = acc[e];
    }
    __syncthreads();
  }
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
  if (n_scales < 1 || n_scales > kMaxScales) return -1;
  Params P = {};
  P.n_scales = n_scales;
  P.B = B;
  P.N = N;
  P.M = M;
  P.C_total = C_total;
  int idx_off = 0, out_off = 0, max_width = 4, max_cout = 1;
  for (int s = 0; s < n_scales; ++s) {
    Scale& S = P.s[s];
    const void* const* p = ptrs + s * (4 + 3 * kMaxLayers);
    if (num_layers[s] < 0 || num_layers[s] > kMaxLayers) return -1;
    S.proj = p[0];
    S.center = static_cast<const float*>(p[1]);
    S.a0 = static_cast<const float*>(p[2]);
    S.c0 = static_cast<const float*>(p[3]);
    S.num_layers = num_layers[s];
    for (int l = 0; l <= S.num_layers; ++l) {
      S.width[l] = widths[s * (kMaxLayers + 1) + l];
      max_width = max(max_width, (S.width[l] + 3) / 4 * 4);
    }
    for (int l = 0; l < S.num_layers; ++l) {
      S.W[l] = p[4 + 3 * l];
      S.a[l] = static_cast<const float*>(p[5 + 3 * l]);
      S.c[l] = static_cast<const float*>(p[6 + 3 * l]);
    }
    S.nsample = nsample[s];
    S.r2 = r2[s];
    S.idx_off = idx_off;
    S.out_off = out_off;
    idx_off += S.nsample;
    out_off += S.width[S.num_layers];
    max_cout = max(max_cout, S.width[S.num_layers]);
  }
  if (out_off != C_total) return -1;
  P.idx_stride = idx_off;
  P.max_width = max_width;
  P.max_cout = max_cout;
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(max_width) * kRC +
                                       static_cast<size_t>(kTC) * max_cout + 3 * static_cast<size_t>(N)) +
                      sizeof(int) * (static_cast<size_t>(kTC) * (idx_off + kMaxScales));
  const dim3 grid((M + kTC - 1) / kTC, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    err = allow_smem(sa_stage_kernel<__nv_bfloat16>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sa_stage_kernel<__nv_bfloat16><<<grid, kThreads, smem, st>>>(xyz, new_xyz, out, P);
  } else {
    err = allow_smem(sa_stage_kernel<float>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sa_stage_kernel<float><<<grid, kThreads, smem, st>>>(xyz, new_xyz, out, P);
  }
  return static_cast<int>(cudaGetLastError());
}
