// Attention with a relative-position bias built from the points' coordinates.
//
// Replaces: genpose2_tpu/ops/relpe_attention.py:relpe_attention (_kernel), which
// builds the bias tile of a (batch row, query tile) on the fly from xyz and
// never writes a (B, H, M, M) tensor.
//
// Semantics, per object, query i, key j and head h:
//   rel = xyz_j - xyz_i, dist = |rel|, u = rel / (dist + 1e-7) (as rel * inv)
//   hd_c = relu(dist * w1d_c + b1d_c), hr_c = relu(u . w1r_c + b1r_c), c < 16
//   bias_h = bc_h + sum_c (hd_c * wfd[c][h] + hr_c * wfr[c][h])
//   s = (q_h . k_h) * scale + bias_h, scale = 1/sqrt(D); p = softmax_j(s) in
//   float32, rounded to v's type; out_h = p v_h in float32.
// wfd = W2d @ Wf[:H], wfr = W2r @ Wf[H:], bc = b2d @ Wf[:H] + b2r @ Wf[H:] + bf
// are folded on the host (ops/relpe_attention.py:fold_pe): the bias is linear
// in the two second layers and the fusion layer.
//
// What bounds it on this card: operations on the float32 pipes. At the Fus
// encoder's stage 0 (64 objects, M = 512, C = 96, H = 8, D = 12) the bias is
// 16.8 M pairs x ~400 operations (16 hidden channels, each mixed into 8
// heads), against 38 MB of q/k/v/out; the products add C = 96 multiply-adds
// a pair each, small on the tensor cores. The later stages have fewer pairs
// and wider heads.
//
// Design (flash-style over key chunks):
// - A block owns one object, one tile of tq query rows and a group of
//   `heads` heads (ops/csrc/plan.cuh:relpe_plan picks them; 8 heads and 16
//   rows where the K and V chunks fit, fewer heads for wide ones or to fill
//   the card at small batch). It walks the keys in chunks of 32: K, V and
//   the keys' xyz of the next chunk are copied by cp.async into the other of
//   two buffers while the block works on this one. Each object's K and V are
//   read M / tq times, not once per 8 queries as before.
// - All threads build the chunk's bias [heads][tq][32] in float32 in shared
//   memory on the FMA pipes, a thread two keys of one query: the 16 hidden
//   channels of a pair are computed once for all 8 heads (a block of fewer
//   heads computes all 8 and keeps its own: only the wide later stages split
//   the heads, and they hold few pairs).
// - Each warp owns one (head, 16 query rows) task and keeps a float32 online
//   softmax (running max and sum per row) and its 16 x D output in
//   registers. bf16 runs both products on the tensor cores (mma.cuh):
//   mma.sync.m16n8k16 with float32 sums (a bf16 x bf16 product is exact in
//   float32), q from registers, K by ldmatrix, V by ldmatrix.trans and p
//   from the score fragments as the A operand.
// - float32: both products by 3xTF32 on m16n8k8: each operand split into a
//   TF32 high part and remainder, three mmas (lo*hi, hi*lo, hi*hi), about
//   21 bits of each product; TF32 alone misses float32's bounds by two
//   orders of magnitude. In q . k the scores reach a few hundred when q and
//   k do (magnitude 8): there both parts are rounded (cvt.rna) and each
//   8-deep step's three mmas sum from zero before a float32 add into the
//   score, which keeps the output as close to a float64 evaluation as the
//   plain float32 version (about 5e-5; chaining every step in one
//   accumulator with truncated remainders doubled that; PERF.md §6). In
//   p . V (p <= 1) the remainders are truncated and the mmas chained, and
//   the key order of an 8-key step is permuted (keys 2t, 2t+1 are the
//   operand's k = t, t+4) so that p comes from the score fragment without a
//   shuffle.
// - The head width D is zero-padded to the mma depth (16, 32, 64 or 128) in
//   shared memory and in the q fragments; key rows past M are zero and their
//   scores -inf; query rows past M are computed and not stored.
// - The reference normalises p before it rounds it to v's type; here the
//   unnormalised p is rounded (bf16) and the row sum divides at the end: the
//   same relative rounding of each weight (2^-9), at another point. float32
//   rounds p nowhere.
#include "mma.cuh"

namespace {

using Bf16 = __nv_bfloat16;
constexpr int kKC = kRelpeChunk;
constexpr int kNT = kKC / 8;  // 8-key n-tiles of a chunk
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const float* xyz;
  const void* q;
  const void* k;
  const void* v;
  const float* pe;
  float* out;
  int M, C, D;
  float scale;
  int vec;  // copy width of a K or V row piece: 16, 8 or 4 bytes (cp.async), 2 (plain loads)
};

// ------------------------------------------------------------------ staging

// The folded constants (ops/relpe_attention.py:fold_pe: w1d[16] b1d[16]
// w1r[3][16] b1r[16] wfd[16][8] wfr[16][8] bc[8]) as one record of
// kRelpeRecord floats a hidden channel, {w1d, b1d, w1rx, w1ry}, {w1rz, b1r,
// 0, 0}, wfd[c][0..7], wfr[c][0..7] (float4 broadcasts), then bc[0..7].
__device__ __forceinline__ void stage_constants(const float* __restrict__ pe, float* cst) {
  constexpr int kHid = kRelpeHid, kH = kRelpeHeads;
  for (int e = threadIdx.x; e < kHid * kRelpeRecord + kH; e += blockDim.x) {
    const int c = e / kRelpeRecord, f = e - c * kRelpeRecord;
    float x = 0.f;
    if (c == kHid) x = pe[6 * kHid + 2 * kHid * kH + f];                // bc
    else if (f < 6) x = pe[f * kHid + c];  // w1d, b1d, w1r[0..2], b1r: pe's first 6 rows
    else if (f >= 8 && f < 16) x = pe[6 * kHid + c * kH + f - 8];       // wfd
    else if (f >= 16) x = pe[6 * kHid + kHid * kH + c * kH + f - 16];   // wfr
    cst[e] = x;
  }
}

// K and V rows of keys key0 .. key0 + kKC - 1 of the block's heads into one
// buffer ([head][key][ldkv] each), by cp.async of kBytes (or plain 2-byte
// loads); columns D.. are left alone (zero from the start), rows past M are
// zero-filled.
template <int kBytes, typename T>
__device__ __forceinline__ void stage_kv(T* dk, T* dv, const T* __restrict__ k,
                                         const T* __restrict__ v, size_t row0, int nvalid,
                                         int h0, int heads, int C, int D, int ldkv) {
  constexpr int kPer = kBytes / sizeof(T);
  const int vpr = D / kPer;  // pieces of a head row
  const int total = heads * kKC * vpr;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int hk = e / vpr, d = (e - hk * vpr) * kPer;  // hk = head * kKC + key
    const int hl = hk / kKC, j = hk - hl * kKC;
    T* sk = dk + hk * ldkv + d;
    T* sv = dv + hk * ldkv + d;
    if (j < nvalid) {
      const size_t g = (row0 + j) * C + (h0 + hl) * D + d;
      if constexpr (kBytes >= 4) {
        mma::cp_async<kBytes>(sk, k + g);
        mma::cp_async<kBytes>(sv, v + g);
      } else {
        *sk = k[g];
        *sv = v[g];
      }
    } else {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        sk[i] = from_f32<T>(0.f);
        sv[i] = from_f32<T>(0.f);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void stage_chunk(const Args& a, const RelpePlan& p, int chunk,
                                            size_t obj, int h0, T* dk, T* dv, float* dx) {
  const int key0 = chunk * kKC, nvalid = min(kKC, a.M - key0);
  for (int e = threadIdx.x; e < 3 * kKC; e += blockDim.x) {
    if (e < 3 * nvalid) mma::cp_async<4>(dx + e, a.xyz + (obj + key0) * 3 + e);
    else dx[e] = 0.f;
  }
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const size_t row0 = obj + key0;
  switch (a.vec) {
    case 16: stage_kv<16>(dk, dv, k, v, row0, nvalid, h0, p.heads, a.C, a.D, p.ldkv); break;
    case 8: stage_kv<8>(dk, dv, k, v, row0, nvalid, h0, p.heads, a.C, a.D, p.ldkv); break;
    case 4: stage_kv<4>(dk, dv, k, v, row0, nvalid, h0, p.heads, a.C, a.D, p.ldkv); break;
    default:
      if constexpr (sizeof(T) == 2) {
        stage_kv<2>(dk, dv, k, v, row0, nvalid, h0, p.heads, a.C, a.D, p.ldkv);
      }
  }
}

// --------------------------------------------------------------------- bias

// bias[hl][r][j] for the block's heads hl (head h0 + hl), its tq query rows
// and the chunk's 32 keys (row stride ldb), from the queries' and the keys'
// xyz (3 floats a point). A thread takes keys j, j + 1 of one query: each
// constant it reads from shared memory serves two pairs.
__device__ __forceinline__ void build_bias(const float* cst, const float* qxyz,
                                           const float* kxyz, float* bias, int tq, int ldb,
                                           int h0, int heads) {
  constexpr int kH = kRelpeHeads, kHalf = kKC / 2;
  const float4* rec = reinterpret_cast<const float4*>(cst);
  const float* bc = cst + kRelpeHid * kRelpeRecord;
  for (int e = threadIdx.x; e < tq * kHalf; e += blockDim.x) {
    const int r = e / kHalf, j = 2 * (e - r * kHalf);
    float dist[2], ux[2], uy[2], uz[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float rx = kxyz[3 * (j + i) + 0] - qxyz[3 * r + 0];  // rel = xyz_j - xyz_i
      const float ry = kxyz[3 * (j + i) + 1] - qxyz[3 * r + 1];
      const float rz = kxyz[3 * (j + i) + 2] - qxyz[3 * r + 2];
      dist[i] = sqrtf(rx * rx + ry * ry + rz * rz);
      const float inv = 1.f / (dist[i] + 1e-7f);
      ux[i] = rx * inv;
      uy[i] = ry * inv;
      uz[i] = rz * inv;
    }
    float acc[2][kH];
#pragma unroll
    for (int h = 0; h < kH; ++h) acc[0][h] = acc[1][h] = bc[h];
#pragma unroll
    for (int c = 0; c < kRelpeHid; ++c) {
      const float4 w0 = rec[6 * c + 0], w1 = rec[6 * c + 1];  // {w1d b1d w1rx w1ry} {w1rz b1r}
      const float4 fd[2] = {rec[6 * c + 2], rec[6 * c + 3]};
      const float4 fr[2] = {rec[6 * c + 4], rec[6 * c + 5]};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float hd = fmaxf(dist[i] * w0.x + w0.y, 0.f);
        const float hr = fmaxf(ux[i] * w0.z + uy[i] * w0.w + uz[i] * w1.x + w1.y, 0.f);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          acc[i][4 * q + 0] += hd * fd[q].x + hr * fr[q].x;
          acc[i][4 * q + 1] += hd * fd[q].y + hr * fr[q].y;
          acc[i][4 * q + 2] += hd * fd[q].z + hr * fr[q].z;
          acc[i][4 * q + 3] += hd * fd[q].w + hr * fr[q].w;
        }
      }
    }
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      const int hl = h - h0;
      if (hl >= 0 && hl < heads) {
        *reinterpret_cast<float2*>(bias + (hl * tq + r) * ldb + j) =
            make_float2(acc[0][h], acc[1][h]);
      }
    }
  }
}

// u = s * scale + bias for the warp's 16 rows (bias rows ldb apart), keys
// at or past M (from key0) -inf.
__device__ __forceinline__ void add_bias(float (&s)[kNT][4], const float* bh, int ldb,
                                         float scale, int key0, int M, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const float2 b0 = *reinterpret_cast<const float2*>(bh + g * ldb + nt * 8 + 2 * t);
    const float2 b1 = *reinterpret_cast<const float2*>(bh + (g + 8) * ldb + nt * 8 + 2 * t);
    s[nt][0] = fmaf(s[nt][0], scale, b0.x);
    s[nt][1] = fmaf(s[nt][1], scale, b0.y);
    s[nt][2] = fmaf(s[nt][2], scale, b1.x);
    s[nt][3] = fmaf(s[nt][3], scale, b1.y);
  }
  if (key0 + kKC <= M) return;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (key0 + nt * 8 + 2 * t + (e & 1) >= M) s[nt][e] = -INFINITY;
    }
  }
}

// ------------------------------------------------------------ the products

// A task's q rows as mma A operands (0 past the rows or the depth): bf16
// packed pairs, kDp / 16 k-steps; float32 the raw values, kDp / 8 k-steps,
// split at use.
template <typename T, int kDp>
struct QFrag;
template <int kDp>
struct QFrag<Bf16, kDp> {
  uint32_t a[kDp / 16][4];
};
template <int kDp>
struct QFrag<float, kDp> {
  float a[kDp / 8][4];
};

template <typename T>
__device__ __forceinline__ T q_at(const T* __restrict__ qh, int row, int d, int M, int C, int D) {
  return row < M && d < D ? qh[static_cast<size_t>(row) * C + d] : from_f32<T>(0.f);
}

template <int kDp>
__device__ __forceinline__ void load_q(QFrag<Bf16, kDp>& f, const Bf16* qh, int row0, int M,
                                       int C, int D, int lane) {
  const int g = lane >> 2, t = lane & 3;
  auto pair = [&](int row, int d) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(q_at(qh, row, d, M, C, D))) |
           static_cast<uint32_t>(__bfloat16_as_ushort(q_at(qh, row, d + 1, M, C, D))) << 16;
  };
#pragma unroll
  for (int ks = 0; ks < kDp / 16; ++ks) {
    const int d = ks * 16 + 2 * t;
    f.a[ks][0] = pair(row0 + g, d);
    f.a[ks][1] = pair(row0 + g + 8, d);
    f.a[ks][2] = pair(row0 + g, d + 8);
    f.a[ks][3] = pair(row0 + g + 8, d + 8);
  }
}

template <int kDp>
__device__ __forceinline__ void load_q(QFrag<float, kDp>& f, const float* qh, int row0, int M,
                                       int C, int D, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < kDp / 8; ++ks) {
    const int d = ks * 8 + t;
    f.a[ks][0] = q_at(qh, row0 + g, d, M, C, D);
    f.a[ks][1] = q_at(qh, row0 + g + 8, d, M, C, D);
    f.a[ks][2] = q_at(qh, row0 + g, d + 4, M, C, D);
    f.a[ks][3] = q_at(qh, row0 + g + 8, d + 4, M, C, D);
  }
}

// s = q . K^T for the chunk's 32 keys (sK: the head's rows, ldkv apart).
template <int kDp>
__device__ __forceinline__ void scores(const QFrag<Bf16, kDp>& f, const Bf16* sK, int ldkv,
                                       int lane, float (&s)[kNT][4]) {
  // ldmatrix x4: keys 0-7 at depth 0-7 and 8-15 (b0, b1 of n-tile 2np), then
  // keys 8-15 (n-tile 2np + 1)
  const int krow = (lane & 7) + 8 * (lane >> 4), kcol = 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int np = 0; np < kNT / 2; ++np) {
#pragma unroll
    for (int ks = 0; ks < kDp / 16; ++ks) {
      uint32_t b[4];
      mma::ldmatrix_x4(b, sK + (16 * np + krow) * ldkv + ks * 16 + kcol);
      mma::mma_bf16(s[2 * np], f.a[ks], b[0], b[1]);
      mma::mma_bf16(s[2 * np + 1], f.a[ks], b[2], b[3]);
    }
  }
}

// float32: each 8-deep step summed from zero by its three mmas, then added
// to the score in float32.
template <int kDp>
__device__ __forceinline__ void scores(const QFrag<float, kDp>& f, const float* sK, int ldkv,
                                       int lane, float (&s)[kNT][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < kDp / 8; ++ks) {
    uint32_t ah[4], al[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) mma::split_tf32_rn(f.a[ks][e], ah[e], al[e]);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const float* kr = sK + (nt * 8 + g) * ldkv + ks * 8 + t;
      uint32_t h0, l0, h1, l1;
      mma::split_tf32_rn(kr[0], h0, l0);
      mma::split_tf32_rn(kr[4], h1, l1);
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma::mma_tf32(d, al, h0, h1);
      mma::mma_tf32(d, ah, l0, l1);
      mma::mma_tf32(d, ah, h0, h1);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] += d[e];
    }
  }
}

// o += p . V for the chunk's 32 keys (sV: the head's rows, ldkv apart); p
// rounded to bf16 as the A operand.
template <int kDp>
__device__ __forceinline__ void pv(const float (&p)[kNT][4], const Bf16* sV, int ldkv, int lane,
                                   float (&o)[kDp / 8][4]) {
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lcol = 8 * (lane >> 4);
#pragma unroll
  for (int kk = 0; kk < kNT / 2; ++kk) {
    const uint32_t a[4] = {mma::pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           mma::pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           mma::pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           mma::pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int jp = 0; jp < kDp / 16; ++jp) {
      uint32_t b[4];
      mma::ldmatrix_x4_trans(b, sV + (16 * kk + lrow) * ldkv + 16 * jp + lcol);
      mma::mma_bf16(o[2 * jp], a, b[0], b[1]);
      mma::mma_bf16(o[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// float32: operand k = t <-> key 2t, k = t + 4 <-> key 2t + 1 of each 8-key
// step, so that a lane's own score values are its A operand.
template <int kDp>
__device__ __forceinline__ void pv(const float (&p)[kNT][4], const float* sV, int ldkv, int lane,
                                   float (&o)[kDp / 8][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    uint32_t ah[4], al[4];
    mma::split_tf32(p[nt][0], ah[0], al[0]);
    mma::split_tf32(p[nt][2], ah[1], al[1]);
    mma::split_tf32(p[nt][1], ah[2], al[2]);
    mma::split_tf32(p[nt][3], ah[3], al[3]);
    const float* v0 = sV + (nt * 8 + 2 * t) * ldkv + g;
#pragma unroll
    for (int dt = 0; dt < kDp / 8; ++dt) {
      uint32_t h0, l0, h1, l1;
      mma::split_tf32(v0[dt * 8], h0, l0);
      mma::split_tf32(v0[ldkv + dt * 8], h1, l1);
      mma::mma_tf32(o[dt], al, h0, h1);
      mma::mma_tf32(o[dt], ah, l0, l1);
      mma::mma_tf32(o[dt], ah, h0, h1);
    }
  }
}

// ------------------------------------------------------------------ kernel

// Blocks an SM that the registers must allow: three for bf16 at D <= 16,
// whose 72 KB plans leave shared memory for three (80 registers, a few bytes
// spilled: stage 0 measured 8% faster than at two), one at D = 128.
template <typename T, int kDp>
constexpr int kMinBlocks = kDp == 128 ? 1 : sizeof(T) == 2 && kDp == 16 ? 3 : 2;

template <typename T, int kDp>
__global__ void __launch_bounds__(256, kMinBlocks<T, kDp>)
relpe_kernel(const Args a, const RelpePlan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* cst = reinterpret_cast<float*>(smem + p.off_cst);
  float* qxyz = reinterpret_cast<float*>(smem + p.off_qxyz);
  float* kxyz = reinterpret_cast<float*>(smem + p.off_kxyz);
  float* bias = reinterpret_cast<float*>(smem + p.off_bias);
  T* sK = reinterpret_cast<T*>(smem + p.off_k);
  T* sV = reinterpret_cast<T*>(smem + p.off_v);
  const int M = a.M, C = a.C, D = a.D;
  const int i0 = blockIdx.x * p.tq, h0 = blockIdx.y * p.heads;
  const size_t obj = static_cast<size_t>(blockIdx.z) * M;
  const int buf_elems = p.heads * kKC * p.ldkv;  // one K (or V) buffer
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wph = p.warps / p.heads;  // warps of a head
  const int hl = warp / wph, row0 = i0 + 16 * (warp - hl * wph);
  const int nchunks = (M + kKC - 1) / kKC;

  stage_chunk<T>(a, p, 0, obj, h0, sK, sV, kxyz);
  mma::cp_async_commit();
  stage_constants(a.pe, cst);
  for (int e = threadIdx.x; e < 3 * p.tq; e += blockDim.x)
    qxyz[e] = e < 3 * (M - i0) ? a.xyz[(obj + i0) * 3 + e] : 0.f;
  if (D < kDp) {  // the padding columns of both buffers; the copies never write them
    const int pad = kDp - D;
    for (int e = threadIdx.x; e < p.nbuf * buf_elems / p.ldkv * pad; e += blockDim.x) {
      const int r = e / pad, i = r * p.ldkv + D + e - r * pad;
      sK[i] = from_f32<T>(0.f);
      sV[i] = from_f32<T>(0.f);
    }
  }
  QFrag<T, kDp> f;
  load_q(f, static_cast<const T*>(a.q) + obj * C + (h0 + hl) * D, row0, M, C, D, lane);

  float o[kDp / 8][4];
#pragma unroll
  for (int dt = 0; dt < kDp / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float* bh = bias + (hl * p.tq + row0 - i0) * p.ldb;

  for (int c = 0; c < nchunks; ++c) {
    const int buf = c & 1;
    mma::cp_async_wait(0);
    // chunk c has landed for every thread, and the block is done with
    // chunk c - 1: its bias and its buffer, which the next copy refills
    __syncthreads();
    if (c + 1 < nchunks)
      stage_chunk<T>(a, p, c + 1, obj, h0, sK + (buf ^ 1) * buf_elems,
                     sV + (buf ^ 1) * buf_elems, kxyz + (buf ^ 1) * 3 * kKC);
    mma::cp_async_commit();
    build_bias(cst, qxyz, kxyz + buf * 3 * kKC, bias, p.tq, p.ldb, h0, p.heads);
    __syncthreads();

    const T* hK = sK + buf * buf_elems + hl * kKC * p.ldkv;
    const T* hV = sV + buf * buf_elems + hl * kKC * p.ldkv;
    float s[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    scores<kDp>(f, hK, p.ldkv, lane, s);
    add_bias(s, bh, p.ldb, a.scale, c * kKC, M, lane);
    float alpha[2];
    mma::softmax_chunk(s, m, l, kLog2e, alpha);
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) mma::scale_rows(o, alpha);
    pv<kDp>(s, hV, p.ldkv, lane, o);
  }

  const float inv[2] = {1.f / mma::quad_sum(l[0]), 1.f / mma::quad_sum(l[1])};
  mma::scale_rows(o, inv);
  const int g = lane >> 2, t = lane & 3;
  float* out = a.out + obj * C + (h0 + hl) * D;
#pragma unroll
  for (int dt = 0; dt < kDp / 8; ++dt) {
    const int d = dt * 8 + 2 * t;  // D is even: d < D means d + 1 < D
    if (d >= D) continue;
    if (row0 + g < M)
      *reinterpret_cast<float2*>(out + static_cast<size_t>(row0 + g) * C + d) =
          make_float2(o[dt][0], o[dt][1]);
    if (row0 + g + 8 < M)
      *reinterpret_cast<float2*>(out + static_cast<size_t>(row0 + g + 8) * C + d) =
          make_float2(o[dt][2], o[dt][3]);
  }
}

// ------------------------------------------------------------------ launch

template <typename T, int kDp>
cudaError_t launch(const Args& a, const RelpePlan& p, int B, cudaStream_t stream) {
  const auto kernel = relpe_kernel<T, kDp>;
  cudaError_t err = allow_smem(kernel, p.smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.M + p.tq - 1) / p.tq, kRelpeHeads / p.heads, B);
  kernel<<<grid, 32 * p.warps, p.smem_bytes, stream>>>(a, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_depth(const Args& a, const RelpePlan& p, int B, cudaStream_t s) {
  switch (p.dp) {
    case 16: return launch<T, 16>(a, p, B, s);
    case 32: return launch<T, 32>(a, p, B, s);
    case 64: return launch<T, 64>(a, p, B, s);
    case 128: return launch<T, 128>(a, p, B, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// xyz (B, M, 3) float32; q, k, v (B, M, C) float32 (bf16 = 0) or bfloat16
// (bf16 = 1), C = H * D with H = 8 (the encoder's num_heads) and D even, at
// most 128; pe the folded constants (360 float32); out (B, M, C) float32.
// Returns a CUDA error code.
extern "C" int gp2_relpe_attention(const float* xyz, const void* q, const void* k, const void* v,
                                   const float* pe, float* out, int B, int M, int C, int H,
                                   float scale, int bf16, void* stream) {
  if (B == 0 || M == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  RelpePlan p;
  if (relpe_plan(B, M, C, H, bf16, sms, &p) != 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{xyz, q, k, v, pe, out, M, C, C / H, scale, 0};
  // the widest copy that every row piece of every head starts on
  const int es = bf16 ? 2 : 4;
  const size_t base = reinterpret_cast<size_t>(k) | reinterpret_cast<size_t>(v);
  for (a.vec = 16; a.vec > es; a.vec >>= 1) {
    if ((a.D * es) % a.vec == 0 && (C * es) % a.vec == 0 && base % a.vec == 0) break;
  }
  if (base % a.vec != 0 || (reinterpret_cast<size_t>(xyz) & 3) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = bf16 ? launch_depth<Bf16>(a, p, B, s) : launch_depth<float>(a, p, B, s);
  return static_cast<int>(err);
}
