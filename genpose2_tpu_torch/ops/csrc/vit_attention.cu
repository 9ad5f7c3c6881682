// Token-major multi-head self-attention of the ViT backbone, three entries:
//   gp2_vit_attention           N padded to the sublane tile, keys >= n_valid masked
//   gp2_vit_attention_unpadded  any N >= 1 (the route for an unpadded token axis)
//   gp2_vit_attention_rope      as gp2_vit_attention, RoPE applied to q and k inside
//
// Replaces: genpose2_tpu/ops/vit_attention.py:vit_attention_tm (_kernel_tm,
// rope=False and rope=True), which keeps RB batch rows of q/k/v in VMEM and
// loops over heads, and vit_attention (_kernel), which transposes q/k/v to
// head-major and pads N to the sublane tile before the kernel. Those two are
// layouts Mosaic needs, not semantics: this kernel reads the token-major
// tensors as the qkv projection writes them and pads the token axis itself,
// so one template serves the padded and the unpadded token axis.
//
// Semantics: q, k, v (B, N, C) token-major, head h = columns h*D .. h*D+D-1;
// s = (q_h k_h^T) * scale (scale = 1/sqrt(D), applied after the product), keys
// j >= n_valid get -1e9 added; softmax in float32; p rounded to v's type; out =
// p v_h summed in float32, written float32. Query rows >= n_valid are computed
// like the others (the caller slices them off). With RoPE, sin and cos are
// (N, D) float32 tables, the same for every head: each q and k row becomes
// x * cos + rotate_half(x) * sin in float32 (rotate_half(x) = [-x2, x1] of the
// head's halves; each product and the sum rounded on their own, no FMA),
// rounded back to the input type, as the TPU kernel's roped() does.
//
// What bounds it on this card: at the ViT shape (64 objects, 272 tokens, 6
// heads of 64) the bytes are q/k/v once (40 MB in bf16) and the float32
// output (27 MB): 0.020 ms; the two products are 2 * 2 * 64 * 6 * 272^2 * 64
// = 7.3 GFLOP, 0.007 ms on the bf16 tensor cores, 0.11 ms on the float32
// pipes. So bf16 is bound by bytes and float32 by operations.
//
// Design:
// - A block stages one head's K and V once, by 16-byte cp.async, and takes
//   the query tiles of that head in turn. The host splits a head's tiles
//   among several blocks only when the heads alone would leave slots of the
//   card empty: at B=64 (a request, 384 heads) one block per head fills the
//   132 SMs in one round and K and V leave device memory once; at B=12 (a
//   frame call, 72 heads) each head is split in up to 5 blocks. bf16 blocks
//   commit one copy group per 64-key chunk, and the first tile starts on
//   chunk 0 while the rest arrives.
// - With RoPE the staged K is rotated once, in place; q rows are rotated as
//   they are loaded into registers (all loads of a tile issued first).
// - One pass of an online softmax over key chunks: the scores, the running
//   row max m, o and the row sum l rescaled as m grows, p = 2^(s c - m c)
//   with c = scale * log2(e) (one FFMA and one special-function op), o += p V
//   with p fed from registers as the A operand (the score fragment's layout
//   is the operand's), o divided by l at the end. No branch in the loop may
//   differ between the warps of a warpgroup: ptxas then waits after every
//   wgmma. The reference normalises p
//   before it rounds it to v's type; here the unnormalised p is rounded
//   (bf16) and l divides afterwards: the same relative rounding of each
//   weight (2^-9), at another point. float32 rounds p nowhere.
// - bf16: one warpgroup per block, 64 query rows at a time, both products by
//   wgmma (m64n64k16, float32 accumulation; a bf16 x bf16 product is exact
//   in float32) with q and p from registers and K and V read from shared
//   memory by descriptor. K and V are staged as 64-column blocks of 128-byte
//   rows in the 128-byte swizzle wgmma reads (16-byte chunk ^ (row & 7));
//   zeros pad the depth to 64 (D = 8 of the tiny configs: zeros add nothing
//   exactly) and the rows to 16; the last score chunk is as narrow as the
//   keys left (16, 32 or 48), and a chunk's PV product runs beside the next
//   chunk's scores. At the flagship shape a block holds 70 KB, three to an
//   SM: 12 warps, which cannot hide all of the wgmma latency; the kernel runs
//   at about 2.4x its bound (bytes), somewhat under SDPA (see PERF.md).
// - float32: the tolerance is 1e-5, which TF32 (10-bit mantissa) misses by
//   two orders of magnitude, so each operand is split into a TF32 high part
//   and a TF32 remainder and each product is three mma.sync.m16n8k8 (lo*hi,
//   hi*lo, hi*hi): about 21 bits of each product, float32 sums. One warp per
//   16 query rows, 32-key chunks; K and V rows padded by 4 floats
//   (conflict-free fragment loads), the depth to 16, 32, 64 or 128; in the
//   PV product the key order inside an 8-key step is permuted (keys 2t, 2t+1
//   are the operand's k = t, t+4) so that p again comes from the score
//   fragment without a shuffle.
// - Shared memory bounds N: at head dim 64, 896 tokens in bf16 and 416 in
//   float32 (the wrapper raises beyond gp2_vit_attention_max_tokens).
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

using Bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kChunk = 64;    // keys per bf16 score chunk (one wgmma n64)
constexpr int kF32Warps = 9;  // warps of a float32 block (one 16-row tile each)
constexpr int kF32Tiles = 4;  // n-tiles of 8 keys in a float32 score chunk

__host__ __device__ __forceinline__ int round_up(int n, int m) { return (n + m - 1) / m * m; }

// The MMA depth: bf16 D rounded up to 64 or 128, float32 D to 16, 32, 64 or
// 128 (0: not supported).
__host__ __device__ __forceinline__ int padded_depth(int D, bool bf16) {
  if (D <= 0 || D > 128) return 0;
  if (bf16) return D <= 64 ? 64 : 128;
  return D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : 128;
}

// Shared memory of a block: bf16 K and V (rows to a multiple of 16) plus 1 KB
// to align the swizzle atoms; float32 K and V rows of Dp + 4.
__host__ __forceinline__ size_t smem_bytes(int N, int Dp, bool bf16) {
  const int rows = round_up(N, 16);
  if (!bf16) return static_cast<size_t>(rows) * 2 * (Dp + 4) * 4;
  return static_cast<size_t>(2 * (Dp / 64) * rows) * 128 + 1024;
}

// --------------------------------------------------------------- PTX helpers

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most `pending` of this thread's latest copy groups are in
// flight (more than 7: as if 7, which waits longer than needed).
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// d += a * b on the tensor cores, m16n8k8, TF32 in, float32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: x = hi + lo with hi = tf32(x) and lo = tf32(x - hi) (x - hi is exact).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// The wgmma matrix descriptor of a shared-memory operand in the 128-byte
// swizzle: rows of 128 bytes, groups of 8 rows 1024 bytes apart.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pin the registers of a wgmma accumulator around the asynchronous product.
template <int kN>
__device__ __forceinline__ void fence_regs(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N: this warp's 16 rows) (+)= a (64 x 16, registers) . B, B (N x 16)
// from shared memory, K-major: N rows (keys) of K.
template <int kN>
__device__ __forceinline__ void wgmma_scores(float (&d)[kN / 2], const uint32_t (&a)[4],
                                             uint64_t desc, int accumulate);
template <>
__device__ __forceinline__ void wgmma_scores<16>(float (&d)[8], const uint32_t (&a)[4],
                                                 uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7"
      "}, {%8,%9,%10,%11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_scores<32>(float (&d)[16], const uint32_t (&a)[4],
                                                 uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15"
      "}, {%16,%17,%18,%19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_scores<48>(float (&d)[24], const uint32_t (&a)[4],
                                                 uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23"
      "}, {%24,%25,%26,%27}, %28, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_scores<64>(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,"
      "%30,%31"
      "}, {%32,%33,%34,%35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// d (64 x 64) += a (64 x 16, registers) . B, B (16 x 64) from shared memory,
// MN-major: 16 rows (keys) of V read as depth x keys.
__device__ __forceinline__ void wgmma_mnmajor(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,"
      "%30,%31"
      "}, {%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// 2^x by the special-function unit (relative error about 2^-22; results
// below 2^-126 flush to 0, far below any weight that moves a float32 sum).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ------------------------------------------------------------ shared layouts

// bf16: Dp / 64 blocks of 64 columns, each `rows` rows of 128 bytes with the
// 16-byte chunks swizzled by the row.
struct SwizzledRows {
  int rows;
  __device__ __forceinline__ int operator()(int j, int d) const {
    return (d >> 6) * rows * 64 + j * 64 + ((((d & 63) >> 3) ^ (j & 7)) << 3) + (d & 7);
  }
};
// float32: rows of kDp + 4.
template <int kDp>
struct PaddedRows {
  __device__ __forceinline__ int operator()(int j, int d) const { return j * (kDp + 4) + d; }
};

// ------------------------------------------------------------------- staging

// Rows j0..j1-1 of one head (src: its first element, rows C apart) into dst
// at idx(j, d), by 16-byte cp.async where a row is whole 16-byte vectors
// (vec), else element by element.
template <typename T, int kDp, typename Idx>
__device__ __forceinline__ void copy_rows(const T* __restrict__ src, T* dst, Idx idx, int j0,
                                          int j1, int C, int D, bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec && D == kDp) {  // the divisions by a constant become shifts
    for (int e = threadIdx.x; e < (j1 - j0) * (kDp / kVec); e += blockDim.x) {
      const int j = j0 + e / (kDp / kVec), c = (e % (kDp / kVec)) * kVec;
      cp_async16(dst + idx(j, c), src + static_cast<size_t>(j) * C + c);
    }
  } else if (vec) {
    const int per_row = D / kVec;
    for (int e = threadIdx.x; e < (j1 - j0) * per_row; e += blockDim.x) {
      const int j = j0 + e / per_row, c = (e % per_row) * kVec;
      cp_async16(dst + idx(j, c), src + static_cast<size_t>(j) * C + c);
    }
  } else {
    for (int e = threadIdx.x; e < (j1 - j0) * D; e += blockDim.x) {
      const int j = j0 + e / D, d = e % D;
      dst[idx(j, d)] = src[static_cast<size_t>(j) * C + d];
    }
  }
}

// Zeros in columns D..kDp-1 of rows 0..N-1 and in rows N..rows-1.
template <typename T, int kDp, typename Idx>
__device__ __forceinline__ void zero_pad(T* dst, Idx idx, int N, int rows, int D) {
  const T zero = from_f32<T>(0.f);
  const int pad = kDp - D;
  for (int e = threadIdx.x; e < N * pad; e += blockDim.x) {
    const int j = e / pad;
    dst[idx(j, D + e - j * pad)] = zero;
  }
  for (int e = threadIdx.x; e < (rows - N) * kDp; e += blockDim.x) {
    dst[idx(N + e / kDp, e % kDp)] = zero;
  }
}

// x * cos + rotate_half(x) * sin of an element whose pair partner is
// `partner` (d + D/2 for the first half, d - D/2 for the second), in float32
// with each product and the sum rounded on its own.
__device__ __forceinline__ float rotate(float x, float partner, bool first_half, float c,
                                        float s) {
  return __fadd_rn(__fmul_rn(x, c), __fmul_rn(first_half ? -partner : partner, s));
}

// RoPE on rows j0..j1-1 of the staged K, once: pair (d, d + D/2) of each row
// by one lane, rounded back to T; a warp walks the rows. Each lane reads four rows'
// pairs and their table entries (from L2) before it writes any: the loop is
// bound by the latency of those reads.
template <typename T, typename Idx>
__device__ __forceinline__ void rope_keys(T* sK, Idx idx, const float* __restrict__ sn,
                                          const float* __restrict__ cs, int j0, int j1, int D) {
  constexpr int kUnroll = 4;
  const int h2 = D / 2, warps = blockDim.x >> 5;
  for (int d = threadIdx.x & 31; d < h2; d += 32) {
    for (int r = j0 + (threadIdx.x >> 5); r < j1; r += kUnroll * warps) {
      float x1[kUnroll], x2[kUnroll], c1[kUnroll], s1[kUnroll], c2[kUnroll], s2[kUnroll];
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        const int j = min(r + i * warps, j1 - 1);
        const size_t t0 = static_cast<size_t>(j) * D + d;
        x1[i] = to_f32(sK[idx(j, d)]);
        x2[i] = to_f32(sK[idx(j, d + h2)]);
        c1[i] = __ldg(cs + t0);
        s1[i] = __ldg(sn + t0);
        c2[i] = __ldg(cs + t0 + h2);
        s2[i] = __ldg(sn + t0 + h2);
      }
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        const int j = r + i * warps;
        if (j >= j1) break;
        sK[idx(j, d)] = from_f32<T>(rotate(x1[i], x2[i], true, c1[i], s1[i]));
        sK[idx(j, d + h2)] = from_f32<T>(rotate(x2[i], x1[i], false, c2[i], s2[i]));
      }
    }
  }
}

// Element (row, d) of the head's q as the products take it: 0 past the rows
// or the depth, rotated and rounded to T with RoPE.
template <typename T, bool kRope>
__device__ __forceinline__ float q_elem(const T* __restrict__ qh, const float* __restrict__ sn,
                                        const float* __restrict__ cs, int row, int d, int N,
                                        int C, int D) {
  if (row >= N || d >= D) return 0.f;
  const T* r = qh + static_cast<size_t>(row) * C;
  const float x = to_f32(r[d]);
  if constexpr (!kRope) {
    return x;
  } else {
    const int h2 = D / 2;
    const bool first = d < h2;
    const size_t t = static_cast<size_t>(row) * D + d;
    const float y = rotate(x, to_f32(r[first ? d + h2 : d - h2]), first, __ldg(cs + t),
                           __ldg(sn + t));
    return to_f32(from_f32<T>(y));
  }
}

// ------------------------------------------------------ the softmax of a chunk
// g = lane / 4, t = lane % 4. A score or output fragment holds rows g and
// g + 8 of the warp's 16, columns 2t and 2t + 1 of each 8-column tile.

// The raw products of the chunk that reaches lim = min(N, n_valid), masked:
// keys >= n_valid become (s * scale - 1e9) / scale (the reference adds -1e9
// to s * scale, two roundings: for a row with a valid key their weight is 0
// either way, and with none the ties fall as in the reference), pad keys >= N
// become -inf. Earlier chunks need no test.
template <int kNT>
__device__ __forceinline__ void mask(float (&s)[kNT][4], int key0, int lim, int N, int n_valid,
                                     float scale, int lane) {
  if (key0 + 8 * kNT <= lim) return;
  const int t = lane & 3;
  const float inv_scale = 1.f / scale;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = key0 + nt * 8 + 2 * t + (e & 1);
      if (j >= N) {
        s[nt][e] = -INFINITY;
      } else if (j >= n_valid) {
        s[nt][e] = __fmul_rn(__fadd_rn(__fmul_rn(s[nt][e], scale), -1e9f), inv_scale);
      }
    }
  }
}

// The chunk's scores u -> weights 2^(u c - m c), with the running max m and
// sum l of rows g and g + 8 brought up to date; alpha: the factor by which
// the rows' earlier o and l shrink (1 when m did not move).
template <int kNT>
__device__ __forceinline__ void softmax_chunk(float (&u)[kNT][4], float (&m)[2], float (&l)[2],
                                              float c, float (&alpha)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float cm = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) cm = fmaxf(cm, fmaxf(u[nt][2 * r], u[nt][2 * r + 1]));
    const float mn = fmaxf(m[r], quad_max(cm));  // finite: every chunk holds a key < N
    alpha[r] = ex2((m[r] - mn) * c);
    m[r] = mn;
    const float mc = mn * c;
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      u[nt][2 * r] = ex2(fmaf(u[nt][2 * r], c, -mc));
      u[nt][2 * r + 1] = ex2(fmaf(u[nt][2 * r + 1], c, -mc));
      sum += u[nt][2 * r] + u[nt][2 * r + 1];
    }
    l[r] = l[r] * alpha[r] + sum;
  }
}

// Rows g and g + 8 of an output fragment times f[0] and f[1].
template <int kN>
__device__ __forceinline__ void scale_rows(float (&o)[kN][4], const float (&f)[2]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] *= f[e >> 1];
  }
}

// o (rows g, g + 8; 8-column tiles) into out (rows ldo apart) for the rows
// below n_rows and the columns below D.
template <int kN>
__device__ __forceinline__ void store_rows(const float (&o)[kN][4], float* out, int ldo,
                                           int n_rows, int D, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int dt = 0; dt < kN; ++dt) {
    const int d = dt * 8 + 2 * t;  // D is even: d < D means d + 1 < D
    if (d >= D) continue;
    if (g < n_rows) {
      *reinterpret_cast<float2*>(out + static_cast<size_t>(g) * ldo + d) =
          make_float2(o[dt][0], o[dt][1]);
    }
    if (g + 8 < n_rows) {
      *reinterpret_cast<float2*>(out + static_cast<size_t>(g + 8) * ldo + d) =
          make_float2(o[dt][2], o[dt][3]);
    }
  }
}

// ------------------------------------------------------------ bf16 by wgmma

// q (this warp's 16 rows of the 64-row tile) as A operands, kDp / 16 k-steps:
// pairs of columns (d, d + 1; D is even) as they lie, or with RoPE rotated
// in float32 and rounded to bf16. The rotation's inputs (the pair, its
// partner pair d -+ D/2 and the tables' pairs) are all loaded before any is
// used: the loads are bound by their latency, not their number.
template <int kDp, bool kRope>
__device__ __forceinline__ void load_q_bf16(uint32_t (&a)[kDp / 16][4], const Bf16* qh,
                                            const float* sn, const float* cs, int row0, int N,
                                            int C, int D, int lane) {
  constexpr int kKS = kDp / 16;
  const int g = lane >> 2, t = lane & 3, h2 = D / 2;
  uint32_t x[kKS][4], partner[kKS][4];
  float2 c[kKS][4], sv[kKS][4];
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + g + (i & 1) * 8, d = ks * 16 + 2 * t + (i >> 1) * 8;
      const bool in = row < N && d < D;
      const Bf16* r = qh + static_cast<size_t>(row) * C;
      x[ks][i] = in ? __ldg(reinterpret_cast<const unsigned int*>(r + d)) : 0u;
      if constexpr (kRope) {
        const size_t tab = static_cast<size_t>(row) * D + d;
        partner[ks][i] = in ? __ldg(reinterpret_cast<const unsigned int*>(
                                  r + (d < h2 ? d + h2 : d - h2)))
                            : 0u;
        c[ks][i] = in ? __ldg(reinterpret_cast<const float2*>(cs + tab)) : make_float2(0.f, 0.f);
        sv[ks][i] = in ? __ldg(reinterpret_cast<const float2*>(sn + tab)) : make_float2(0.f, 0.f);
      }
    }
  }
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (kRope) {
        const int d = ks * 16 + 2 * t + (i >> 1) * 8;
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x[ks][i]));
        const float2 pv =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&partner[ks][i]));
        a[ks][i] = pack_bf16(rotate(xv.x, pv.x, d < h2, c[ks][i].x, sv[ks][i].x),
                             rotate(xv.y, pv.y, d < h2, c[ks][i].y, sv[ks][i].y));
      } else {
        a[ks][i] = x[ks][i];
      }
    }
  }
}

// An 8-column-tile fragment array as the flat accumulator of a wgmma.
template <int kNT>
__device__ __forceinline__ float (&flat(float (&x)[kNT][4]))[4 * kNT] {
  return *reinterpret_cast<float(*)[4 * kNT]>(&x[0][0]);
}

// One chunk of 8 kNT keys from key0 (64, or the 16, 32 or 48 left at the
// end) for a 64-row tile: the scores, the softmax update of m and l, o
// rescaled, and o += p V issued (it retires during the next chunk's scores).
template <int kDp, int kNT>
__device__ __forceinline__ void attend_chunk(const uint32_t (&qa)[kDp / 16][4], const Bf16* sK,
                                             const Bf16* sV, int rows, int key0, int N,
                                             int n_valid, float scale, float c2, int lane,
                                             float (&m)[2], float (&l)[2],
                                             float (&o)[kDp / 64][8][4]) {
  constexpr int kCB = kDp / 64;
  float u[kNT][4];
  wgmma_fence();
#pragma unroll
  for (int cb = 0; cb < kCB; ++cb) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      wgmma_scores<8 * kNT>(flat(u), qa[cb * 4 + ks],
                            smem_desc(sK + (cb * rows + key0) * 64 + ks * 16), cb + ks > 0);
    }
  }
  wgmma_commit();
  wgmma_wait_all();  // these scores, and the previous chunk's PV product
  fence_regs(flat(u));
#pragma unroll
  for (int cb = 0; cb < kCB; ++cb) fence_regs(flat(o[cb]));
  // no branch here may differ between the warps of the warpgroup: ptxas then
  // serialises every wgmma of the loop
  float alpha[2];
  mask(u, key0, min(N, n_valid), N, n_valid, scale, lane);
  softmax_chunk(u, m, l, c2, alpha);
#pragma unroll
  for (int cb = 0; cb < kCB; ++cb) scale_rows(o[cb], alpha);
  uint32_t pa[kNT / 2][4];
#pragma unroll
  for (int kk = 0; kk < kNT / 2; ++kk) {
    pa[kk][0] = pack_bf16(u[2 * kk][0], u[2 * kk][1]);
    pa[kk][1] = pack_bf16(u[2 * kk][2], u[2 * kk][3]);
    pa[kk][2] = pack_bf16(u[2 * kk + 1][0], u[2 * kk + 1][1]);
    pa[kk][3] = pack_bf16(u[2 * kk + 1][2], u[2 * kk + 1][3]);
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kNT / 2; ++kk) {
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb) {
      wgmma_mnmajor(flat(o[cb]), pa[kk], smem_desc(sV + (cb * rows + key0 + 16 * kk) * 64));
    }
  }
  wgmma_commit();
}

// One 64-row tile against every key: o = softmax(s) V (this warp's 16 rows;
// kDp / 64 column blocks of 64). first: the block's first tile, which calls
// arrive(c) before it reads chunk c.
template <int kDp, typename Arrive>
__device__ __forceinline__ void attend_bf16(const uint32_t (&qa)[kDp / 16][4], const Bf16* sK,
                                            const Bf16* sV, int rows, int N, int n_valid,
                                            float scale, bool first, Arrive arrive,
                                            int lane, float (&o)[kDp / 64][8][4]) {
  constexpr int kCB = kDp / 64;
  const float c2 = scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int cb = 0; cb < kCB; ++cb) {
#pragma unroll
    for (int i = 0; i < 8; ++i) o[cb][i][0] = o[cb][i][1] = o[cb][i][2] = o[cb][i][3] = 0.f;
  }
  int key0 = 0;
  for (; key0 + kChunk <= rows; key0 += kChunk) {
    if (first) arrive(key0 / kChunk);
    attend_chunk<kDp, 8>(qa, sK, sV, rows, key0, N, n_valid, scale, c2, lane, m, l, o);
  }
  if (key0 < rows) {  // 16, 32 or 48 keys left: a narrower chunk
    if (first) arrive(key0 / kChunk);
    switch (rows - key0) {
      case 16:
        attend_chunk<kDp, 2>(qa, sK, sV, rows, key0, N, n_valid, scale, c2, lane, m, l, o);
        break;
      case 32:
        attend_chunk<kDp, 4>(qa, sK, sV, rows, key0, N, n_valid, scale, c2, lane, m, l, o);
        break;
      default:
        attend_chunk<kDp, 6>(qa, sK, sV, rows, key0, N, n_valid, scale, c2, lane, m, l, o);
    }
  }
  wgmma_wait_all();
#pragma unroll
  for (int cb = 0; cb < kCB; ++cb) fence_regs(flat(o[cb]));
  const float inv[2] = {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])};
#pragma unroll
  for (int cb = 0; cb < kCB; ++cb) scale_rows(o[cb], inv);
}

// Block (chunk, head, object), one warpgroup: tiles_per_block 64-row query
// tiles of the head, one after another; the next tile's q is loaded while
// this one runs.
template <int kDp, bool kRope>
__global__ void __launch_bounds__(128, 3)
vit_attention_bf16_kernel(const Bf16* __restrict__ q, const Bf16* __restrict__ k,
                          const Bf16* __restrict__ v, const float* __restrict__ sn,
                          const float* __restrict__ cs, float* __restrict__ out, int N, int C,
                          int D, int n_valid, float scale, int tiles_per_block, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle atoms (8 rows of 128 bytes) start on 1024-byte boundaries
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  Bf16* sK = reinterpret_cast<Bf16*>(smem_raw + ((1024 - (base & 1023)) & 1023));
  const int rows = round_up(N, 16);
  Bf16* sV = sK + (kDp / 64) * rows * 64;
  const size_t head = static_cast<size_t>(blockIdx.z) * N * C + static_cast<size_t>(blockIdx.y) * D;
  // one copy group per 64-key chunk (K's and V's rows), so that the first
  // tile starts on chunk 0 while the rest arrives
  const int chunks = (rows + kChunk - 1) / kChunk;
  zero_pad<Bf16, kDp>(sK, SwizzledRows{rows}, N, rows, D);
  zero_pad<Bf16, kDp>(sV, SwizzledRows{rows}, N, rows, D);
  for (int c = 0; c < chunks; ++c) {
    const int j0 = c * kChunk, j1 = min(j0 + kChunk, N);
    copy_rows<Bf16, kDp>(k + head, sK, SwizzledRows{rows}, j0, j1, C, D, vec);
    copy_rows<Bf16, kDp>(v + head, sV, SwizzledRows{rows}, j0, j1, C, D, vec);
    cp_async_commit();
  }
  // chunk c has landed (rotated with RoPE) for every thread, and the async
  // proxy that wgmma reads through sees it
  auto arrive = [&](int c) {
    cp_async_wait(chunks - 1 - c);
    if constexpr (kRope) {
      __syncthreads();
      rope_keys(sK, SwizzledRows{rows}, sn, cs, c * kChunk, min(c * kChunk + kChunk, N), D);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  };

  const int lane = threadIdx.x & 31, wrow = 16 * (threadIdx.x >> 5);
  const int first = blockIdx.x * tiles_per_block;
  const int end = min(first + tiles_per_block, (N + 63) / 64);
  uint32_t qa[kDp / 16][4];
  load_q_bf16<kDp, kRope>(qa, q + head, sn, cs, first * 64 + wrow, N, C, D, lane);

  for (int tile = first; tile < end; ++tile) {
    const int row0 = tile * 64 + wrow;
    uint32_t qn[kDp / 16][4];
    if (tile + 1 < end) load_q_bf16<kDp, kRope>(qn, q + head, sn, cs, row0 + 64, N, C, D, lane);
    float o[kDp / 64][8][4];
    attend_bf16<kDp>(qa, sK, sV, rows, N, n_valid, scale, tile == first, arrive, lane, o);
#pragma unroll
    for (int cb = 0; cb < kDp / 64; ++cb) {
      store_rows(o[cb], out + head + static_cast<size_t>(row0) * C + cb * 64, C, N - row0,
                 D - cb * 64, lane);
    }
#pragma unroll
    for (int ks = 0; ks < kDp / 16; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[ks][i] = qn[ks][i];
    }
  }
}

// ------------------------------------------------------- float32 by mma.sync

// q (this warp's 16 rows) as the high and low TF32 parts of m16n8k8 A
// operands, kDp / 8 k-steps.
template <int kDp>
struct QFragF32 {
  uint32_t hi[kDp / 8][4], lo[kDp / 8][4];
};

template <int kDp, bool kRope>
__device__ __forceinline__ void load_q_f32(QFragF32<kDp>& f, const float* qh, const float* sn,
                                           const float* cs, int row0, int N, int C, int D,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3, r0 = row0 + g, r1 = r0 + 8;
  auto at = [&](int row, int d) { return q_elem<float, kRope>(qh, sn, cs, row, d, N, C, D); };
#pragma unroll
  for (int ks = 0; ks < kDp / 8; ++ks) {
    const int d = ks * 8 + t;
    const float x[4] = {at(r0, d), at(r1, d), at(r0, d + 4), at(r1, d + 4)};
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(x[i], f.hi[ks][i], f.lo[ks][i]);
  }
}

// s[nt] = q . K[key0 + 8 nt + 0..7]^T for the n-tiles below Np (the rest 0);
// kFull: the whole chunk is below Np, so no n-tile is tested and the
// unrolled MMA chains interleave.
template <int kDp, bool kFull>
__device__ __forceinline__ void scores_f32(const QFragF32<kDp>& f, const float* sK, int key0,
                                           int Np, int lane, float (&s)[kF32Tiles][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kF32Tiles; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    if (!kFull && key0 + nt * 8 >= Np) continue;
    const float* kr = sK + PaddedRows<kDp>()(key0 + nt * 8 + g, t);
#pragma unroll
    for (int ks = 0; ks < kDp / 8; ++ks) {
      uint32_t h0, l0, h1, l1;
      split_tf32(kr[ks * 8], h0, l0);
      split_tf32(kr[ks * 8 + 4], h1, l1);
      mma_tf32(s[nt], f.lo[ks], h0, h1);
      mma_tf32(s[nt], f.hi[ks], l0, l1);
      mma_tf32(s[nt], f.hi[ks], h0, h1);
    }
  }
}

// o += p . V[key0 ..] for the 8-key steps below Np; operand k = t <-> key 2t,
// k = t + 4 <-> key 2t + 1.
template <int kDp, bool kFull>
__device__ __forceinline__ void pv_f32(const float (&p)[kF32Tiles][4], const float* sV,
                                       int key0, int Np, int lane, float (&o)[kDp / 8][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kF32Tiles; ++nt) {
    if (!kFull && key0 + nt * 8 >= Np) continue;
    uint32_t ah[4], al[4];
    split_tf32(p[nt][0], ah[0], al[0]);
    split_tf32(p[nt][2], ah[1], al[1]);
    split_tf32(p[nt][1], ah[2], al[2]);
    split_tf32(p[nt][3], ah[3], al[3]);
    const float* v0 = sV + PaddedRows<kDp>()(key0 + nt * 8 + 2 * t, g);
#pragma unroll
    for (int dt = 0; dt < kDp / 8; ++dt) {
      uint32_t h0, l0, h1, l1;
      split_tf32(v0[dt * 8], h0, l0);
      split_tf32(v0[kDp + 4 + dt * 8], h1, l1);
      mma_tf32(o[dt], al, h0, h1);
      mma_tf32(o[dt], ah, l0, l1);
      mma_tf32(o[dt], ah, h0, h1);
    }
  }
}

// Block (chunk, head, object), one warp per 16-row tile: tiles_per_block
// tiles of the head, taken by the warps in turn.
template <int kDp, bool kRope>
__global__ void __launch_bounds__(kF32Warps * 32)
vit_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ sn,
                         const float* __restrict__ cs, float* __restrict__ out, int N, int C,
                         int D, int n_valid, float scale, int tiles_per_block, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kKeys = 8 * kF32Tiles;
  const int Np = round_up(N, 16);
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + Np * (kDp + 4);
  const size_t head = static_cast<size_t>(blockIdx.z) * N * C + static_cast<size_t>(blockIdx.y) * D;
  zero_pad<float, kDp>(sK, PaddedRows<kDp>(), N, Np, D);
  zero_pad<float, kDp>(sV, PaddedRows<kDp>(), N, Np, D);
  copy_rows<float, kDp>(k + head, sK, PaddedRows<kDp>(), 0, N, C, D, vec);
  copy_rows<float, kDp>(v + head, sV, PaddedRows<kDp>(), 0, N, C, D, vec);
  cp_async_commit();

  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int end = min((static_cast<int>(blockIdx.x) + 1) * tiles_per_block, Np / 16);
  int tile = blockIdx.x * tiles_per_block + (threadIdx.x >> 5);
  QFragF32<kDp> f;
  if (tile < end) load_q_f32<kDp, kRope>(f, q + head, sn, cs, tile * 16, N, C, D, lane);
  cp_async_wait(0);
  __syncthreads();
  if constexpr (kRope) {
    rope_keys(sK, PaddedRows<kDp>(), sn, cs, 0, N, D);
    __syncthreads();
  }

  const int lim = min(N, n_valid);
  const float c = scale * kLog2e;
  while (tile < end) {
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float o[kDp / 8][4];
#pragma unroll
    for (int dt = 0; dt < kDp / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
    for (int key0 = 0; key0 < Np; key0 += kKeys) {
      float u[kF32Tiles][4];
      const bool full = key0 + kKeys <= Np;
      if (full) {
        scores_f32<kDp, true>(f, sK, key0, Np, lane, u);
      } else {
        scores_f32<kDp, false>(f, sK, key0, Np, lane, u);
      }
      mask(u, key0, lim, N, n_valid, scale, lane);
      float alpha[2];
      softmax_chunk(u, m, l, c, alpha);
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) scale_rows(o, alpha);
      if (full) {
        pv_f32<kDp, true>(u, sV, key0, Np, lane, o);
      } else {
        pv_f32<kDp, false>(u, sV, key0, Np, lane, o);
      }
    }
    const float inv[2] = {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])};
    scale_rows(o, inv);
    const int row0 = tile * 16;
    tile += warps;
    if (tile < end) load_q_f32<kDp, kRope>(f, q + head, sn, cs, tile * 16, N, C, D, lane);
    store_rows(o, out + head + static_cast<size_t>(row0) * C, C, N - row0, D, lane);
  }
}

// ------------------------------------------------------------------- launch

template <typename T, int kDp, bool kRope>
cudaError_t launch(const T* q, const T* k, const T* v, const float* sn, const float* cs,
                   float* out, int B, int N, int C, int H, int n_valid, float scale,
                   cudaStream_t stream) {
  constexpr bool kBf16 = !std::is_same<T, float>::value;
  void (*kernel)(const T*, const T*, const T*, const float*, const float*, float*, int, int, int,
                 int, float, int, int);
  if constexpr (kBf16) {
    kernel = vit_attention_bf16_kernel<kDp, kRope>;
  } else {
    kernel = vit_attention_f32_kernel<kDp, kRope>;
  }
  const int threads = kBf16 ? 128 : 32 * kF32Warps, tile_rows = kBf16 ? 64 : 16;
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(N, kDp, kBf16);
  if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  err = allow_smem(kernel, smem);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  }
  if (err != cudaSuccess) return err;
  // a head's tiles go to one block unless the heads leave slots empty: then
  // to as many blocks as the slots hold, evened out
  const int tiles = (N + tile_rows - 1) / tile_rows;
  const long heads = static_cast<long>(B) * H, slots = static_cast<long>(per_sm) * sms;
  int chunks = static_cast<int>(std::max(1L, std::min<long>(tiles, slots / heads)));
  const int per_block = (tiles + chunks - 1) / chunks;
  chunks = (tiles + per_block - 1) / per_block;
  constexpr int kVec = 16 / sizeof(T);
  const int D = C / H;
  const int vec = D % kVec == 0 && C % kVec == 0 &&
                  (reinterpret_cast<size_t>(k) | reinterpret_cast<size_t>(v)) % 16 == 0;
  const int block = kBf16 ? threads : std::min(threads, 32 * per_block);
  kernel<<<dim3(chunks, H, B), block, smem, stream>>>(q, k, v, sn, cs, out, N, C, D, n_valid,
                                                      scale, per_block, vec);
  return cudaGetLastError();
}

template <typename T, bool kRope>
cudaError_t launch_depth(const void* q, const void* k, const void* v, const float* sn,
                         const float* cs, float* out, int B, int N, int C, int H, int n_valid,
                         float scale, cudaStream_t s) {
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v);
  constexpr bool kBf16 = !std::is_same<T, float>::value;
  switch (padded_depth(C / H, kBf16)) {
    case 16:
      if constexpr (!kBf16) {
        return launch<T, 16, kRope>(qt, kt, vt, sn, cs, out, B, N, C, H, n_valid, scale, s);
      }
      break;
    case 32:
      if constexpr (!kBf16) {
        return launch<T, 32, kRope>(qt, kt, vt, sn, cs, out, B, N, C, H, n_valid, scale, s);
      }
      break;
    case 64: return launch<T, 64, kRope>(qt, kt, vt, sn, cs, out, B, N, C, H, n_valid, scale, s);
    case 128:
      return launch<T, 128, kRope>(qt, kt, vt, sn, cs, out, B, N, C, H, n_valid, scale, s);
  }
  return cudaErrorInvalidValue;
}

template <bool kRope>
int dispatch(const void* q, const void* k, const void* v, const float* sn, const float* cs,
             float* out, int B, int N, int C, int H, int n_valid, float scale, int bf16,
             void* stream) {
  if (H <= 0 || C % H != 0 || (C / H) % 2 != 0 || padded_depth(C / H, bf16) == 0 || N <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_depth<Bf16, kRope>(q, k, v, sn, cs, out, B, N, C, H, n_valid, scale, s)
           : launch_depth<float, kRope>(q, k, v, sn, cs, out, B, N, C, H, n_valid, scale, s);
  return static_cast<int>(err);
}

}  // namespace

// The most tokens a launch takes at head dim D (0: D not supported): the
// staged K and V of one head fill at most the card's shared memory per block.
extern "C" int gp2_vit_attention_max_tokens(int D, int bf16) {
  const int Dp = padded_depth(D, bf16 != 0);
  int dev = 0, optin = 0;
  if (Dp == 0 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) {
    return 0;
  }
  int n = 0;
  while (smem_bytes(n + 16, Dp, bf16 != 0) <= static_cast<size_t>(optin)) n += 16;
  return n;
}

// q, k, v (B, N, C) float32 (bf16 = 0) or bfloat16 (bf16 = 1), C = H * D;
// out (B, N, C) float32. Returns a CUDA error code.
extern "C" int gp2_vit_attention(const void* q, const void* k, const void* v, float* out, int B,
                                 int N, int C, int H, int n_valid, float scale, int bf16,
                                 void* stream) {
  return dispatch<false>(q, k, v, nullptr, nullptr, out, B, N, C, H, n_valid, scale, bf16,
                         stream);
}

// As gp2_vit_attention, for a token axis of any length N >= 1 (not padded).
extern "C" int gp2_vit_attention_unpadded(const void* q, const void* k, const void* v,
                                          float* out, int B, int N, int C, int H, int n_valid,
                                          float scale, int bf16, void* stream) {
  return dispatch<false>(q, k, v, nullptr, nullptr, out, B, N, C, H, n_valid, scale, bf16,
                         stream);
}

// As gp2_vit_attention, with the sin and cos tables (N, C / H) float32
// rotating q and k.
extern "C" int gp2_vit_attention_rope(const void* q, const void* k, const void* v,
                                      const float* sin_tab, const float* cos_tab, float* out,
                                      int B, int N, int C, int H, int n_valid, float scale,
                                      int bf16, void* stream) {
  return dispatch<true>(q, k, v, sin_tab, cos_tab, out, B, N, C, H, n_valid, scale, bf16,
                        stream);
}
