// Tensor-core products for the kernels whose weights stream through shared
// memory (ode_rk4.cu, fused_sa.cu): rows of activations in shared memory
// times a weight matrix in device memory, tile by tile; and the online
// softmax of attention on mma fragments (relpe_attention.cu,
// vit_attention.cu).
//
// Both operands are held in the compute type, as the JAX reference casts the
// left operand to the weights' dtype before each dot
// (jnp.dot(h.astype(W.dtype), W, preferred_element_type=f32)):
// - bf16: mma.sync.m16n8k16 (bf16 in, float32 sums; a bf16 x bf16 product is
//   exact in float32, so only the order of the sums differs), fragments by
//   ldmatrix.
// - float32: 3xTF32 on mma.sync.m16n8k8: each operand x = hi + lo with hi =
//   tf32(x) and lo = tf32(x - hi), and a * b = hi*hi + hi*lo + lo*hi, about
//   21 bits of each product with float32 sums (TF32 alone keeps 11).
//
// Shared-memory layouts (plan.cuh computes their strides):
// - activations A: row-major, `lda` elements a row, lda = K16 + 8 (bf16) or
//   K16 + 4 (float32), K16 the depth rounded up to 16; both make the fragment
//   reads of one warp conflict-free. Columns K..K16-1 hold zeros.
// - a weight tile: `kt` rows (depth) of a column chunk of at most kChunkCols
//   columns, row-major with ldw = cols16 + 8 elements; rows past K and
//   columns past N are zero-filled while staging.
// Weight tiles are copied by cp.async (16, 8 or 4 bytes, the widest that the
// matrix's row length and base address allow) into a ring of buffers; a row
// of 2-byte alignment only (bf16 with an odd width) is copied by plain loads.
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "plan.cuh"

namespace mma {

constexpr int kWarps = kPlanWarps;
constexpr int kThreads = 32 * kWarps;

// ------------------------------------------------------------------ cp.async

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "n"(kBytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most `pending` (0, 1 or 2) of this thread's latest copy
// groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ----------------------------------------------------------------- the mmas

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a b, m16n8k16, bf16 in, float32 sums. The mmas touch registers only,
// so they are not volatile: the compiler interleaves them with the loads.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b, m16n8k8, TF32 in, float32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// hi: x rounded to TF32's 10 mantissa bits (half away from zero, by integer
// ops: cvt.rna.tf32 runs at a quarter of their rate and would bound the
// product); lo = x - hi, exact, whose low 13 bits the tensor core ignores
// (|lo| <= 2^-11 |x|, so that truncation costs 2^-22 |x|, as much as the
// lo * lo term left out).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// x = hi + lo with both parts rounded to TF32 (cvt.rna): x - hi is exact
// and lo keeps 11 of its 13 bits, so hi + lo is within 2^-22 |x| of x, half
// the error of split_tf32, for products whose error the rounding must bound
// (the attention kernels' float32 paths).
__device__ __forceinline__ void split_tf32_rn(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// ------------------------------------------------------------ weight tiles

// One tile of the weight stream: rows k0 .. k0+kt-1 and columns n0 ..
// n0+cols-1 of the row-major (K, N) matrix W.
struct Tile {
  const void* W;
  int K, N, k0, kt, n0, cols;
};

// The copy width of a matrix: 16, 8 or 4 bytes where every row starts on it,
// else 2 (bf16 only: plain loads).
__device__ __forceinline__ int copy_bytes(const void* W, int N, int esize) {
  const size_t row = static_cast<size_t>(N) * esize;
  const size_t base = reinterpret_cast<size_t>(W);
  for (int v = 16; v >= 4; v >>= 1)
    if (row % v == 0 && base % v == 0) return v;
  return 2;
}

template <int kBytes, typename T>
__device__ __forceinline__ void stage_vec(T* dst, const Tile& t, int ldw, int cols16) {
  constexpr int kPer = kBytes / sizeof(T);
  const int vpr = cols16 / kPer;  // vectors per row (cols16 is a multiple of 16)
  const T* W = static_cast<const T*>(t.W);
  // vector (r, v) of the tile, walked without a division per vector
  int r = threadIdx.x / vpr, v = threadIdx.x % vpr;
  const int dr = blockDim.x / vpr, dv = blockDim.x % vpr;
  for (int e = threadIdx.x; e < t.kt * vpr; e += blockDim.x) {
    const int c = v * kPer;
    T* d = dst + r * ldw + c;
    const int k = t.k0 + r, n = t.n0 + c;
    if (k < t.K && n < t.n0 + t.cols) {  // a vector lies wholly inside a row
      cp_async<kBytes>(d, W + static_cast<size_t>(k) * t.N + n);
    } else {
#pragma unroll
      for (int u = 0; u < kPer; ++u) d[u] = from_f32<T>(0.f);
    }
    r += dr;
    v += dv;
    if (v >= vpr) {
      v -= vpr;
      ++r;
    }
  }
}

// Issue the copies of one tile into dst (ldw = cols16 + 8). Rows past K and
// columns past the chunk's last are zero-filled.
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, const Tile& t, int vec_bytes) {
  const int cols16 = (t.cols + 15) / 16 * 16, ldw = cols16 + 8;
  switch (vec_bytes) {
    case 16: stage_vec<16>(dst, t, ldw, cols16); break;
    case 8: stage_vec<8>(dst, t, ldw, cols16); break;
    case 4: stage_vec<4>(dst, t, ldw, cols16); break;
    default: {
      const T* W = static_cast<const T*>(t.W);
      for (int e = threadIdx.x; e < t.kt * cols16; e += blockDim.x) {
        const int r = e / cols16, c = e % cols16;
        const int k = t.k0 + r;
        dst[r * ldw + c] = k < t.K && c < t.cols
                               ? W[static_cast<size_t>(k) * t.N + t.n0 + c]
                               : from_f32<T>(0.f);
      }
    }
  }
}

// One product's weights: W (K, N) row-major in device memory.
// Its tiles' geometry is worked out once (make_prod): chunks of kChunkCols
// columns but the last, each cut into nkt depth tiles of kt rows.
struct Prod {
  const void* W;
  int K, N;
  int vec;  // copy_bytes(W, N, esize)
  int nch, kt, nkt, last_cols, last_kt, last_nkt;
  // chunk c: its columns, depth-tile rows and depth tiles
  __device__ __forceinline__ void chunk(int c, int& cols, int& rows, int& tiles) const {
    const bool last = c == nch - 1;
    cols = last ? last_cols : kChunkCols;
    rows = last ? last_kt : kt;
    tiles = last ? last_nkt : nkt;
  }
};

__device__ __forceinline__ Prod make_prod(const void* W, int K, int N, int esize,
                                          int ring_elems) {
  Prod p;
  p.W = W;
  p.K = K;
  p.N = N;
  p.vec = copy_bytes(W, N, esize);
  p.nch = n_chunks(N);
  p.kt = tile_rows(K, kChunkCols, ring_elems);
  p.nkt = n_ktiles(K, kChunkCols, ring_elems);
  p.last_cols = chunk_cols(N, p.nch - 1);
  p.last_kt = tile_rows(K, p.last_cols, ring_elems);
  p.last_nkt = n_ktiles(K, p.last_cols, ring_elems);
  return p;
}

// The weight tiles of a sequence of products, in the order the block uses
// them (each product's column chunks in turn, each chunk's depth tiles in
// turn), repeated: a ring of nbuf buffers of ring_elems, filled nbuf - 1
// tiles ahead of the tile in use. Every thread of the block calls each
// function at the same points.
template <typename T>
struct Stream {
  T* ring;
  int ring_elems, nbuf;
  const Prod* prods;
  int nprod;
  long long remaining;  // tiles still to fetch
  int l, c, t;          // the next tile to fetch
  int fill, use;        // buffer it goes to; buffer of the tile in use

  __device__ void issue() {
    if (remaining > 0) {
      const Prod& p = prods[l];
      int cols, kt, nkt;
      p.chunk(c, cols, kt, nkt);
      const Tile tile = {p.W, p.K, p.N, t * kt, kt, c * kChunkCols, cols};
      stage_tile(ring + fill * ring_elems, tile, p.vec);
      --remaining;
      if (++t == nkt) {
        t = 0;
        if (++c == p.nch) {
          c = 0;
          if (++l == nprod) l = 0;
        }
      }
    }
    cp_async_commit();  // an empty group past the end keeps the counts uniform
    fill = fill + 1 == nbuf ? 0 : fill + 1;
  }

  // Start on `tiles` tiles of the products' sequence, from its beginning.
  // The block must be done with the ring (a __syncthreads since its last
  // tile).
  __device__ void start(const Prod* ps, int n, long long tiles) {
    prods = ps;
    nprod = n;
    remaining = tiles;
    l = c = t = 0;
    fill = use = 0;
    for (int i = 0; i + 1 < nbuf; ++i) issue();
  }

  // The next tile, once every thread's copies of it have landed; also
  // starts the copy of the tile nbuf - 1 further on, into the buffer the
  // block used last.
  __device__ const T* next() {
    cp_async_wait(nbuf - 2);
    __syncthreads();
    issue();
    const T* tile = ring + use * ring_elems;
    use = use + 1 == nbuf ? 0 : use + 1;
    return tile;
  }
};

// Tiles of one pass over a sequence of products.
__device__ __forceinline__ long long pass_tiles(const Prod* prods, int nprod) {
  long long n = 0;
  for (int i = 0; i < nprod; ++i) n += (prods[i].nch - 1) * prods[i].nkt + prods[i].last_nkt;
  return n;
}

// ------------------------------------------------- one warp's share of a tile

// A warp's block of the output: the m-tiles mt = mg, mg + nmg, ... below MT
// (16 rows each) and the nt n-tiles (8 columns each) of the column block
// that starts at column n0 of the chunk; acc[i][j] is m-tile mg + i * nmg,
// n-tile j. Blocks are 32 columns wide (nt = 4), or 16 (nt = 2) where the
// chunk has one m-tile, so that a 256-column chunk still busies every warp.
// A chunk has at most kChunkCols / 32 blocks of 32 columns, so at least
// kWarps / that many m-tile groups: a warp holds at most kM m-tiles.
template <int MT>
struct WarpTile {
  static constexpr int kGroups = kWarps / (kChunkCols / 32);
  static constexpr int kM = (MT + kGroups - 1) / kGroups;
  static constexpr int kNT = MT == 1 ? 2 : 4;
  int n0, mg, nmg;
  bool active;
  __device__ __forceinline__ bool has_m(int i) const { return mg + i * nmg < MT; }
  __device__ __forceinline__ bool has_n(int j, int cols16) const {
    return j < kNT && n0 + 8 * j < cols16;
  }
};

// The warps of a block over a chunk of `cols` columns: column blocks first,
// then m-tile groups; warps past ncb * nmg idle.
template <int MT>
__device__ __forceinline__ WarpTile<MT> warp_tile(int cols) {
  constexpr int kWidth = 8 * WarpTile<MT>::kNT;
  const int warp = threadIdx.x >> 5;
  const int ncb = (cols + kWidth - 1) / kWidth;
  WarpTile<MT> w;
  w.nmg = min(kWarps / ncb, MT);
  w.n0 = warp % ncb * kWidth;
  w.mg = warp / ncb;
  w.active = w.mg < w.nmg;
  return w;
}

// One depth step of a warp's block: the tile's columns n-tile j covers are
// n0 + 8 j + (0..7); ka: the step's depth within A, kb: within the tile.
template <typename T, int MT>
struct Mma;

// The fragments of one mma depth step: A for the warp's m-tiles, B for its
// n-tiles (float32: the raw values, split at use).
template <typename T, int MT>
struct Frags;
template <int MT>
struct Frags<__nv_bfloat16, MT> {
  uint32_t a[WarpTile<MT>::kM][4], b[4][2];
};
template <int MT>
struct Frags<float, MT> {
  float a[WarpTile<MT>::kM][4], b[4][2];
};

template <int MT>
struct Mma<__nv_bfloat16, MT> {
  static constexpr int kStep = 16;
  static __device__ __forceinline__ void load(Frags<__nv_bfloat16, MT>& f,
                                              const WarpTile<MT>& w, const __nv_bfloat16* A,
                                              int lda, int ka, const __nv_bfloat16* Wt, int ldw,
                                              int kb, int cols16) {
    const int lane = threadIdx.x & 31;
    const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lcol = 8 * (lane >> 4);
    const int nbase = w.n0;
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {  // n-tiles 2jp, 2jp+1 in one x4.trans
      if (w.has_n(2 * jp, cols16)) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, Wt + (kb + lrow) * ldw + nbase + 16 * jp + lcol);
        f.b[2 * jp][0] = r[0];
        f.b[2 * jp][1] = r[1];
        f.b[2 * jp + 1][0] = r[2];
        f.b[2 * jp + 1][1] = r[3];
      }
    }
    // ldmatrix order: (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
#pragma unroll
    for (int i = 0; i < WarpTile<MT>::kM; ++i)
      if (w.has_m(i)) ldmatrix_x4(f.a[i], A + (16 * (w.mg + i * w.nmg) + lrow) * lda + ka + lcol);
  }
  static __device__ __forceinline__ void mma(float (&acc)[WarpTile<MT>::kM][4][4],
                                             const Frags<__nv_bfloat16, MT>& f,
                                             const WarpTile<MT>& w, int cols16) {
#pragma unroll
    for (int i = 0; i < WarpTile<MT>::kM; ++i) {
      if (!w.has_m(i)) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (w.has_n(j, cols16)) mma_bf16(acc[i][j], f.a[i], f.b[j][0], f.b[j][1]);
    }
  }
};

template <int MT>
struct Mma<float, MT> {
  static constexpr int kStep = 8;
  static __device__ __forceinline__ void load(Frags<float, MT>& f, const WarpTile<MT>& w,
                                              const float* A, int lda, int ka, const float* Wt,
                                              int ldw, int kb, int cols16) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int nbase = w.n0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (w.has_n(j, cols16)) {
        const float* p = Wt + (kb + t) * ldw + nbase + 8 * j + g;
        f.b[j][0] = p[0];
        f.b[j][1] = p[4 * ldw];
      }
    }
#pragma unroll
    for (int i = 0; i < WarpTile<MT>::kM; ++i) {
      if (!w.has_m(i)) continue;
      const float* p = A + (16 * (w.mg + i * w.nmg) + g) * lda + ka + t;
      f.a[i][0] = p[0];
      f.a[i][1] = p[8 * lda];
      f.a[i][2] = p[4];
      f.a[i][3] = p[8 * lda + 4];
    }
  }
  static __device__ __forceinline__ void mma(float (&acc)[WarpTile<MT>::kM][4][4], const Frags<float, MT>& f,
                                             const WarpTile<MT>& w, int cols16) {
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      split_tf32(f.b[j][0], bh[j][0], bl[j][0]);
      split_tf32(f.b[j][1], bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < WarpTile<MT>::kM; ++i) {
      if (!w.has_m(i)) continue;
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(f.a[i][e], ah[e], al[e]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (w.has_n(j, cols16)) {
          mma_tf32(acc[i][j], al, bh[j][0], bh[j][1]);
          mma_tf32(acc[i][j], ah, bl[j][0], bl[j][1]);
          mma_tf32(acc[i][j], ah, bh[j][0], bh[j][1]);
        }
      }
    }
  }
};

// acc += A (the block's rows, shared, lda; depth k0 .. k0+kt-1) x a weight
// tile (kt rows, ldw) for the warp's block of the output; n-tiles at or past
// cols16 are skipped. One fragment set: a second, loaded a step ahead, costs
// the registers (and at 128 a thread, spills) that the float32 split needs.
template <typename T, int MT>
__device__ __forceinline__ void tile_mma(float (&acc)[WarpTile<MT>::kM][4][4], const WarpTile<MT>& w,
                                         const T* A, int lda, int k0, const T* Wt, int ldw,
                                         int kt, int cols16) {
  constexpr int kS = Mma<T, MT>::kStep;
  Frags<T, MT> f;
  for (int kk = 0; kk < kt; kk += kS) {
    Mma<T, MT>::load(f, w, A, lda, k0 + kk, Wt, ldw, kk, cols16);
    Mma<T, MT>::mma(acc, f, w, cols16);
  }
}

template <int M>
__device__ __forceinline__ void zero(float (&acc)[M][4][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// ------------------------------------- online softmax on score fragments
// g = lane / 4, t = lane % 4. A score or output fragment (m16 x n8) holds
// rows g and g + 8 of the warp's 16, columns 2t and 2t + 1 of each 8-column
// tile.

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

// 2^x by the special-function unit (relative error about 2^-22; results
// below 2^-126 flush to 0, far below any weight that moves a float32 sum).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The chunk's scores u -> weights 2^(u c - m c), with the running max m and
// the lane's share of the running sum l of rows g and g + 8 brought up to
// date; alpha: the factor by which the rows' earlier o and l shrink (1 when
// m did not move). Every row of a chunk must hold a finite score.
template <int kNT>
__device__ __forceinline__ void softmax_chunk(float (&u)[kNT][4], float (&m)[2], float (&l)[2],
                                              float c, float (&alpha)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float cm = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) cm = fmaxf(cm, fmaxf(u[nt][2 * r], u[nt][2 * r + 1]));
    const float mn = fmaxf(m[r], quad_max(cm));
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

}  // namespace mma
