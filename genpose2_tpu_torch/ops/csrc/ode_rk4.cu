// The whole fixed-grid RK4 integration of the probability-flow ODE in one
// launch, with the score net folded (models/scorenet.py:fast_score_weights).
//
// Replaces: genpose2_tpu/ops/ode_rk4.py:fused_rk4_integrate (_kernel).
//
// Semantics, per step i with stage times j = (0, 1, 1, 2) and c = (0, .5, .5, 1):
//   xt  = x + c_s * h * k_{s-1}
//   pf  = relu(relu(xt W0 + b0) W1p + b1p)
//   hid = relu(pf Wpose + static + trow[i, j])
//   k_s = (hid W2 + b2) * q[i, j] + a[i, j] * xt
//   x   = x + h / 6 * (k0 + 2 k1 + 2 k2 + k3)
// trow, q, a and h come from ops/ode_rk4.py:_time_tables, computed in torch
// before the launch. Matmul operands are rounded to the compute type (f32 or
// bf16), sums are f32, and x and all glue stay f32, as in the TPU kernel.
//
// What bounds it on this card. One RK4 stage of one row is ~5.4e5 FLOP of
// products (D = 9, P1 = P2 = 256, H1 = 768): the benchmark's 6,400 rows x 500
// steps are 7e12 FLOP, 42 ms at 3xTF32's third of TF32's 495 TFLOP/s, 7 ms
// at the bf16 peak. The folded weights (1.085 MB in float32, 543 KB in bf16)
// do not fit in shared memory, so every block brings all of them in from L2
// in every stage. Measured on the H100 (PERF.md, section 6): with the
// design below that stream hides behind the float32 products (a variant
// that copies nothing runs as fast), and the products are what is left: a
// stage of 64 rows takes ~115 us, the same per row as at 32, ~17 cycles of
// an SM sub-partition per m16n8k8 TF32 mma.sync, about a quarter of the
// tensor cores' TF32 rate. bf16 at 64 rows is bound by the stream (a
// variant without products runs as fast).
//
// Design:
// - one round of blocks where the card allows (plan.cuh:rk4_plan): the
//   smallest multiple of 16 rows that puts every block on an SM at once, up
//   to 64; 6,400 rows make 100 blocks of 64, 3,200 rows 100 of 32, a
//   tracking call's 600 rows 38 of 16. Each SM brings the weights in once
//   per stage for all of its rows;
// - 8 consumer warps, each owning 32 columns of every row of a 256-column
//   chunk (mma.cuh's tiles, up to four 16-row m-tiles a warp: one B
//   fragment feeds them all), and one producer warp; 9 warps keep up to 168
//   registers a thread (a 17th warp beside 16 consumers would cap them at
//   96 and spill);
// - the producer walks the tile sequence of the whole integration and has
//   the TMA copy each tile into a ring of 2-4 shared-memory slots, each slot
//   with a full and an empty mbarrier: a tile of W0, W1 or Wpose is one box
//   of a 3-D tensor map, the matrix seen as (K, N / 8, 8) so that a box of
//   kt x 33 x 8 lands as kt rows of 264 elements, the padded rows that
//   mma.cuh's fragment loads read without bank conflicts (rows past K zero);
//   W2's rows of a chunk are one bulk copy. A consumer warp waits only on
//   the slot it reads and releases it when done; the warps meet at four
//   named barriers a stage, where one product's output is the next one's
//   input. The same warps staging each tile themselves with cp.async and a
//   barrier a tile (mma.cuh's Stream, as fused_sa.cu does) ran 1.2x slower
//   at the benchmark's 6,400 float32 rows and 1.7x at a tracking call's 600
//   (PERF.md, section 6);
// - the rows' state x, the stage input and the four slopes stay in shared
//   memory (float32) for the whole integration; products 1 and 2 write their
//   output as the next one's operand (P and Q alternate);
// - product 3 (pf Wpose) chunk by chunk; each warp's 32 columns of a chunk's
//   hid stay in registers and are the A operand of product 4 (hid W2, D <=
//   16 columns) over the warp's own 32 columns of depth, W2's rows of that
//   chunk read from the ring. A warp adds its partial slope chunk by chunk
//   in Q (free after product 2), and the 8 warps' partials are added in a
//   fixed order, so runs repeat. Only a 256-wide activation buffer is held,
//   so 64 float32 rows fit;
// - the products on the tensor cores (mma.cuh: bf16 mma.sync m16n8k16;
//   float32 3xTF32 on m16n8k8); product 3's sums start from the row's
//   static part;
// - widths that are not a multiple of 16 (D = 9) are zero-filled in the
//   operand buffers and by the TMA: the wrapper pads nothing. Every other
//   width is a multiple of 256 (the score net's are) and every weight's base
//   16-byte aligned (ops/ode_rk4.py copies one that is not); gp2_rk4 refuses
//   other widths, and a runtime without the tensor-map encoder, rather than
//   stage the weights another way.
// wgmma for the products (the float32 rate above) and a thread block cluster
// that multicasts each tile are not built.
#include <cuda.h>
#include <cudaTypedefs.h>

#include "mma.cuh"

namespace {

constexpr int kConsumers = kRk4Consumers;       // consumer warps, 32 columns of every row each
constexpr int kThreads = 32 * kConsumers;        // the consumer warps' threads
constexpr int kBlockThreads = kThreads + 32;     // and the producer warp

// A consumer warp's share of a 256-column chunk: 32 columns (four 8-column
// tiles) of all the block's rows (MT 16-row tiles), as mma.cuh's tile of
// 2 MT m-tiles with its groups set so that one warp holds them all.
template <int MT>
using Tile = mma::WarpTile<2 * MT>;
template <int MT>
__device__ __forceinline__ Tile<MT> warp_cols(int cols) {
  Tile<MT> w;
  w.n0 = 32 * (threadIdx.x >> 5);
  w.mg = 0;
  w.nmg = 1;
  w.active = w.n0 < cols;
  return w;
}

struct Params {
  const float* x0;     // (R, D)
  float* out;          // (R, D)
  const float* stat;   // (R, H1) pts-feature part of the heads' first layer
  const float* trows;  // (n, 3, H1) t-embedding through the heads' first layer
  const float* scal;   // (n, 7): h, q0, q1, q2, a0, a1, a2
  const void* w0;      // (D, P1)
  const float* b0;
  const void* w1;      // (P1, P2)
  const float* b1;
  const void* wp;      // (P2, H1)
  const void* w2;      // (H1, D)
  const float* b2;
  int R, D, P1, P2, H1, n;
  Rk4Plan plan;
  CUtensorMap maps[3];  // w0, w1, wp as (K, N / 8, 8) boxes of one tile (tile_map)
};

// ------------------------------------------------- the ring's mbarriers

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Arrive and expect `bytes` more of asynchronous copies in this phase.
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
// Wait until the phase of the given parity has completed. A wait past 10 s
// (a stage takes well under a millisecond) traps, so that a broken hand-off
// ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint64_t start = 0;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = global_ns();
    else if (global_ns() - start > 10000000000ull) __trap();
  }
}
// A box of a tensor map (coordinates innermost first) into shared memory
// (128-byte aligned), counted on bar when it lands; parts of the box outside
// the tensor land as zeros.
__device__ __forceinline__ void tensor_copy(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}
// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, counted on bar when they land.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// The consumer warps' barrier (the producer warp never waits on it).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// ------------------------------------------------------ the tile sequence

// A run of ring tiles: rows row0 .. row0+K-1 of columns col0 .. col0+cols-1
// of the row-major matrix W (ld elements a row), kt rows a tile. compact: W2's
// rows as they lie (cols == ld == D), one block a tile, read back with stride
// D; otherwise a tile is kt rows of tile_ld(cols) elements, rows past K zero.
struct Seg {
  const void* W;
  const CUtensorMap* map;
  int ld, row0, K, col0, cols, kt, nkt;
  bool compact;
};

// Run idx of a stage: product 1's column chunks, product 2's, then for each
// chunk c of H1 product 3's chunk c and W2's rows of that chunk. Every stage
// walks the same runs; the producer and the consumers both use this.
__device__ __forceinline__ int n_runs(const Params& P) {
  return n_chunks(P.P1) + n_chunks(P.P2) + 2 * n_chunks(P.H1);
}
__device__ __forceinline__ Seg run(const Params& P, int idx) {
  const int n1 = n_chunks(P.P1), n2 = n_chunks(P.P2);
  Seg g;
  g.row0 = 0;
  g.compact = false;
  if (idx < n1) {
    g.W = P.w0, g.ld = P.P1, g.K = P.D, g.col0 = idx * kChunkCols, g.cols = chunk_cols(P.P1, idx);
    g.map = &P.maps[0];
  } else if (idx < n1 + n2) {
    const int c = idx - n1;
    g.W = P.w1, g.ld = P.P2, g.K = P.P1, g.col0 = c * kChunkCols, g.cols = chunk_cols(P.P2, c);
    g.map = &P.maps[1];
  } else {
    const int c = (idx - n1 - n2) / 2;
    if ((idx - n1 - n2) % 2 == 0) {
      g.W = P.wp, g.ld = P.H1, g.K = P.P2, g.col0 = c * kChunkCols, g.cols = chunk_cols(P.H1, c);
      g.map = &P.maps[2];
    } else {
      g.W = P.w2, g.ld = P.D, g.row0 = c * kChunkCols, g.K = chunk_cols(P.H1, c), g.col0 = 0;
      g.cols = P.D, g.kt = g.K, g.nkt = 1, g.compact = true;
      g.map = nullptr;
      return g;
    }
  }
  g.kt = tile_rows(g.K, g.cols, P.plan.ring_elems);
  g.nkt = n_ktiles(g.K, g.cols, P.plan.ring_elems);
  return g;
}

// The producer warp's lane 0: tile t of run g into dst by the TMA, counted on
// the slot's full barrier (one arrival, with the bytes of the copy). W2's
// rows of a chunk as one block; a tile of the other matrices as one box of
// their tensor map, kt rows of 264 columns (rows past K and columns past N
// zero), the layout mma.cuh reads.
template <typename T>
__device__ __forceinline__ void stage_tile(const Seg& g, int t, T* dst, uint32_t full) {
  const int k0 = t * g.kt;
  if (g.compact) {
    const uint32_t bytes = min(g.kt, g.K - k0) * g.cols * sizeof(T);
    mbar_arrive_tx(full, bytes);
    bulk_copy(mma::smem_addr(dst),
              static_cast<const T*>(g.W) + static_cast<size_t>(g.row0 + k0) * g.ld, bytes, full);
  } else {
    mbar_arrive_tx(full, tile_ld(kChunkCols) * g.kt * sizeof(T));
    tensor_copy(mma::smem_addr(dst), g.map, 0, g.col0 / 8, k0, full);
  }
}

// The consumers' view of the ring: wait for the next tile's slot to fill,
// release it when the warp is done with it. Every consumer warp walks every
// tile, whether or not it reads it.
template <typename T>
struct Ring {
  const T* base;
  int elems, nbuf;
  uint32_t bars;  // full[0 .. nbuf), then empty[0 .. nbuf)
  int slot;
  uint32_t phase;

  __device__ __forceinline__ const T* wait() {
    mbar_wait(bars + 8 * slot, phase);
    return base + slot * elems;
  }
  __device__ __forceinline__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(bars + 8 * (nbuf + slot));
    if (++slot == nbuf) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// ---------------------------------------------------------- the products

// Products 1 and 2: A (the block's rows, depth K, stride lda) times the runs
// seg0 .. seg0+nch-1, relu(. + bias) into out (stride ldo); columns past N
// hold zeros (the next product's padded depth).
template <typename T, int MT>
__device__ __forceinline__ void product(const Params& P, int seg0, int nch, const T* A, int lda,
                                        int K, const float* bias, int N, T* out, int ldo,
                                        Ring<T>& ring) {
  const int lane = threadIdx.x & 31, K16 = round_up(K, 16);
  for (int c = 0; c < nch; ++c) {
    const Seg g = run(P, seg0 + c);
    const int cols16 = round_up(g.cols, 16), ldw = tile_ld(g.cols);
    const Tile<MT> wt = warp_cols<MT>(g.cols);
    const int n0 = g.col0 + wt.n0 + 2 * (lane & 3);  // + 8 jj + (e & 1)
    const int rw = lane >> 2;                         // + 16 i + 8 (e >> 1)
    // each column's bias, loaded before the products so that its latency
    // hides behind them
    float colv[4][2];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int o = n0 + 8 * jj + u;
        colv[jj][u] = wt.active && o < N ? bias[o] : 0.f;
      }
    float acc[MT][4][4];
    mma::zero(acc);
    for (int ti = 0; ti < g.nkt; ++ti) {
      const int k0 = ti * g.kt;
      const T* Wt = ring.wait();
      if (wt.active)
        mma::tile_mma<T, 2 * MT>(acc, wt, A, lda, k0, Wt, ldw, min(g.kt, K16 - k0), cols16);
      ring.release();
    }
    if (!wt.active) continue;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (!wt.has_n(jj, cols16)) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = n0 + 8 * jj + (e & 1), r = rw + 16 * i + 8 * (e >> 1);
          const float v = fmaxf(acc[i][jj][e] + colv[jj][e & 1], 0.f);
          out[r * ldo + o] = from_f32<T>(o < N ? v : 0.f);
        }
      }
    }
  }
}

// Product 4 on one chunk: acc4 (the block's rows x the two 8-column tiles of
// the slope) = hid (the warp's 32 columns of the chunk, in registers as
// product 3 left them) x W2's rows of those columns (W2t: the chunk's `rows`
// rows, stride D). A C fragment holds columns 2t and 2t + 1 of each 8-column
// tile: float32 takes them as depth t and t + 4 of one m16n8k8 step (W2's
// rows in the same order), bf16 two tiles as one m16n8k16 step.
template <int MT>
__device__ __forceinline__ void heads_out(float (&acc4)[MT][2][4], const float (&hid)[MT][4][4],
                                          const Tile<MT>& wt, const float* W2t, int D, int rows,
                                          int cols16) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    if (!wt.has_n(jj, cols16)) continue;
    const int k = wt.n0 + 8 * jj + 2 * t;  // W2's row of depth t (k + 1: t + 4)
    uint32_t bh[2][2], bl[2][2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int n = 8 * u + g;
      const float b0 = n < D && k < rows ? W2t[k * D + n] : 0.f;
      const float b1 = n < D && k + 1 < rows ? W2t[(k + 1) * D + n] : 0.f;
      mma::split_tf32(b0, bh[u][0], bl[u][0]);
      mma::split_tf32(b1, bh[u][1], bl[u][1]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      uint32_t ah[4], al[4];
      mma::split_tf32(hid[i][jj][0], ah[0], al[0]);  // row g, depth t
      mma::split_tf32(hid[i][jj][2], ah[1], al[1]);  // row g + 8, depth t
      mma::split_tf32(hid[i][jj][1], ah[2], al[2]);  // row g, depth t + 4
      mma::split_tf32(hid[i][jj][3], ah[3], al[3]);  // row g + 8, depth t + 4
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (8 * u >= D) continue;
        mma::mma_tf32(acc4[i][u], al, bh[u][0], bh[u][1]);
        mma::mma_tf32(acc4[i][u], ah, bl[u][0], bl[u][1]);
        mma::mma_tf32(acc4[i][u], ah, bh[u][0], bh[u][1]);
      }
    }
  }
}
__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16 | __bfloat16_as_ushort(lo);
}
template <int MT>
__device__ __forceinline__ void heads_out(float (&acc4)[MT][2][4], const float (&hid)[MT][4][4],
                                          const Tile<MT>& wt, const __nv_bfloat16* W2t, int D,
                                          int rows, int cols16) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const __nv_bfloat16 z = __float2bfloat16_rn(0.f);
#pragma unroll
  for (int jj = 0; jj < 4; jj += 2) {
    if (!wt.has_n(jj, cols16)) continue;
    const int k = wt.n0 + 8 * jj + 2 * t;  // depth 2t, 2t + 1, 2t + 8, 2t + 9
    uint32_t b[2][2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int n = 8 * u + g;
      __nv_bfloat16 w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kq = k + (q & 1) + 8 * (q >> 1);
        w[q] = n < D && kq < rows ? W2t[kq * D + n] : z;
      }
      b[u][0] = pack_raw(w[0], w[1]);
      b[u][1] = pack_raw(w[2], w[3]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const uint32_t a[4] = {mma::pack_bf16(hid[i][jj][0], hid[i][jj][1]),
                             mma::pack_bf16(hid[i][jj][2], hid[i][jj][3]),
                             mma::pack_bf16(hid[i][jj + 1][0], hid[i][jj + 1][1]),
                             mma::pack_bf16(hid[i][jj + 1][2], hid[i][jj + 1][3])};
#pragma unroll
      for (int u = 0; u < 2; ++u)
        if (8 * u < D) mma::mma_bf16(acc4[i][u], a, b[u][0], b[u][1]);
    }
  }
}

// Products 3 and 4 of a stage: for each 256-column chunk of H1, hid = relu(pf
// Wpose + static + trow) in registers, then its share of the slope, added to
// the warp's partial slope in `part` (the warp's rows x 16 f32, chunk by
// chunk in order).
template <typename T, int MT>
__device__ __forceinline__ void heads(const Params& P, int seg0, const T* A, int lda,
                                      const float* trow, int r0, float* part, Ring<T>& ring) {
  const int lane = threadIdx.x & 31, H1 = P.H1, K16 = round_up(P.P2, 16);
  const int rw = lane >> 2, t = lane & 3;
  for (int c = 0; c < n_chunks(H1); ++c) {
    const Seg g = run(P, seg0 + 2 * c);
    const int cols16 = round_up(g.cols, 16), ldw = tile_ld(g.cols);
    const Tile<MT> wt = warp_cols<MT>(g.cols);
    const int n0 = g.col0 + wt.n0 + 2 * t;
    float colv[4][2];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int o = n0 + 8 * jj + u;
        colv[jj][u] = wt.active && o < H1 ? trow[o] : 0.f;
      }
    // the sums start from each element's static part
    float acc[MT][4][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = n0 + 8 * jj + (e & 1), r = r0 + rw + 16 * i + 8 * (e >> 1);
          acc[i][jj][e] = wt.active && wt.has_n(jj, cols16) && o < H1 && r < P.R
                              ? P.stat[static_cast<size_t>(r) * H1 + o]
                              : 0.f;
        }
    for (int ti = 0; ti < g.nkt; ++ti) {
      const int k0 = ti * g.kt;
      const T* Wt = ring.wait();
      if (wt.active)
        mma::tile_mma<T, 2 * MT>(acc, wt, A, lda, k0, Wt, ldw, min(g.kt, K16 - k0), cols16);
      ring.release();
    }
    // hid: columns past H1 hold zeros
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = n0 + 8 * jj + (e & 1);
          acc[i][jj][e] = o < H1 ? fmaxf(acc[i][jj][e] + colv[jj][e & 1], 0.f) : 0.f;
        }
    float acc4[MT][2][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc4[i][u][e] = 0.f;
    const Seg g2 = run(P, seg0 + 2 * c + 1);
    const T* W2t = ring.wait();
    if (wt.active) heads_out<MT>(acc4, acc, wt, W2t, P.D, g2.K, cols16);
    ring.release();
    // the warp's partial slope: row, slope column (each lane its own elements)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& v = part[(16 * i + rw + 8 * (e >> 1)) * 16 + 8 * u + 2 * t + (e & 1)];
          v = c == 0 ? acc4[i][u][e] : v + acc4[i][u][e];
        }
  }
}

// ------------------------------------------------------------ the kernel

template <typename T>
__device__ void produce(const Params& P, T* ring, uint32_t bars, int lane) {
  const Rk4Plan& pl = P.plan;
  const int nseg = n_runs(P);
  int slot = 0;
  uint32_t phase = 0;
  for (int it = 0; it < 4 * P.n; ++it)
    for (int sg = 0; sg < nseg; ++sg) {
      const Seg g = run(P, sg);
      for (int t = 0; t < g.nkt; ++t) {
        mbar_wait(bars + 8 * (pl.nbuf + slot), phase ^ 1);  // the slot's last use released
        if (lane == 0) stage_tile(g, t, ring + slot * pl.ring_elems, bars + 8 * slot);
        if (++slot == pl.nbuf) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
}

template <typename T, int MT>
__global__ void __launch_bounds__(kBlockThreads, 1) rk4_kernel(const __grid_constant__ Params P) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kRows = 16 * MT;
  const Rk4Plan& pl = P.plan;
  const int D = P.D, dp = pl.dpad, ldp = pl.ldp, ldq = pl.ldq;
  float* X = reinterpret_cast<float*>(smem + pl.off_state);  // x
  float* XT = X + kRows * dp;                                // stage input, f32
  float* KS = XT + kRows * dp;                               // the four slopes
  T* Pb = reinterpret_cast<T*>(smem + pl.off_p);  // xt operand, then pf
  T* Qb = reinterpret_cast<T*>(smem + pl.off_q);  // relu(xt W0 + b0), then the partial slopes
  float* parts = reinterpret_cast<float*>(smem + pl.off_q);  // a warp's: kRows x 16
  T* ring = reinterpret_cast<T*>(smem + pl.off_ring);
  const uint32_t bars = mma::smem_addr(smem + pl.off_bar);
  const int r0 = blockIdx.x * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    for (int b = 0; b < pl.nbuf; ++b) {
      mbar_init(bars + 8 * b, 1);
      mbar_init(bars + 8 * (pl.nbuf + b), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // x, and the first stage's input: x itself; operand columns D..15 zero
  for (int e = threadIdx.x; e < kRows * 16; e += blockDim.x) {
    const int r = e / 16, d = e % 16;
    float x = 0.f;
    if (d < D) {
      x = r0 + r < P.R ? P.x0[static_cast<size_t>(r0 + r) * D + d] : 0.f;
      X[r * dp + d] = x;
      XT[r * dp + d] = x;
    }
    Pb[r * ldp + d] = from_f32<T>(x);
  }
  __syncthreads();
  if (warp == kConsumers) {
    produce<T>(P, ring, bars, lane);
    return;
  }

  Ring<T> rg = {ring, pl.ring_elems, pl.nbuf, bars, 0, 0};
  const int n1 = n_chunks(P.P1), n2 = n_chunks(P.P2);
  const int stage_j[4] = {0, 1, 1, 2};
  const float stage_c[4] = {0.f, 0.5f, 0.5f, 1.f};
  for (int i = 0; i < P.n; ++i) {
    const float* sc = P.scal + 7 * i;
    const float h = sc[0];
    for (int s = 0; s < 4; ++s) {
      const int j = stage_j[s];
      consumer_sync();  // the stage input written, the partial slopes read
      // products 1-2: xt -> Q, Q -> P
      product<T, MT>(P, 0, n1, Pb, ldp, D, P.b0, P.P1, Qb, ldq, rg);
      consumer_sync();
      product<T, MT>(P, n1, n2, Qb, ldq, P.P1, P.b1, P.P2, Pb, ldp, rg);
      consumer_sync();
      // products 3-4: pf -> the warp's partial slope, in Q (free since
      // product 2)
      heads<T, MT>(P, n1 + n2, Pb, ldp, P.trows + (static_cast<size_t>(i) * 3 + j) * P.H1, r0,
                   parts + warp * kRows * 16, rg);
      consumer_sync();
      // the slope from the partials, added in a fixed order; then the next
      // stage's input (after the fourth stage, the step's update of x). Each
      // thread keeps its elements from stage to stage.
      const float q = sc[1 + j], a = sc[4 + j];
      const float cn = s < 3 ? stage_c[s + 1] * h : 0.f, h6 = h / 6.f;
      const bool out = i == P.n - 1 && s == 3;
      for (int e = threadIdx.x; e < kRows * 16; e += kThreads) {
        const int r = e / 16, d = e % 16;
        float xt = 0.f;
        if (d < D) {
          float sum = 0.f;
          for (int w = 0; w < kConsumers; ++w) sum += parts[(w * kRows + r) * 16 + d];
          const int k = r * dp + d, qs = kRows * dp;
          const float ks = (sum + P.b2[d]) * q + a * XT[k];
          KS[s * qs + k] = ks;
          if (s < 3) {
            xt = X[k] + cn * ks;
          } else {
            xt = X[k] + h6 * (((KS[k] + 2.f * KS[qs + k]) + 2.f * KS[2 * qs + k]) + ks);
            X[k] = xt;
            if (out && r0 + r < P.R) P.out[static_cast<size_t>(r0 + r) * D + d] = xt;
          }
          XT[k] = xt;
        }
        Pb[r * ldp + d] = from_f32<T>(xt);
      }
    }
  }
  if (P.n == 0)
    for (int e = threadIdx.x; e < kRows * D; e += kThreads) {
      const int r = e / D, d = e % D;
      if (r0 + r < P.R) P.out[static_cast<size_t>(r0 + r) * D + d] = X[r * dp + d];
    }
}

template <typename T, int MT>
cudaError_t launch_typed(const Params& P, cudaStream_t st) {
  cudaError_t err = allow_smem(rk4_kernel<T, MT>, P.plan.smem_bytes);
  if (err != cudaSuccess) return err;
  const int grid = (P.R + 16 * MT - 1) / (16 * MT);
  rk4_kernel<T, MT><<<grid, kBlockThreads, P.plan.smem_bytes, st>>>(P);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rows(const Params& P, cudaStream_t st) {
  switch (P.plan.rows) {
    case 16: return launch_typed<T, 1>(P, st);
    case 32: return launch_typed<T, 2>(P, st);
    case 48: return launch_typed<T, 3>(P, st);
    default: return launch_typed<T, 4>(P, st);
  }
}

using Encode = PFN_cuTensorMapEncodeTiled_v12000;

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime
// (nothing links libcuda), or null.
Encode tensor_map_encoder() {
  static Encode fn = nullptr;
  static bool looked = false;
  if (!looked) {
    looked = true;
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<Encode>(p);
  }
  return fn;
}

// The tensor map of a row-major (K, N) matrix whose box is one ring tile: the
// matrix seen as (K, N / 8, 8), a box of kt x 33 x 8 = kt rows of 264
// elements (a 256-column chunk and 8 columns past it, the padded rows of
// tile_ld). N is a multiple of 256 and W 16-byte aligned (gp2_rk4).
CUresult tile_map(Encode enc, CUtensorMap* m, const void* W, int K, int N, int kt, int bf16) {
  const cuuint64_t es = bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {8, static_cast<cuuint64_t>(N / 8), static_cast<cuuint64_t>(K)};
  const cuuint64_t strides[2] = {8 * es, N * es};
  const cuuint32_t box[3] = {8, static_cast<cuuint32_t>(tile_ld(kChunkCols) / 8),
                             static_cast<cuuint32_t>(kt)};
  const cuuint32_t steps[3] = {1, 1, 1};
  return enc(m, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
             const_cast<void*>(W), dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// One integration with a given plan: the tensor maps, then the launch. A
// runtime without the encoder, a weight base off 16 bytes or a map the
// driver refuses is an error.
cudaError_t launch_plan(Params& P, int bf16, cudaStream_t st) {
  const Encode enc = tensor_map_encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  const void* const weights[4] = {P.w0, P.w1, P.wp, P.w2};
  for (const void* W : weights)
    if (reinterpret_cast<size_t>(W) % 16 != 0) return cudaErrorMisalignedAddress;
  const int re = P.plan.ring_elems;
  if (tile_map(enc, &P.maps[0], P.w0, P.D, P.P1, tile_rows(P.D, kChunkCols, re), bf16) ||
      tile_map(enc, &P.maps[1], P.w1, P.P1, P.P2, tile_rows(P.P1, kChunkCols, re), bf16) ||
      tile_map(enc, &P.maps[2], P.wp, P.P2, P.H1, tile_rows(P.P2, kChunkCols, re), bf16))
    return cudaErrorInvalidValue;
  return bf16 ? launch_rows<__nv_bfloat16>(P, st) : launch_rows<float>(P, st);
}

}  // namespace

// One fused integration; see Params for the layouts. bf16 != 0: the four
// weight matrices are bf16, otherwise f32. rounds (may be null): the rounds
// of blocks the launch takes on the card. Returns a CUDA error code, or -1
// for shapes the kernel does not take (D above 16, P1, P2 or H1 not a
// multiple of 256, H1 above 2,048).
extern "C" int gp2_rk4(const float* x0, float* out, const float* stat, const float* trows,
                       const float* scal, const void* w0, const float* b0, const void* w1,
                       const float* b1, const void* wp, const void* w2, const float* b2,
                       int R, int D, int P1, int P2, int H1, int n, int bf16, void* stream,
                       int* rounds) {
  Params P = {x0, out, stat, trows, scal, w0, b0, w1, b1, wp, w2, b2, R, D, P1, P2, H1, n};
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rk4_plan(R, D, P1, P2, H1, bf16, sms, &P.plan) != 0) return -1;
  if (rounds != nullptr) *rounds = P.plan.rounds;
  return static_cast<int>(launch_plan(P, bf16, static_cast<cudaStream_t>(stream)));
}
