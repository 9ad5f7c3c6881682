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
// steps are 7e12 FLOP, 14 ms at TF32's 495 TFLOP/s, 42 ms at 3xTF32's third
// of it, 7 ms at the bf16 peak. The folded weights (1.085 MB in float32, 543
// KB in bf16) do not fit in shared memory, so every block brings all of them
// in from L2 in every stage. Measured on the H100 (PERF.md, section 6): the
// float32 route below (6,400 x 500 in 80-82 ms, 2.8x the mma.sync route) is
// bound by neither the stream nor the products (a variant that copies no
// weights, and one without products, each run within 5% of it) but by the
// consumers' own instructions around them (the fragments' loads and
// splits, the epilogues, the waits); bf16 by the stream (a variant without
// products runs as fast). A cluster of two blocks sharing each tile by TMA
// multicast, each consumer warp releasing slots in both, ran 2.8x slower.
//
// Both routes (plan.cuh:rk4_route: float32 on wgmma, bf16 on mma.sync):
// - one round of blocks where the card allows: each SM brings the weights
//   in once per stage for all of its rows;
// - one producer warp walks the tile sequence of the whole integration and
//   has the TMA copy each tile into a ring of 2-4 shared-memory slots, each
//   slot with a full and an empty mbarrier: a tile of W0, W1 or Wpose is one
//   box of a 3-D tensor map, the matrix seen as (K, N / 8, 8) so that a box of
//   kt x 33 x 8 lands as kt rows of 264 elements, padded rows that a warp's
//   fragment loads read without bank conflicts (rows past K zero); W2's rows
//   of a chunk are one bulk copy. A consumer warp waits only on the slot it
//   reads and releases it when done; the consumers meet at named barriers
//   where one product's output is the next one's input. The same warps
//   staging each tile themselves with cp.async and a barrier a tile (mma.cuh's
//   Stream, as fused_sa.cu does) ran 1.2x slower (PERF.md, section 6);
// - the rows' state x, the stage input and the four slopes stay in shared
//   memory (float32) for the whole integration, and each warp's partial
//   slopes are added in a fixed order, so runs repeat bit for bit;
// - widths that are not a multiple of 16 (D = 9) are zero-filled in the
//   operand buffers and by the TMA: the wrapper pads nothing. Every other
//   width is a multiple of 256 (the score net's are) and every weight's base
//   16-byte aligned (ops/ode_rk4.py copies one that is not); gp2_rk4 refuses
//   other widths, and a runtime without the tensor-map encoder, rather than
//   stage the weights another way.
//
// The wgmma route (namespace wg; float32, P1 = P2 = 256): blocks of 16-64
// rows, a multiple of 8 (6,400 rows: 115 blocks of 56; 3,200: 100 of 32),
// two consumer warpgroups and a producer warpgroup (one warp of it works;
// setmaxnreg moves its registers to the consumers). TF32 wgmma reads its B
// operand only K-major, and the weights land (depth, columns); so each
// product runs transposed, out^T = W^T act^T: the weights are the A operand
// from registers (a warp loads its fragments from the ring slot and splits
// them into TF32 parts), the activations the B operand (N = the block's
// rows), written by the epilogues already split, as two K-major operands in
// the 128-byte swizzle. Each warpgroup owns 128 columns of every 256-column
// chunk (two m64 tiles). 3xTF32 as on mma.sync: w_lo act_hi + w_hi act_lo +
// w_hi act_hi into one float32 accumulator. Product 3's accumulator (hid^T,
// a column on each lane group) is transposed 8 x 8 in registers by
// movmatrix into mma.sync's A layout, and product 4 (hid W2: N = D <= 16,
// below wgmma's M of 64) runs there on mma.sync, each warp over its own
// columns of hid, into partial slopes held in registers across the chunks.
// The ring's slots hold 16 weight rows (three slots: 2.5% faster than two);
// a slot is released once a warp's fragments are in registers.
//
// The mma.sync route (rk4_kernel<__nv_bfloat16, MT>; it ran float32 too, as
// 3xTF32 on m16n8k8, until the wgmma route took it at every shape at 2.0-2.8x
// its speed): the smallest multiple of 16 rows that puts every block on an
// SM at once, up to 64; 8 consumer warps, each owning 32 columns of every
// row of a 256-column chunk (mma.cuh's m16n8k16 tiles), and the producer warp; 9
// warps keep up to 168 registers a thread. Products 1 and 2 write their
// output as the next one's operand (P and Q alternate); product 3 chunk by
// chunk, each warp's 32 columns of hid in registers as the A operand of
// product 4 over the warp's own 32 columns of depth; its partial slope added
// chunk by chunk in Q.
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
// tile: two tiles make one m16n8k16 step.
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

// ------------------------------------------------- float32 by wgmma (TF32)
//
// Each product runs transposed: out^T (64 output columns x the block's rows)
// = W^T (64 x 8, the A operand, from registers) . act^T (8 x rows, the B
// operand, from shared memory), wgmma.m64nNk8 with N = the block's rows.
// TF32 wgmma reads B only K-major, and the activations are (rows, depth)
// with the depth contiguous; the weights land from the TMA (depth, columns)
// as they lie in device memory, and a warp loads its A fragments from there
// (ld 264: conflict-free) and splits them into TF32 parts in registers. The
// activations are written by the epilogues already split, as two K-major
// operands (plan.cuh: rk4_wgmma_layout). 3xTF32 as on mma.sync: w_lo act_hi
// + w_hi act_lo + w_hi act_hi into one float32 accumulator.
namespace wg {

constexpr int kWgThreads = kThreads + 128;  // two consumer warpgroups and the producer's
constexpr int kKt = 16;  // weight rows of a ring slot (plan.cuh: kRingBytes / 2)
constexpr int kLdw = 264;  // a slot's row stride (tile_ld(kChunkCols))

// The float offset of (row r, depth k) in a K-major operand of nr rows:
// panels of kRk4Panel depths, each nr rows of 128 bytes whose 16-byte
// chunks are swizzled by the row (the 128-byte swizzle wgmma reads).
__device__ __forceinline__ int kmajor(int nr, int r, int k) {
  return (k >> 5) * nr * kRk4Panel + r * kRk4Panel + ((((k >> 2) & 7) ^ (r & 7)) << 2) + (k & 3);
}
// The wgmma descriptor of depths k .. k+7 of a K-major operand of nr rows at
// shared address base (1,024-byte aligned): 128-byte swizzle, 8-row groups
// 1,024 bytes apart.
__device__ __forceinline__ uint64_t desc(uint32_t base, int nr, int k) {
  const uint64_t addr = base + 4u * ((k >> 5) * nr * kRk4Panel + (k & 31));
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Accesses by the generic proxy ordered before later ones by the async
// proxy: writes that wgmma reads, reads of a ring slot that the TMA refills;
// a barrier (an mbarrier arrive) follows.
__device__ __forceinline__ void fence_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Pin registers around the asynchronous products, so that the compiler
// moves no other access to them across the products' fence, commit and
// wait; and a slot's fragments before the slot is released (their loads
// done).
template <int K>
__device__ __forceinline__ void pin(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int M>
__device__ __forceinline__ void pin(float (&d)[M][2][4]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int u = 0; u < 2; ++u) pin(d[m][u]);
}
template <int K>
__device__ __forceinline__ void pin(uint32_t (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 output columns x N rows: this warp's 16 columns) += a (64 x 8,
// registers: columns g and g + 8, depths t and t + 4) . B (8 x N, K-major).
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc);
template <>
__device__ __forceinline__ void wgmma<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7"
      "}, {%8,%9,%10,%11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma<24>(float (&d)[12], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11"
      "}, {%12,%13,%14,%15}, %16, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15"
      "}, {%16,%17,%18,%19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma<40>(float (&d)[20], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19"
      "}, {%20,%21,%22,%23}, %24, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma<48>(float (&d)[24], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23"
      "}, {%24,%25,%26,%27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma<56>(float (&d)[28], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27"
      "}, {%28,%29,%30,%31}, %32, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, {%32,%33,%34,%35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// The consumers' side of the ring (Ring's wait and release) with no branch
// that the compiler sees: the spin loop inside one asm statement, the
// arrive predicated. A branch that may diverge inside a warpgroup while its
// wgmmas are in flight makes ptxas serialise them (C7520). A wait past 10 s
// traps, as mbar_wait does.
__device__ __forceinline__ const float* ring_wait(const Ring<float>& r) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u64 t0, t1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n@p bra DONE;\n"
      "mov.u64 t0, %%globaltimer;\n"
      "WAIT:\nmbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n@p bra DONE;\n"
      "mov.u64 t1, %%globaltimer;\nsub.u64 t1, t1, t0;\nsetp.gt.u64 p, t1, 10000000000;\n"
      "@p trap;\nbra WAIT;\nDONE:\n}\n" ::"r"(r.bars + 8 * r.slot),
      "r"(r.phase)
      : "memory");
  return r.base + r.slot * r.elems;
}
__device__ __forceinline__ void ring_release(Ring<float>& r) {
  __syncwarp();
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, %1, 0;\n@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
          r.bars + 8 * (r.nbuf + r.slot)),
      "r"(threadIdx.x & 31)
      : "memory");
  r.slot = r.slot + 1 == r.nbuf ? 0 : r.slot + 1;
  r.phase ^= r.slot == 0 ? 1u : 0u;
}

// A warp's A operands from one ring slot: depth steps s (8 rows each) of its
// columns col + 64 mt + (g, g + 8), mt = 0, 1, split into TF32 parts.
struct Frags {
  uint32_t hi[2][2][4], lo[2][2][4];
};
__device__ __forceinline__ void pin(Frags& f) {
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      pin(f.hi[s][mt]);
      pin(f.lo[s][mt]);
    }
}
__device__ __forceinline__ void load(Frags& f, const float* W, int col) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float* w = W + (8 * s + t) * kLdw + col + 64 * mt + g;
      const float v[4] = {w[0], w[8], w[4 * kLdw], w[4 * kLdw + 8]};
#pragma unroll
      for (int e = 0; e < 4; ++e) mma::split_tf32(v[e], f.hi[s][mt][e], f.lo[s][mt][e]);
    }
}
// The products of one slot (depths k0 .. k0 + 15 of the operand at bhi /
// blo), one commit group.
template <int NR>
__device__ __forceinline__ void slot_products(float (&acc)[2][NR / 2], const Frags& f,
                                              uint32_t bhi, uint32_t blo, int k0) {
  pin(acc[0]);
  pin(acc[1]);
  fence();
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const uint64_t dh = desc(bhi, NR, k0 + 8 * s), dl = desc(blo, NR, k0 + 8 * s);
      wgmma<NR>(acc[mt], f.lo[s][mt], dh);
      wgmma<NR>(acc[mt], f.hi[s][mt], dl);
      wgmma<NR>(acc[mt], f.hi[s][mt], dh);
    }
  commit();
  pin(acc[0]);
  pin(acc[1]);
}

// acc (+)= the warp's columns of one column chunk over nkt ring slots, the
// operand's depth 16 a slot. A slot is released once its fragments are in
// registers, after a proxy fence: the warp's loads of it (generic proxy)
// must be done before the TMA (async proxy) writes the next tile there;
// without the fence 3 of 200 launches at 6,400 x 500 differed in their last
// bits. Its products are waited for before the next slot's fragments load,
// so that no register an asynchronous product reads or writes is live
// across anything else (the other warpgroup's products keep the tensor
// cores busy meanwhile). Overlapping the next slot's loads with this one's
// products, in a second set of registers, ran 6% slower at 6,400 rows
// (spills; PERF.md, section 6).
template <int NR>
__device__ __forceinline__ void gemm(float (&acc)[2][NR / 2], Ring<float>& ring, int nkt, int col,
                                     uint32_t bhi, uint32_t blo) {
  for (int ti = 0; ti < nkt; ++ti) {
    Frags f;
    load(f, ring_wait(ring), col);
    pin(f);
    fence_proxy();
    ring_release(ring);
    slot_products<NR>(acc, f, bhi, blo, kKt * ti);
    wait_all();
    pin(f);
    pin(acc[0]);
    pin(acc[1]);
  }
}

// The accumulator's element e of 8-row group j: block row 8 j + 2 t + e % 2,
// output column col + 64 mt + g + 8 (e / 2).
// relu(acc + bias) as the next product's operand, both TF32 parts.
template <int NR>
__device__ __forceinline__ void store_act(const float (&acc)[2][NR / 2], const float (&bias)[2][2],
                                          float* hi, float* lo, int col) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < NR / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = kmajor(NR, 8 * j + 2 * t + (e & 1), col + 64 * mt + g + 8 * (e >> 1));
        uint32_t h, l;
        mma::split_tf32(fmaxf(acc[mt][4 * j + e] + bias[mt][e >> 1], 0.f), h, l);
        hi[o] = __uint_as_float(h);
        lo[o] = __uint_as_float(l);
      }
}

__device__ __forceinline__ uint32_t movtrans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}
// An 8 x 8 float32 tile whose row g the lanes 4 g .. 4 g + 3 hold as
// columns (2 t, 2 t + 1), transposed in place across the warp: its 16-bit
// halves by movmatrix.
__device__ __forceinline__ void transpose(float& x0, float& x1) {
  const uint32_t a = __float_as_uint(x0), b = __float_as_uint(x1);
  const uint32_t hi = movtrans(__byte_perm(a, b, 0x7632)), lo = movtrans(__byte_perm(a, b, 0x5410));
  x0 = __uint_as_float(__byte_perm(lo, hi, 0x5410));
  x1 = __uint_as_float(__byte_perm(lo, hi, 0x7632));
}

// Product 4 on one chunk, on mma.sync (its N, the slope's D <= 16 columns,
// is below wgmma's M of 64): hid = relu(acc + trow), the warp's 32 columns
// of the chunk as product 3 left them (transposed: a column on g), is
// transposed 8 x 8 tile by tile into mma.sync's A layout (a block row on g,
// columns 2 t and 2 t + 1 as depth t and t + 4, W2's rows in the same
// order), times W2's rows of those columns (W2t: the chunk's rows, stride
// D), into acc4 (the block's rows in 16-row tiles x 16 slope columns).
template <int NR, int MT>
__device__ __forceinline__ void heads_out(float (&acc4)[MT][2][4], float (&hid)[2][NR / 2],
                                          const float (&tv)[2][2], const float* W2t, int D,
                                          int col) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < NR / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float& x0 = hid[mt][4 * j + 2 * hh];
        float& x1 = hid[mt][4 * j + 2 * hh + 1];
        x0 = fmaxf(x0 + tv[mt][hh], 0.f);
        x1 = fmaxf(x1 + tv[mt][hh], 0.f);
        transpose(x0, x1);
      }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int k = col + 64 * mt + 8 * hh + 2 * t;  // W2's row of depth t (k + 1: t + 4)
      uint32_t bh[2][2], bl[2][2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int n = 8 * u + g;
        mma::split_tf32(n < D ? W2t[k * D + n] : 0.f, bh[u][0], bl[u][0]);
        mma::split_tf32(n < D ? W2t[(k + 1) * D + n] : 0.f, bh[u][1], bl[u][1]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int j0 = 2 * i, j1 = 2 * i + 1;  // rows 16 i + g, 16 i + 8 + g
        const float a[4] = {hid[mt][4 * j0 + 2 * hh], j1 < NR / 8 ? hid[mt][4 * j1 + 2 * hh] : 0.f,
                            hid[mt][4 * j0 + 2 * hh + 1],
                            j1 < NR / 8 ? hid[mt][4 * j1 + 2 * hh + 1] : 0.f};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) mma::split_tf32(a[e], ah[e], al[e]);
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

template <int NR>
__device__ __forceinline__ void zero(float (&acc)[2][NR / 2]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int e = 0; e < NR / 2; ++e) acc[mt][e] = 0.f;
}

// The consumer warpgroups' part of rk4_kernel<NR>.
template <int NR>
__device__ __forceinline__ void consume(const Params& P, unsigned char* smem, int r0) {
  constexpr int kMT = (NR + 15) / 16;
  const Rk4Plan& pl = P.plan;
  const int D = P.D, dp = pl.dpad, H1 = P.H1;
  float* AH = reinterpret_cast<float*>(smem + pl.off_p);
  float* AL = reinterpret_cast<float*>(smem + pl.off_q);
  float* XH = reinterpret_cast<float*>(smem + pl.off_xt);
  float* XL = XH + NR * kRk4Panel;
  float* X = reinterpret_cast<float*>(smem + pl.off_state);
  float* XT = X + NR * dp;
  float* KS = XT + NR * dp;
  float* parts = AH;  // the warps' partial slopes: kConsumers x 16 kMT x 16
  float* ring = reinterpret_cast<float*>(smem + pl.off_ring);
  const uint32_t bars = mma::smem_addr(smem + pl.off_bar);
  const uint32_t ah = mma::smem_addr(AH), al = mma::smem_addr(AL);
  const uint32_t xh = mma::smem_addr(XH), xl = mma::smem_addr(XL);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  Ring<float> rg = {ring, pl.ring_elems, pl.nbuf, bars, 0, 0};
  const int col = 128 * (warp >> 2) + 16 * (warp & 3);  // the warp's first column of a chunk
  float bias0[2][2], bias1[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      bias0[mt][hh] = P.b0[col + 64 * mt + 8 * hh + g];
      bias1[mt][hh] = P.b1[col + 64 * mt + 8 * hh + g];
    }
  const int stage_j[4] = {0, 1, 1, 2};
  const float stage_c[4] = {0.f, 0.5f, 0.5f, 1.f};
  for (int i = 0; i < P.n; ++i) {
    const float* sc = P.scal + 7 * i;
    const float h = sc[0];
    for (int s = 0; s < 4; ++s) {
      const int j = stage_j[s];
      consumer_sync();  // the stage input written, the partial slopes read
      float acc[2][NR / 2];
      // products 1-2: xt -> P, Q; P, Q -> P, Q
      zero<NR>(acc);
      gemm<NR>(acc, rg, 1, col, xh, xl);
      store_act<NR>(acc, bias0, AH, AL, col);
      fence_proxy();
      consumer_sync();
      zero<NR>(acc);
      gemm<NR>(acc, rg, kChunkCols / kKt, col, ah, al);
      consumer_sync();  // every warpgroup's products are done with P, Q
      store_act<NR>(acc, bias1, AH, AL, col);
      fence_proxy();
      consumer_sync();
      // products 3-4, chunk by chunk: pf -> hid (registers) -> the warp's
      // partial slope (registers)
      float acc4[kMT][2][4];
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc4[m][u][e] = 0.f;
      const float* trow = P.trows + (static_cast<size_t>(i) * 3 + j) * H1;
      for (int c = 0; c < n_chunks(H1); ++c) {
        const int h0 = c * kChunkCols + col;
        float tv[2][2];
        // the sums start from each element's static part
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) tv[mt][hh] = trow[h0 + 64 * mt + 8 * hh + g];
#pragma unroll
          for (int jj = 0; jj < NR / 8; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = r0 + 8 * jj + 2 * t + (e & 1);
              acc[mt][4 * jj + e] =
                  r < P.R ? P.stat[static_cast<size_t>(r) * H1 + h0 + 64 * mt + g + 8 * (e >> 1)]
                          : 0.f;
            }
        }
        gemm<NR>(acc, rg, kChunkCols / kKt, col, ah, al);
        heads_out<NR, kMT>(acc4, acc, tv, ring_wait(rg), D, col);
        pin(acc4);  // the products that read the slot done, and (fence) its loads,
        fence_proxy();  // before it is released
        ring_release(rg);
      }
      fence_proxy();
      consumer_sync();  // every warpgroup's products are done with P, Q
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            parts[(warp * 16 * kMT + 16 * m + g + 8 * (e >> 1)) * 16 + 8 * u + 2 * t + (e & 1)] =
                acc4[m][u][e];
      consumer_sync();
      // the slope from the partials, added in a fixed order; then the next
      // stage's input (after the fourth stage, the step's update of x)
      const float q = sc[1 + j], a = sc[4 + j];
      const float cn = s < 3 ? stage_c[s + 1] * h : 0.f, h6 = h / 6.f;
      const bool out = i == P.n - 1 && s == 3;
      for (int e = threadIdx.x; e < NR * 16; e += kThreads) {
        const int r = e / 16, d = e % 16;
        float xt = 0.f;
        if (d < D) {
          float sum = 0.f;
          for (int w = 0; w < kConsumers; ++w) sum += parts[(w * 16 * kMT + r) * 16 + d];
          const int k = r * dp + d, qs = NR * dp;
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
        uint32_t hx, lx;
        mma::split_tf32(xt, hx, lx);
        XH[kmajor(NR, r, d)] = __uint_as_float(hx);
        XL[kmajor(NR, r, d)] = __uint_as_float(lx);
      }
      fence_proxy();
    }
  }
  if (P.n == 0)
    for (int e = threadIdx.x; e < NR * D; e += kThreads) {
      const int r = e / D, d = e % D;
      if (r0 + r < P.R) P.out[static_cast<size_t>(r0 + r) * D + d] = X[r * dp + d];
    }
}

// The kernel of the wgmma route: rk4_kernel<float, MT>'s integration (the
// producer, the ring, the state and the fixed order of the sums are the
// same) with two consumer warpgroups, each owning 128 columns of every
// 256-column chunk as two 64-column m-tiles, and a block of NR rows.
template <int NR>
__global__ void __launch_bounds__(kWgThreads, 1) rk4_kernel(const __grid_constant__ Params P) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the operands' swizzle repeats every 1,024 bytes: P starts on a boundary
  const uint32_t raw = mma::smem_addr(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const Rk4Plan& pl = P.plan;
  const int D = P.D, dp = pl.dpad;
  // P: relu(xt W0 + b0), then pf, high parts (Q: low parts); the stage
  // input's operand; x; the stage input, f32; the four slopes
  float* XH = reinterpret_cast<float*>(smem + pl.off_xt);
  float* XL = XH + NR * kRk4Panel;
  float* X = reinterpret_cast<float*>(smem + pl.off_state);
  float* XT = X + NR * dp;
  float* ring = reinterpret_cast<float*>(smem + pl.off_ring);
  const uint32_t bars = mma::smem_addr(smem + pl.off_bar);
  const int r0 = blockIdx.x * NR;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int b = 0; b < pl.nbuf; ++b) {
      mbar_init(bars + 8 * b, 1);
      mbar_init(bars + 8 * (pl.nbuf + b), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // x, and the first stage's input: x itself; operand depths D.. zero
  for (int e = threadIdx.x; e < NR * kRk4Panel; e += blockDim.x) {
    const int r = e / kRk4Panel, d = e % kRk4Panel;
    float x = 0.f;
    if (d < D) {
      x = r0 + r < P.R ? P.x0[static_cast<size_t>(r0 + r) * D + d] : 0.f;
      X[r * dp + d] = x;
      XT[r * dp + d] = x;
    }
    uint32_t h, l;
    mma::split_tf32(x, h, l);
    XH[kmajor(NR, r, d)] = __uint_as_float(h);
    XL[kmajor(NR, r, d)] = __uint_as_float(l);
  }
  fence_proxy();
  __syncthreads();
  // one branch a warpgroup for the whole kernel, so that setmaxnreg moves
  // registers from the producer's warpgroup (one warp of it works) to the
  // consumers: 384 threads start at 168 registers each
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == kConsumers / 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x / 32 == kConsumers) produce<float>(P, ring, bars, lane);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    consume<NR>(P, smem, r0);
  }
}

}  // namespace wg

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

template <int NR>
cudaError_t launch_wgmma(const Params& P, cudaStream_t st) {
  cudaError_t err = allow_smem(wg::rk4_kernel<NR>, P.plan.smem_bytes);
  if (err != cudaSuccess) return err;
  const int grid = (P.R + NR - 1) / NR;
  wg::rk4_kernel<NR><<<grid, wg::kWgThreads, P.plan.smem_bytes, st>>>(P);
  return cudaGetLastError();
}
cudaError_t launch_wgmma_rows(const Params& P, cudaStream_t st) {
  switch (P.plan.rows) {
    case 16: return launch_wgmma<16>(P, st);
    case 24: return launch_wgmma<24>(P, st);
    case 32: return launch_wgmma<32>(P, st);
    case 40: return launch_wgmma<40>(P, st);
    case 48: return launch_wgmma<48>(P, st);
    case 56: return launch_wgmma<56>(P, st);
    default: return launch_wgmma<64>(P, st);
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
  if (bf16) return launch_rows<__nv_bfloat16>(P, st);
  return P.plan.wgmma ? launch_wgmma_rows(P, st) : cudaErrorInvalidValue;
}

}  // namespace

// One fused integration; see Params for the layouts. bf16 != 0: the four
// weight matrices are bf16, otherwise f32. rounds (may be null): the rounds
// of blocks the launch takes on the card. Returns a CUDA error code, or
// -1 for shapes the kernel does not take (D above 16, P1, P2 or H1 not a
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
  if (rk4_route(R, D, P1, P2, H1, bf16, sms, &P.plan) != 0) return -1;
  if (rounds != nullptr) *rounds = P.plan.rounds;
  return static_cast<int>(launch_plan(P, bf16, static_cast<cudaStream_t>(stream)));
}
