// Launch plans of the tensor-core kernels (ode_rk4.cu, fused_sa.cu,
// relpe_attention.cu, vit_attention.cu's route), of FPS, ball query and
// ball count (fps.cu, ball_query.cu, ball_count.cu) and layernorm.cu's route:
// row or query tile, ring depth, heads, warps or centroids of a block and
// the shared-memory layout, from the shapes alone.
//
// Plain C++ with no CUDA in it, so that a host compiler builds it too:
// tests/test_torch_port_plan.py compiles it with -DGP2_PLAN_EXPORTS and checks
// the plans of the repository's configurations through the C functions at
// the end.
#pragma once

#ifdef __CUDACC__
#define GP2_HD __host__ __device__ __forceinline__
#else
#define GP2_HD inline
#endif

constexpr int kPlanWarps = 16;         // warps of a block
constexpr int kChunkCols = 256;        // output columns of one product pass
constexpr int kRingBytes = 33792;      // one ring buffer: 64 x 264 bf16, 32 x 264 float32
constexpr int kSmemLimit = 232448;     // dynamic shared memory of one block (227 KB)
constexpr int kSaCentroids = 16;       // SA: centroids of one block (8 or 4 where 16 do not fit)
constexpr int kSaMaxScales = 4;
constexpr int kSaMaxLayers = 4;

GP2_HD int round_up(int n, int m) { return (n + m - 1) / m * m; }
GP2_HD int imin(int a, int b) { return a < b ? a : b; }
GP2_HD int imax(int a, int b) { return a > b ? a : b; }

// Output column chunks of a product with N columns, and the width of chunk c.
GP2_HD int n_chunks(int N) { return (N + kChunkCols - 1) / kChunkCols; }
GP2_HD int chunk_cols(int N, int c) { return imin(kChunkCols, N - c * kChunkCols); }
// Row stride (elements) of an activation buffer of depth K, and of a weight
// tile of `cols` columns (see mma.cuh).
GP2_HD int act_ld(int K, int esize) { return round_up(K, 16) + (esize == 2 ? 8 : 4); }
GP2_HD int tile_ld(int cols) { return round_up(cols, 16) + 8; }
// Rows (depth) of one weight tile: as many as a ring buffer of buf_elems
// holds, a multiple of 16, at most K rounded up to 16.
GP2_HD int tile_rows(int K, int cols, int buf_elems) {
  return imin(round_up(K, 16), buf_elems / tile_ld(cols) / 16 * 16);
}
GP2_HD int n_ktiles(int K, int cols, int buf_elems) {
  const int kt = tile_rows(K, cols, buf_elems);
  return (round_up(K, 16) + kt - 1) / kt;
}
// Elements of one ring buffer for a product (K, N): its whole first chunk
// where that is below cap_bytes.
GP2_HD int ring_need(int K, int N, int esize, int cap_bytes = kRingBytes) {
  return imin(cap_bytes / esize, round_up(K, 16) * tile_ld(chunk_cols(N, 0)));
}

// ------------------------------------------------------------------ RK4

constexpr int kRk4MaxRows = 64;    // rows of the widest block
constexpr int kRk4MaxBufs = 4;     // ring slots
constexpr int kRk4MaxChunks = 8;   // 256-column chunks of the heads' first layer (H1 <= 2,048)
constexpr int kRk4Consumers = 8;   // consumer warps of a block, 32 columns of a chunk each

struct Rk4Plan {
  int rows;        // rows of one block: 16, 32, 48 or 64
  int rounds;      // rounds of blocks on the card (one block an SM)
  int nbuf;        // ring slots (2-4)
  int ring_elems;  // elements of one slot
  int dpad;        // state stride: D rounded up to 4
  int ldp, ldq;    // activation strides (elements) of buffers P and Q
  int smem_bytes;
  // byte offsets: f32 X, XT, KS[4] (rows x dpad each); P; Q, which also
  // holds the last product's partial sums (kRk4Consumers x rows x 16 f32);
  // the ring; its full and empty mbarriers (nbuf each, 8 bytes)
  int off_state, off_p, off_q, off_ring, off_bar;
  // 1: the float32 products by wgmma (rk4_wgmma_layout), whose sections
  // start with P, Q (the activations' high and low TF32 parts) and the stage
  // input's two parts at off_xt; 0: by mma.sync, off_xt unused
  int wgmma, off_xt;
};

// The layout of `rows`-row blocks with a ring of nbuf slots of kRingBytes /
// slot_div bytes: 0 and *p filled where it fits, else -1.
inline int rk4_layout(int R, int D, int P1, int P2, int bf16, int num_sms, int rows,
                      int slot_div, int nbuf, Rk4Plan* p) {
  const int es = bf16 ? 2 : 4;
  Rk4Plan q;
  q.rows = rows;
  q.nbuf = nbuf;
  q.ring_elems = kRingBytes / slot_div / es;
  // a slot holds a chunk's rows of W2 (at most 16 columns) and 16 rows of a
  // 256-column tile
  if (rows % 16 || rows < 16 || rows > kRk4MaxRows || nbuf < 2 || nbuf > kRk4MaxBufs ||
      q.ring_elems < kChunkCols * 16 || q.ring_elems / tile_ld(kChunkCols) < 16)
    return -1;
  const long long blocks = (R + rows - 1LL) / rows;
  q.rounds = static_cast<int>((blocks + num_sms - 1) / num_sms);
  q.dpad = round_up(D, 4);
  q.ldp = imax(act_ld(D, es), act_ld(P2, es));
  q.ldq = act_ld(P1, es);
  q.off_state = 0;
  q.off_p = 4 * 6 * rows * q.dpad;
  q.off_q = q.off_p + es * rows * q.ldp;
  const int q_bytes = imax(es * rows * q.ldq, 4 * kRk4Consumers * rows * 16);
  q.off_ring = round_up(q.off_q + q_bytes, 128);  // the TMA's boxes land 128-byte aligned
  q.off_bar = q.off_ring + es * nbuf * q.ring_elems;
  q.smem_bytes = q.off_bar + 2 * 8 * nbuf;
  q.wgmma = q.off_xt = 0;
  if (q.smem_bytes > kSmemLimit) return -1;
  *p = q;
  return 0;
}

// 0 and *p filled, or -1 when no plan fits (D above 16, P1, P2 or H1 not a
// multiple of kChunkCols, more than kRk4MaxChunks chunks of H1, or too
// wide). The row tile: the smallest
// multiple of 16 that puts every block on the card in one round (rows /
// num_sms rounded up), at most 64; above 64 x num_sms rows, 64-row blocks in
// several rounds. 6,400 rows make 100 blocks of 64, 3,200 rows 100 of 32, a
// tracking call's 600 rows 38 of 16. The ring: the first that fits of four
// slots of kRingBytes, three, two, then four, three or two of half that
// (64 float32 rows: two full slots, 4% faster than four half ones on the
// H100, PERF.md section 6).
inline int rk4_plan(int R, int D, int P1, int P2, int H1, int bf16, int num_sms, Rk4Plan* p) {
  if (R < 1 || D < 1 || D > 16 || P1 < 1 || P2 < 1 || H1 < 1 || num_sms < 1 ||
      P1 % kChunkCols || P2 % kChunkCols || H1 % kChunkCols || n_chunks(H1) > kRk4MaxChunks)
    return -1;
  const long long per_sm = (R + num_sms - 1LL) / num_sms;
  const int want = per_sm >= kRk4MaxRows ? kRk4MaxRows : round_up(static_cast<int>(per_sm), 16);
  const int opts[6][2] = {{1, 4}, {1, 3}, {1, 2}, {2, 4}, {2, 3}, {2, 2}};  // slot_div, nbuf
  for (int rows = want; rows >= 16; rows -= 16)
    for (int o = 0; o < 6; ++o)
      if (rk4_layout(R, D, P1, P2, bf16, num_sms, rows, opts[o][0], opts[o][1], p) == 0) return 0;
  return -1;
}

// The float32 route by wgmma (ode_rk4.cu, namespace wg): a block's rows are
// the products' N (a multiple of 8, 16 to 64); the activations (depth 256:
// P1 = P2 = 256) and the stage input are K-major operands, panels of
// kRk4Panel depths (128-byte rows, swizzled in 16-byte chunks by the row),
// each in its high and low TF32 parts; the ring's slots hold 16 weight rows
// of 264 float32 (kRingBytes / 2). Sections: P (high), Q (low), the stage
// input (high, then low: one panel each), the state, the ring, the
// barriers, and 1,024 bytes that the kernel skips to put P on a 1,024-byte
// boundary (the swizzle's period). The last product's partial sums
// (kRk4Consumers x rows rounded up to 16 x 16 f32) reuse P and Q.
constexpr int kRk4Panel = 32;
inline int rk4_wgmma_layout(int R, int D, int P1, int P2, int num_sms, int rows, int nbuf,
                            Rk4Plan* p) {
  if (rows % 8 || rows < 16 || rows > kRk4MaxRows || P1 != kChunkCols || P2 != kChunkCols ||
      nbuf < 2 || nbuf > kRk4MaxBufs)
    return -1;
  Rk4Plan q;
  q.rows = rows;
  q.nbuf = nbuf;
  q.ring_elems = kRingBytes / 2 / 4;
  const long long blocks = (R + rows - 1LL) / rows;
  q.rounds = static_cast<int>((blocks + num_sms - 1) / num_sms);
  q.dpad = round_up(D, 4);
  q.ldp = q.ldq = kRk4Panel;
  q.wgmma = 1;
  q.off_p = 0;
  q.off_q = 4 * rows * kChunkCols;
  q.off_xt = q.off_q + 4 * rows * kChunkCols;
  q.off_state = q.off_xt + 2 * 4 * rows * kRk4Panel;
  q.off_ring = round_up(q.off_state + 4 * 6 * rows * q.dpad, 128);
  q.off_bar = q.off_ring + 4 * nbuf * q.ring_elems;
  q.smem_bytes = q.off_bar + 2 * 8 * nbuf + 1024;
  if (q.smem_bytes > kSmemLimit || 4 * kRk4Consumers * round_up(rows, 16) * 16 > q.off_xt)
    return -1;
  *p = q;
  return 0;
}

// The wgmma route's plan: the smallest multiple of 8 rows (at least 16, at
// most 64) that puts every block on the card in one round, a ring of three
// slots (two where three do not fit); 0, or -1 where the route does not
// take the shapes (rk4_plan's limits, and P1 = P2 = 256). 6,400 rows make
// 115 blocks of 56, 3,200 rows 100 of 32, 600 rows 38 of 16.
inline int rk4_wgmma_plan(int R, int D, int P1, int P2, int H1, int num_sms, Rk4Plan* p) {
  if (R < 1 || D < 1 || D > 16 || H1 < 1 || num_sms < 1 || H1 % kChunkCols ||
      n_chunks(H1) > kRk4MaxChunks)
    return -1;
  const long long per_sm = (R + num_sms - 1LL) / num_sms;
  const int rows = per_sm >= kRk4MaxRows ? kRk4MaxRows : imax(16, round_up(static_cast<int>(per_sm), 8));
  for (int nbuf = 3; nbuf >= 2; --nbuf)
    if (rk4_wgmma_layout(R, D, P1, P2, num_sms, rows, nbuf, p) == 0) return 0;
  return -1;
}

// The plan gp2_rk4 launches: float32 by wgmma (faster at every shape the
// port launches, PERF.md section 6; -1 where its plan does not fit), bf16 by
// mma.sync (rk4_plan).
inline int rk4_route(int R, int D, int P1, int P2, int H1, int bf16, int num_sms, Rk4Plan* p) {
  return bf16 ? rk4_plan(R, D, P1, P2, H1, bf16, num_sms, p)
              : rk4_wgmma_plan(R, D, P1, P2, H1, num_sms, p);
}

// ------------------------------------------------------------------- SA

struct SaPlan {
  int rows;        // rows of one product chunk (32 or 64)
  int centroids;   // centroids of one block (16 or 8)
  int nbuf;        // ring buffers (2 or 3)
  int ring_elems;  // elements of one ring buffer
  int lda, ldb;    // strides of the ping and pong activation buffers
  int max_cout;    // widest scale output
  int idx_stride;  // hit-list slots of a centroid (sum of nsample)
  int smem_bytes;
  // byte offsets: f32 pooled outputs (centroids x max_cout) as int bits,
  // f32 xs/ys/zs (n_staged each), int hit lists, rows per centroid
  // (centroids x kSaMaxScales), rstart (centroids + 1), row centroid and row
  // point (rows each); then the two activation buffers and the ring
  int off_acc, off_xyz, off_idx, off_nrow, off_rstart, off_rowc, off_rowp, off_a, off_b,
      off_ring;
};

// Per scale s: nsample[s], num_layers[s] and widths[s * (kSaMaxLayers + 1) +
// 0..num_layers]; n_staged: points staged for the ball query (0 for index
// hits). 0 and *p filled, or -1.
inline int sa_plan(int n_scales, const int* nsample, const int* num_layers, const int* widths,
                   int n_staged, int bf16, SaPlan* p) {
  if (n_scales < 1 || n_scales > kSaMaxScales || n_staged < 0) return -1;
  const int es = bf16 ? 2 : 4;
  int wa = 16, wb = 16, cout = 1, slots = 0, ring[2] = {8, 8};  // full, half tiles
  for (int s = 0; s < n_scales; ++s) {
    const int L = num_layers[s];
    const int* w = widths + s * (kSaMaxLayers + 1);
    if (L < 0 || L > kSaMaxLayers || nsample[s] < 1) return -1;
    for (int l = 0; l <= L; ++l)
      if (w[l] < 1) return -1;
    wa = imax(wa, w[0]);  // the gather: ping
    for (int l = 0; l + 1 < L; ++l) {  // stored outputs alternate pong, ping
      if (l % 2 == 0) wb = imax(wb, w[l + 1]);
      else wa = imax(wa, w[l + 1]);
    }
    for (int l = 0; l < L; ++l) {
      ring[0] = imax(ring[0], ring_need(w[l], w[l + 1], es));
      ring[1] = imax(ring[1], ring_need(w[l], w[l + 1], es, kRingBytes / 2));
    }
    cout = imax(cout, w[L]);
    slots += nsample[s];
  }
  // 64-row chunks first (half the weight stream of 32); then the first that
  // fits of: a ring 3 deep before 2, full-size ring tiles, 16, 8 or 4
  // centroids a block
  const int opts[5][2] = {{16, 0}, {8, 0}, {16, 1}, {8, 1}, {4, 1}};  // centroids, half
  for (int rows = 64; rows >= 32; rows -= 32) {
    for (int opt = 0; opt < 10; ++opt) {
      const int cent = opts[opt % 5][0], half = opts[opt % 5][1], nbuf = 3 - opt / 5;
      SaPlan q;
      q.rows = rows;
      q.centroids = cent;
      q.nbuf = nbuf;
      q.ring_elems = ring[half];
      q.lda = act_ld(wa, es);
      q.ldb = act_ld(wb, es);
      q.max_cout = cout;
      q.idx_stride = slots;
      q.off_acc = 0;
      q.off_xyz = q.off_acc + 4 * round_up(cent * cout, 4);
      q.off_idx = q.off_xyz + 4 * 3 * round_up(n_staged, 4);
      q.off_nrow = q.off_idx + 4 * round_up(cent * slots, 4);
      q.off_rstart = q.off_nrow + 4 * cent * kSaMaxScales;
      q.off_rowc = q.off_rstart + 4 * round_up(cent + 1, 4);
      q.off_rowp = q.off_rowc + 4 * rows;
      q.off_a = q.off_rowp + 4 * rows;
      q.off_b = q.off_a + es * rows * q.lda;
      q.off_ring = q.off_b + es * rows * q.ldb;
      q.smem_bytes = q.off_ring + es * nbuf * q.ring_elems;
      if (q.smem_bytes <= kSmemLimit) {
        *p = q;
        return 0;
      }
    }
  }
  return -1;
}

// --------------------------------------------------------------- rel-PE

constexpr int kRelpeHeads = 8;   // heads of the Fus encoder's rel-PE blocks
constexpr int kRelpeChunk = 32;  // keys of one chunk
constexpr int kRelpeBufs = 2;    // K, V and key-xyz chunk buffers
constexpr int kRelpeHid = 16;    // hidden channels of the bias MLPs
constexpr int kRelpeRecord = 24; // floats of one hidden channel's constants

struct RelpePlan {
  int heads;  // heads of one block (8, 4, 2 or 1)
  int warps;  // warps of a block (8 or 4), one (head, 16 query rows) task each
  int tq;     // query rows of a block: 16 * warps / heads
  int kc;     // keys of one chunk
  int nbuf;   // chunk buffers
  int dp;     // head width D padded to the mma depth: 16, 32, 64 or 128
  int ldkv;   // row stride (elements) of staged K and V: dp + 8 (bf16) or dp + 4
  int ldb;    // row stride (floats) of the bias: kc + 8
  int blocks; // blocks of the grid: B * ceil(M / tq) * (8 / heads)
  int smem_bytes;
  // byte offsets: f32 constants (kRelpeHid records, then 8 bc), query xyz
  // (tq x 3), key xyz (nbuf x kc x 3), bias (heads x tq x ldb); K and V
  // (nbuf x heads x kc x ldkv each)
  int off_cst, off_qxyz, off_kxyz, off_bias, off_k, off_v;
};

GP2_HD int relpe_depth(int D) {
  return D < 1 ? 0 : D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 0;
}

// (B, M, C = 8 heads x D, D even and at most 128): 0 and *p filled, or -1.
// Options in order: 8 heads a block with 8 warps (16 query rows), then
// fewer heads (the K and V chunks of 8 wide heads do not fit, or too few
// blocks), then 4 warps. The first that leaves room for two blocks on an SM
// and puts num_sms blocks on the grid with no query tile wider than M
// (rounded up to 16); else the one with the most blocks among those that
// leave two blocks room with no tile wider than M, then among those that
// fit with no tile wider than M, then among those that fit.
inline int relpe_plan(int B, int M, int C, int H, int bf16, int num_sms, RelpePlan* p) {
  if (B < 1 || M < 1 || H != kRelpeHeads || C % H != 0 || (C / H) % 2 != 0 || num_sms < 1)
    return -1;
  const int D = C / H, dp = relpe_depth(D);
  if (dp == 0) return -1;
  const int es = bf16 ? 2 : 4;
  const int opts[7][2] = {{8, 8}, {4, 8}, {4, 4}, {2, 8}, {2, 4}, {1, 8}, {1, 4}};
  RelpePlan cand[7];
  for (int o = 0; o < 7; ++o) {
    RelpePlan& q = cand[o];
    q.heads = opts[o][0];
    q.warps = opts[o][1];
    q.tq = 16 * q.warps / q.heads;
    q.kc = kRelpeChunk;
    q.nbuf = kRelpeBufs;
    q.dp = dp;
    q.ldkv = dp + (bf16 ? 8 : 4);
    q.ldb = q.kc + 8;
    q.blocks = B * ((M + q.tq - 1) / q.tq) * (kRelpeHeads / q.heads);
    q.off_cst = 0;
    q.off_qxyz = q.off_cst + 4 * round_up(kRelpeHid * kRelpeRecord + kRelpeHeads, 4);
    q.off_kxyz = q.off_qxyz + 4 * round_up(3 * q.tq, 4);
    q.off_bias = q.off_kxyz + 4 * round_up(q.nbuf * q.kc * 3, 4);
    q.off_k = q.off_bias + 4 * q.heads * q.tq * q.ldb;
    q.off_v = q.off_k + es * q.nbuf * q.heads * q.kc * q.ldkv;
    q.smem_bytes = q.off_v + es * q.nbuf * q.heads * q.kc * q.ldkv;
  }
  const int m16 = round_up(M, 16);
  int pick = -1;
  for (int pass = 0; pass < 4 && pick < 0; ++pass) {
    const int cap = pass < 2 ? kSmemLimit / 2 : kSmemLimit;
    for (int o = 0; o < 7; ++o) {
      const RelpePlan& q = cand[o];
      if (q.smem_bytes > cap || (pass < 3 && q.tq > m16)) continue;
      if (pass == 0) {
        if (q.blocks >= num_sms) {
          pick = o;
          break;
        }
      } else if (pick < 0 || q.blocks > cand[pick].blocks) {
        pick = o;
      }
    }
  }
  if (pick < 0) return -1;
  *p = cand[pick];
  return 0;
}

// ------------------------------------------------------------------ FPS

constexpr int kFpsMaxWarps = 16;
constexpr int kFpsMaxP = 32;        // points a thread holds in registers
constexpr int kFpsMaxSlots = 8192;  // warps x 32 x p: 16 warps at 16 points or 8 at 32 stay
                                    // within the SM's 65,536 registers
constexpr int kFpsWideWarps = 32;   // the wide route: 1,024 threads an object

struct FpsPlan {
  int warps;  // warps of a block, one block per object
  int p;      // points a thread holds in registers: warps x 32 x p >= N; 0 on
              // the wide route
  int wide;   // 1: the wide route (N > kFpsMaxSlots): a thread owns the points
              // t, t + 1024, ...; their running distances in a global scratch
              // of N floats an object, the coordinates read from device
              // memory (L1 / L2) at every pick
  int smem_bytes;
  // byte offsets: f32 xs, ys, zs (N rounded up to 4 each; empty on the wide
  // route); the warps' partial values and indices (2 x warps ints each,
  // double-buffered by the pick's parity)
  int off_x, off_y, off_z, off_val, off_idx;
};

GP2_HD void fps_layout(int N, int warps, int p, int wide, FpsPlan* q) {
  const int staged = wide ? 0 : N;
  q->warps = warps;
  q->p = wide ? 0 : p;
  q->wide = wide;
  q->off_x = 0;
  q->off_y = q->off_x + 4 * round_up(staged, 4);
  q->off_z = q->off_y + 4 * round_up(staged, 4);
  q->off_val = q->off_z + 4 * round_up(staged, 4);
  q->off_idx = q->off_val + 4 * round_up(2 * warps, 4);
  q->smem_bytes = q->off_idx + 4 * round_up(2 * warps, 4);
}

// (N, B objects): 0 and *q filled, or -1 when N or B is out of range. The
// fastest of the (warps, P) variants timed on the H100 (PERF.md section 6):
// to 256 points one warp (no block barrier a pick) with N / 32 points
// a thread; above, 4 warps with N / 128 points a thread, the warps doubled
// instead while a thread would hold more than 8 (more than 16 where B
// exceeds the SMs, so that two blocks share an SM). fps.cu instantiates
// warps 1-16 and P 4-32, powers of two, at most kFpsMaxSlots a block. Past
// kFpsMaxSlots points the wide route: 32 warps, the running distances in
// the caller's global scratch.
inline int fps_plan(int N, int B, int num_sms, FpsPlan* q) {
  if (N < 1 || B < 1 || num_sms < 1) return -1;
  if (N > kFpsMaxSlots) {
    fps_layout(N, kFpsWideWarps, 0, 1, q);
    return 0;
  }
  int warps = 1, p = 4;
  if (N <= 32 * 8) {
    while (32 * p < N) p *= 2;
  } else {
    const int p_max = B > num_sms ? 16 : 8;
    warps = 4;
    while (warps * 32 * p < N) p *= 2;
    while (p > p_max && warps < kFpsMaxWarps) {
      p /= 2;
      warps *= 2;
    }
  }
  fps_layout(N, warps, p, 0, q);
  return q->smem_bytes <= kSmemLimit ? 0 : -1;
}

// ----------------------------------------------------------- ball query

constexpr int kBallQueryWindow = 4;    // sub-slots of 32 points a warp tests a step
constexpr int kBallQueryTile = 4096;   // points of the cloud staged at once (48 KB)

struct BallQueryPlan {
  int warps;   // warps of a block, one centroid each
  int blocks;  // B x ceil(M / warps)
  int tile;    // points staged a tile: min(N, kBallQueryTile), a multiple of
               // 32 x kBallQueryWindow where N is larger, so that no window
               // straddles two tiles
  int smem_bytes;
  int off_xyz;  // byte offset of the tile of the cloud as it lies in memory (3 tile f32)
};

GP2_HD void ball_query_layout(int B, int N, int M, int warps, BallQueryPlan* q) {
  q->warps = warps;
  q->blocks = B * ((M + warps - 1) / warps);
  q->tile = imin(N, kBallQueryTile);
  q->off_xyz = 0;
  q->smem_bytes = q->off_xyz + 4 * round_up(3 * q->tile, 4);
}

// (B, N, M, nsample): 0 and *q filled, or -1. 8 warps a block, fewer where 8
// would leave SMs without a block: of the block sizes timed on the H100
// (PERF.md section 6), small blocks balance the card best, and
// staging a cloud costs less than a scan. A cloud past kBallQueryTile points
// streams through shared memory in tiles.
inline int ball_query_plan(int B, int N, int M, int nsample, int num_sms, BallQueryPlan* q) {
  if (B < 1 || N < 1 || M < 1 || nsample < 1 || num_sms < 1) return -1;
  int warps = 8;
  while (warps > 1 && static_cast<long long>(B) * ((M + warps - 1) / warps) < num_sms) warps /= 2;
  ball_query_layout(B, N, M, warps, q);
  return q->smem_bytes <= kSmemLimit ? 0 : -1;
}

// ----------------------------------------------------------- ball count

constexpr int kBallCountThreads = 256;  // threads of a block
constexpr int kBallCountTile = 2048;    // points of the cloud staged at once (32 KB)

struct BallCountPlan {
  int lanes;      // centroid lanes of a warp (32, 16 or 8); a warp's 32 / lanes
                  // groups of lanes scan interleaved points
  int cpt;        // centroids a thread holds in registers (4, 2 or 1)
  int splits;     // threads that share a centroid, each scanning every
                  // splits-th point: kBallCountThreads / lanes
  int centroids;  // centroids of a block: lanes x cpt
  int blocks;     // B x ceil(M / centroids)
  int tile;       // points staged a tile: min(N rounded up to 4, kBallCountTile)
  int smem_bytes;
  // byte offsets: the tile as float4 (x, y, z, 0), the block's counts (ints)
  int off_pts, off_cnt;
};

GP2_HD void ball_count_layout(int B, int N, int M, int lanes, int cpt, BallCountPlan* q) {
  q->lanes = lanes;
  q->cpt = cpt;
  q->splits = kBallCountThreads / lanes;
  q->centroids = lanes * cpt;
  q->blocks = B * ((M + q->centroids - 1) / q->centroids);
  q->tile = imin(round_up(N, 4), kBallCountTile);
  q->off_pts = 0;
  q->off_cnt = q->off_pts + 16 * q->tile;
  q->smem_bytes = q->off_cnt + 4 * round_up(q->centroids, 4);
}

// (B, N, M): 0 and *q filled, or -1. Of the (lanes, centroids a thread)
// options, the one that puts the fewest centroids on the busiest SM (blocks
// in rounds of num_sms, times centroids a block); ties keep the larger
// block, whose staged points serve more tests a read. At B = 64, M = 512:
// 32 x 4, 256 blocks; at B = 12: 8 x 2, 384 blocks.
inline int ball_count_plan(int B, int N, int M, int num_sms, BallCountPlan* q) {
  if (B < 1 || N < 0 || M < 1 || num_sms < 1) return -1;  // N = 0: every count 0
  const int opts[5][2] = {{32, 4}, {32, 2}, {16, 2}, {8, 2}, {8, 1}};
  long long best_load = -1;
  for (int o = 0; o < 5; ++o) {
    BallCountPlan c;
    ball_count_layout(B, N, M, opts[o][0], opts[o][1], &c);
    const long long load = (c.blocks + num_sms - 1) / num_sms * static_cast<long long>(c.centroids);
    if (best_load < 0 || load < best_load) {
      *q = c;
      best_load = load;
    }
  }
  return q->smem_bytes <= kSmemLimit ? 0 : -1;
}

// -------------------------------------------------------- ViT attention

// The MMA depth: bf16 D rounded up to 64 or 128, float32 D to 16, 32, 64 or
// 128 (0: not supported).
GP2_HD int vit_padded_depth(int D, int bf16) {
  if (D <= 0 || D > 128) return 0;
  if (bf16) return D <= 64 ? 64 : 128;
  return D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : 128;
}

// Keys of one staged window on the long-sequence route: about 64 KB of K
// and V (68 KB at most with float32's padded rows), three blocks an SM.
GP2_HD constexpr int vit_window_keys(int Dp, int bf16) {
  return bf16 ? (Dp == 64 ? 256 : 128) : (Dp <= 64 ? 128 : 64);
}

// Shared memory of a block staging `rows` keys (a multiple of 16): bf16 K and
// V plus 1 KB to align the swizzle atoms; float32 K and V rows of Dp + 4.
GP2_HD long long vit_smem_bytes(int rows, int Dp, int bf16) {
  if (!bf16) return static_cast<long long>(rows) * 2 * (Dp + 4) * 4;
  return static_cast<long long>(2 * (Dp / 64)) * rows * 128 + 1024;
}

struct VitAttentionPlan {
  int dp;        // head dim padded to the MMA depth
  int windowed;  // 1: K and V stream through shared memory in key windows
  int keys;      // keys staged at once: N rounded up to 16 (the whole head), or a window
  int smem_bytes;
};

// (N tokens, head dim D): 0 and *q filled, or -1 (D not supported). A block
// holds one head's K and V whole while they fit smem_limit, else the window.
inline int vit_attention_plan(int N, int D, int bf16, int smem_limit, VitAttentionPlan* q) {
  q->dp = vit_padded_depth(D, bf16);
  if (N < 1 || q->dp == 0) return -1;
  q->keys = round_up(N, 16);
  q->windowed = vit_smem_bytes(q->keys, q->dp, bf16) > smem_limit;
  if (q->windowed) q->keys = vit_window_keys(q->dp, bf16);
  q->smem_bytes = static_cast<int>(vit_smem_bytes(q->keys, q->dp, bf16));
  return q->smem_bytes <= smem_limit ? 0 : -1;
}

// The route switch: the most tokens whose K and V a block holds whole.
inline int vit_attention_max_tokens(int D, int bf16, int smem_limit) {
  const int Dp = vit_padded_depth(D, bf16);
  if (Dp == 0) return 0;
  int n = 0;
  while (vit_smem_bytes(n + 16, Dp, bf16) <= smem_limit) n += 16;
  return n;
}

// ------------------------------------------------------------ LayerNorm

// layernorm.cu's route for rows of D elements; `vec`: D a multiple of 4 and
// every operand 16-byte aligned. A warp a row to 1,024 elements, a 256-thread
// block a row past it (wide), to 8,192; a lane or thread holds `pieces`
// pieces of `piece` consecutive elements (4: 8/16-byte loads, 1: scalar).
struct LnPlan {
  int wide;
  int piece;
  int pieces;
};

inline int ln_plan(int D, int vec, LnPlan* q) {
  if (D < 1 || D > 8192) return -1;
  q->wide = D > 1024;
  q->piece = vec ? 4 : 1;
  const int steps[2][5] = {{128, 256, 384, 512, 1024}, {2048, 4096, 8192, 8192, 8192}};
  const int counts[2][2][5] = {{{4, 8, 12, 16, 32}, {1, 2, 3, 4, 8}},   // a warp a row
                               {{8, 16, 32, 32, 32}, {2, 4, 8, 8, 8}}};  // a block a row
  int k = 0;
  while (D > steps[q->wide][k]) ++k;
  q->pieces = counts[q->wide][vec ? 1 : 0][k];
  return 0;
}

#ifdef GP2_PLAN_EXPORTS
// The plans as int arrays, in the order of the structs' fields.
extern "C" int gp2_relpe_plan(int B, int M, int C, int H, int bf16, int num_sms, int* out) {
  return relpe_plan(B, M, C, H, bf16, num_sms, reinterpret_cast<RelpePlan*>(out));
}
extern "C" int gp2_rk4_plan(int R, int D, int P1, int P2, int H1, int bf16, int num_sms,
                            int* out) {
  return rk4_plan(R, D, P1, P2, H1, bf16, num_sms, reinterpret_cast<Rk4Plan*>(out));
}
extern "C" int gp2_rk4_route(int R, int D, int P1, int P2, int H1, int bf16, int num_sms,
                             int* out) {
  return rk4_route(R, D, P1, P2, H1, bf16, num_sms, reinterpret_cast<Rk4Plan*>(out));
}
extern "C" int gp2_sa_plan(int n_scales, const int* nsample, const int* num_layers,
                           const int* widths, int n_staged, int bf16, int* out) {
  return sa_plan(n_scales, nsample, num_layers, widths, n_staged, bf16,
                 reinterpret_cast<SaPlan*>(out));
}
extern "C" int gp2_fps_plan(int N, int B, int num_sms, int* out) {
  return fps_plan(N, B, num_sms, reinterpret_cast<FpsPlan*>(out));
}
extern "C" int gp2_ball_query_plan(int B, int N, int M, int nsample, int num_sms, int* out) {
  return ball_query_plan(B, N, M, nsample, num_sms, reinterpret_cast<BallQueryPlan*>(out));
}
extern "C" int gp2_ball_count_plan(int B, int N, int M, int num_sms, int* out) {
  return ball_count_plan(B, N, M, num_sms, reinterpret_cast<BallCountPlan*>(out));
}
extern "C" int gp2_vit_attention_plan(int N, int D, int bf16, int smem_limit, int* out) {
  return vit_attention_plan(N, D, bf16, smem_limit, reinterpret_cast<VitAttentionPlan*>(out));
}
extern "C" int gp2_ln_plan(int D, int vec, int* out) {
  return ln_plan(D, vec, reinterpret_cast<LnPlan*>(out));
}
#endif
