// Chunkwise gated linear scan (the mLSTM cell of xLSTM) in f32, on the
// tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/mlstm_scan/mlstm_scan.py:71
// (mlstm_scan_pallas, its pl.pallas_call at :88 and _kernel body), which
// keeps the (dk, dv) state and (1, dk) normalizer in VMEM scratch across
// a sequential chunk axis of the grid. Per (b, h), with the per-step log
// decay lf_t <= 0:
//   C_t = exp(lf_t) C_{t-1} + k_t v_t^T      n_t = exp(lf_t) n_{t-1} + k_t
//   h_t = q_t C_t [/ max(|q_t . n_t|, 1)]
// computed a chunk of L steps at a time from the zero state. With
// d_i = lf_0 + .. + lf_i inside the chunk and D = d_{L-1}:
//   P_ij  = (q_i . k_j) exp(d_i - d_j) for j <= i, else 0 (masked
//           BEFORE the exponent: for j > i it is positive and may
//           overflow, and inf * 0 is NaN)
//   h_i   = sum_j P_ij v_j + exp(d_i) (q_i C),  n.q_i = sum_j P_ij + exp(d_i) (q_i . n)
//   C    <- exp(D) C + sum_j exp(D - d_j) k_j v_j^T,  n <- exp(D) n + sum_j exp(D - d_j) k_j
// The kernel also writes the final (C, n), which prefill needs.
//
// Bound: operations. The chunkwise form does, per (b, h) and chunk,
// L(L+1) dk (causal scores) + L(L+1) dv (in-chunk sums) + 2 L dk dv
// (q.C) + 2 L dk dv (state) FLOPs: 18.27 GFLOP at (B, H, S, dk, dv) =
// (8, 4, 512, 512, 512) with L = 64, against 0.17 GB of HBM traffic
// (0.05 ms at 3.35 TB/s). On SIMT f32 (67 TFLOP/s) that is 0.273 ms;
// the products here run on the tensor cores in a 3xTF32 split, three
// TF32 products for each f32 one, 0.111 ms at 495 TFLOP/s.
//
// Design. An SM holds at most 227 KB of shared memory and the state of
// one (b, h) at dk = dv = 512 is 1 MiB, so the dv axis is split: CTA
// (bh, y) owns C[:, 64y : 64y + 64], transposed (Ct, 64 x dk) in shared
// memory for the whole sequence, and walks the chunks in order.
//
// 1. Products on tensor cores. q.k (scores), P.v (in-chunk), q.C and
//    (k w)^T v (state) run as mma.sync.m16n8k8 TF32 with f32
//    accumulators in a 3xTF32 split: x = big + small with big = rna(x),
//    small = rna(x - big), each product summed as small*big + big*small
//    + big*big (plain TF32, at unit roundoff 4.9e-4, would break
//    mlstm_error_bound). The tensor cores truncate each product to the
//    accumulator's magnitude, so each 16-deep block is summed from zero
//    and added in f32 (see mma16_all). q.n stays SIMT f32.
// 2. One pass over dk a chunk. q and k stream through shared memory in
//    tiles of TK of the dk axis with 16-byte cp.async (zero-filled past S
//    and dk; a scalar path where rows are not 16-byte aligned). At TK =
//    32 the k tiles form a ring of three, so one barrier phase holds tile
//    kt's products (q.C with the old C, the scores, q.n) beside tile kt -
//    1's state update and n's partial sums, while tile kt + 1's copy is
//    in flight; where shared memory is short, TK = 16 with two stages and
//    a second barrier. k is read once a chunk. The next chunk's first
//    tile, v and decays are fetched during this chunk's tail.
// 3. The chunk's scores once per (b, h). Only the lower-triangular
//    16 x 8 score tiles are computed (20 of 32 at L = 64). At L = 64
//    (xlstm-350m's chunk, the one measured) a cluster of 1, 2, 4 or 8
//    CTAs (column blocks of one (b, h)) splits them: each CTA computes
//    its share, decays and masks it, and stores it with st.async into
//    every CTA's P buffer (its own too), counted on that CTA's mbarrier;
//    every CTA keeps its own n and q.n. Other chunks run alone. The
//    cluster size comes from make_plan() below: the largest the column
//    blocks allow whose grid takes no more waves than the cluster-free
//    one, by the clusters cudaOccupancyMaxActiveClusters says the card
//    holds (an H100 holds 66 clusters of 2 CTAs this large, 30 of 4 and
//    15 of 8, so (8, 4, 512, 512, 512) takes clusters of 2).
// 4. Work split, 8 warps. q.C and P.v: warp w owns row tile w % (L/16)
//    and L/16 of the 8 column tiles, so q.C's accumulators become h's.
//    Scores: row tile r's 2 (r + 1) tiles are dealt to the warps that own
//    row tile r in every CTA of the cluster (score_tile; the q.C A
//    fragment serves both), each warp computing score_slots(L, cluster)
//    tiles so that no branch splits the products. State: warp w owns 16
//    columns and TK/16 tiles of 8 dk rows of each dk tile. Each warp
//    issues its MMAs term by term across its accumulators (an MMA waits
//    28 cycles for the one before it on its accumulator).
// Shared-memory tiles are swizzled by 16-byte chunk (the chunk index
// XOR 2 bits of the row) so that the fragment loads of every product are
// free of bank conflicts.
//
// What holds it back (PERF.md, tools/torch_mlstm_ablation.py): at the
// main shape a barrier phase costs about the sum of its MMA pipe time
// (mma.sync TF32 issues one MMA per 8 cycles a scheduler at best), its
// instruction issue (the splits and fragment loads outnumber the MMAs
// several times) and its shared-memory traffic: 8 warps with small tiles
// at 255 registers cannot overlap them.
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDvBlock = 64;          // columns of C (and of h) a CTA owns
constexpr int kLdv = kDvBlock + 8;    // row stride of the v tile (8 mod 32)
constexpr int kMaxSmem = 232448;      // dynamic shared memory a block may have
constexpr int kBarrierBytes = 16;     // two mbarriers, one a P buffer
constexpr int kClusterUnschedulable = -1;
constexpr int kShareChunk = 64;       // the chunk whose scores a cluster shares

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Lower-triangular 16 x 8 score tiles of a chunk of L: row tile r holds
// column tiles 0 .. 2r + 1.
__host__ __device__ constexpr int lower_tiles(int L) {
  return (L / 16) * (L / 16 + 1);
}

// Score tiles a warp computes in a cluster of `cluster` CTAs: row tile
// r's 2 (r + 1) tiles are dealt to the kWarps / (L/16) warps of each CTA
// that own row tile r, so the last row tile sets the count. Every warp
// computes that many (a warp with fewer repeats a tile and drops it), so
// that no branch splits the products.
__host__ __device__ constexpr int score_slots(int L, int cluster) {
  return ((L / 16) * (L / 16) + 4 * cluster - 1) / (4 * cluster);
}

// The column tile of slot `slot` of warp `warp` of cluster rank `rank`,
// on the warp's own row tile warp % (L/16) (the q.C A fragment serves
// both), or -1 where that slot holds no tile: row tile r's column tiles
// 0 .. 2r + 1 dealt round-robin to the warps of every CTA that own it.
__host__ __device__ constexpr int score_tile(int L, int cluster, int rank,
                                             int warp, int slot) {
  const int mt = L / 16;
  const int e = warp / mt + kWarps / mt * (rank + slot * cluster);
  return e < 2 * (warp % mt + 1) ? e : -1;
}

// k stages of a tile size: TK = 32 runs a ring of three (a tile's state
// update shares a barrier phase with the next tile's products), TK = 16,
// where shared memory is short, two.
__host__ __device__ constexpr int k_stages(int tk) { return tk == 32 ? 3 : 2; }

// Dynamic shared memory, in bytes, of one CTA: chunk L, head dim dk,
// TK dk a tile, two P buffers in a cluster (one alone).
__host__ __device__ inline int64_t smem_bytes_tk(int L, int dk, int tk,
                                                 int cluster) {
  const int64_t dkp = round_up(dk, 32);
  const int64_t np = cluster > 1 ? 2 : 1;
  return 4 * (dkp * kDvBlock                          // Ct
              + dkp                                   // n
              + (2 + k_stages(tk)) * (int64_t)L * tk  // q (2) and k tiles
              + (int64_t)L * kLdv                     // v tile of the chunk
              + np * L * (L + 4)                      // P
              + 2 * (int64_t)kWarps * tk              // n's partial sums
              + 4 * (int64_t)L)                       // d, exp(d), exp(D - d), q.n
         + kBarrierBytes;
}

// TK: 32 where it fits, else 16; 0 where neither does.
__host__ __device__ inline int pick_tk(int L, int dk, int cluster) {
  if (smem_bytes_tk(L, dk, 32, cluster) <= kMaxSmem) return 32;
  if (smem_bytes_tk(L, dk, 16, cluster) <= kMaxSmem) return 16;
  return 0;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// ---- cluster exchange (as slstm_cell.cu) ----

// The cluster barrier: once, after set-up.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}
// The address in CTA `rank` of the cluster of a shared-memory address.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}
// One phase of `bar` completes when its one arrival (this) and `bytes`
// of st.async stores into its CTA have landed.
__device__ __forceinline__ void bar_arm(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ bool bar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}
// Wait for the phase of `bar` of the given parity. A phase that has not
// completed after about 2^35 cycles (17 s at 1.98 GHz) can only be a
// fault: trap, so that the launch fails instead of holding the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  if (bar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!bar_try_wait(bar, parity))
    if (clock64() - start > (1LL << 35)) __trap();
}
// An 8-byte store into a CTA's shared memory that counts its bytes on
// that CTA's barrier `bar` (both cluster addresses).
__device__ __forceinline__ void st_async2(uint32_t addr, float a, float b,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];" ::"r"(addr), "f"(a), "f"(b), "r"(bar) : "memory");
}

// ---- 3xTF32 products (as flash_attention.cu) ----

// cvt.rna.tf32.f32 of a finite x, with two integer operations.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// The bits of a TF32 operand that round x to nearest, ties away: the
// tensor cores read only the top 19 bits of a .tf32 operand, so adding
// half its last place is enough (no mask).
__device__ __forceinline__ uint32_t rna_operand(float x) {
  return __float_as_uint(x) + 0x1000u;
}
// x = big + small, each a TF32 operand in a .b32 register: big = rna(x)
// (masked: x - big must be exact), small = rna(x - big).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = rna_tf32(x);
  small = rna_operand(x - __uint_as_float(big));
}
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragments of m16n8k8 (g = lane / 4, t = lane % 4): A (16 x 8) a0 =
// A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]; B (8 x 8)
// b0 = B[t][g], b1 = B[t+4][g]; C (16 x 8) c0 = C[g][2t], c1 =
// C[g][2t+1], c2 = C[g+8][2t], c3 = C[g+8][2t+1]. Over 16 of dk, a
// thread loads dims 4t .. 4t+3 of its rows as one float4: the first k8
// step takes 4t, 4t+1 as its columns t, t+4, the second 4t+2, 4t+3 (A
// and B alike; the sum over dk is taken in that order).
struct AFrag {  // A of two k8 steps
  uint32_t big[2][4], small[2][4];
};
struct BFrag {  // B of two k8 steps
  uint32_t big[2][2], small[2][2];
};
__device__ __forceinline__ void split_a(const float4& xa, const float4& xb,
                                        AFrag& a) {
  split_tf32(xa.x, a.big[0][0], a.small[0][0]);
  split_tf32(xb.x, a.big[0][1], a.small[0][1]);
  split_tf32(xa.y, a.big[0][2], a.small[0][2]);
  split_tf32(xb.y, a.big[0][3], a.small[0][3]);
  split_tf32(xa.z, a.big[1][0], a.small[1][0]);
  split_tf32(xb.z, a.big[1][1], a.small[1][1]);
  split_tf32(xa.w, a.big[1][2], a.small[1][2]);
  split_tf32(xb.w, a.big[1][3], a.small[1][3]);
}
__device__ __forceinline__ void split_b(const float4& y, BFrag& b) {
  split_tf32(y.x, b.big[0][0], b.small[0][0]);
  split_tf32(y.y, b.big[0][1], b.small[0][1]);
  split_tf32(y.z, b.big[1][0], b.small[1][0]);
  split_tf32(y.w, b.big[1][1], b.small[1][1]);
}
// c[f] += a b[f] over 16 of dk, for F accumulators that the caller
// zeroes. The tensor cores align each product to the accumulator's
// magnitude and drop (truncate) the bits below it, so a product added to
// a large running sum loses its low bits, and the small cross terms of
// the split most of theirs: callers sum each 16-deep block from zero,
// then add it to the running sum in f32, rounded to nearest. The MMAs go
// term by term across the accumulators (an MMA waits 28 cycles for the
// one before it on its accumulator); each accumulator still sums
// small*big, big*small, big*big of step 0, then of step 1.
template <int F>
__device__ __forceinline__ void mma16_all(float (*c)[4], const AFrag& a,
                                          const BFrag* b) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int f = 0; f < F; ++f) mma_tf32(c[f], a.small[s], b[f].big[s][0], b[f].big[s][1]);
#pragma unroll
    for (int f = 0; f < F; ++f) mma_tf32(c[f], a.big[s], b[f].small[s][0], b[f].small[s][1]);
#pragma unroll
    for (int f = 0; f < F; ++f) mma_tf32(c[f], a.big[s], b[f].big[s][0], b[f].big[s][1]);
  }
}

// ---- shared-memory layouts ----

// The 16-byte chunk of a row is stored at chunk ^ sw(row): rows g and
// g + 1 (one quarter warp's float4 loads) fall in different halves of a
// 128-byte line, and rows t = 0..3 (the scalar B loads of the state
// product) in four different quarters.
__device__ __forceinline__ int row_sw(int row) {
  return ((row & 1) << 2) | (row & 2);
}
// (row, col) of a (rows, TK) q or k tile; TK = 16 keeps 4 chunks a row,
// so only the (row & 2) bit applies.
template <int TK>
__device__ __forceinline__ int tile_off(int row, int col) {
  const int sw = TK == 32 ? row_sw(row) : (row & 2);
  return row * TK + ((((col >> 2) ^ sw)) << 2) + (col & 3);
}
// (column, dk) of Ct, dkp floats a row (a multiple of 32).
__device__ __forceinline__ int ct_off(int col, int dk, int dkp) {
  return col * dkp + (((dk >> 2) ^ row_sw(col)) << 2) + (dk & 3);
}

// Stage `rows` rows of a (seq, d) array from row t0, columns c0 ..
// c0 + w - 1, into a tile of `w` columns (rows past `valid` and columns
// past d read as zero). vec: 16-byte cp.async (d % 4 == 0, 16-byte
// aligned base), else scalar loads.
template <int W, typename Off>
__device__ __forceinline__ void stage(float* dst, const float* src, int rows,
                                      int valid, int64_t row0, int d, int c0,
                                      bool vec, Off off) {
  if (vec) {
    constexpr int kChunks = W / 4;
    for (int e = threadIdx.x; e < rows * kChunks; e += kThreads) {
      const int r = e / kChunks, c = 4 * (e % kChunks);
      const bool in = r < valid && c0 + c < d;
      cp_async16(dst + off(r, c), in ? src + (row0 + r) * d + c0 + c : src,
                 in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * W; e += kThreads) {
      const int r = e / W, c = e % W;
      const bool in = r < valid && c0 + c < d;
      dst[off(r, c)] = in ? src[(row0 + r) * d + c0 + c] : 0.0f;
    }
  }
}

// ---- the kernel ----

// Grid: bh * nbp CTAs (nbp = column blocks, padded to a multiple of the
// cluster; a CTA past dv computes its share of the scores only), 1-D,
// clusters of `cluster` consecutive CTAs. NS = score_slots(L, cluster).
template <int L, int TK, int NS>
__global__ void __launch_bounds__(kThreads, 1)
    mlstm_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ lf,
                 float* __restrict__ h_out, float* __restrict__ c_out,
                 float* __restrict__ n_out, int seq, int dk, int dv, int nbp,
                 int cluster, int normalize, int vec) {
  constexpr int MT = L / 16;          // row tiles of a chunk
  constexpr int NQ = MT;              // q.C / P.v column tiles a warp
  constexpr int NST = TK / 16;        // state dk tiles of 8 a warp
  constexpr int KST = k_stages(TK);   // k tiles in the ring
  constexpr int LDP = L + 4;          // row stride of P (4 mod 32)
  constexpr int G = kThreads / L;     // threads a row of q.n
  extern __shared__ __align__(16) float smem[];
  const int dkp = round_up(dk, 32);
  const int np = cluster > 1 ? 2 : 1;
  float* Ct = smem;                        // (64, dkp), swizzled
  float* ns = Ct + (size_t)kDvBlock * dkp;
  float* qs = ns + dkp;                    // 2 x (L, TK)
  float* ks = qs + 2 * L * TK;             // KST x (L, TK)
  float* vs = ks + KST * L * TK;           // (L, kLdv)
  float* ps = vs + L * kLdv;               // np x (L, LDP)
  float* npart = ps + np * L * LDP;        // 2 x (kWarps, TK)
  float* ds = npart + 2 * kWarps * TK;     // d_i
  float* eds = ds + L;                     // exp(d_i)
  float* wts = eds + L;                    // exp(D - d_j)
  float* qns = wts + L;                    // q_i . n_prev
  uint64_t* bars = reinterpret_cast<uint64_t*>(qns + L);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / nbp;
  const int cb = blockIdx.x % nbp;
  const int rank = cb % cluster;
  const int v0 = cb * kDvBlock;
  const float* q_bh = q + (int64_t)bh * seq * dk;
  const float* k_bh = k + (int64_t)bh * seq * dk;
  const float* v_bh = v + (int64_t)bh * seq * dv;
  const float* lf_bh = lf + (int64_t)bh * seq;
  float* h_bh = h_out + (int64_t)bh * seq * dv;
  const int nchunks = (seq + L - 1) / L;
  const int ntiles = dkp / TK;

  // q.C, P.v and the scores: row tile qm; q.C and P.v column tiles nq0
  // .. nq0 + NQ - 1; score column tiles score_tile(.., i), the slots
  // without one repeating tile 0
  const int qm = warp % MT;
  const int nq0 = (warp / MT) * NQ;
  int s_nt[NS];
  bool s_ok[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int e = score_tile(L, cluster, rank, warp, i);
    s_ok[i] = e >= 0;
    s_nt[i] = s_ok[i] ? e : 0;
  }
  // state: columns 16 sm .. 16 sm + 15, dk tiles sn0 .. sn0 + NST - 1
  const int sm = warp & 3;
  const int sn0 = (warp >> 2) * NST;

  for (int idx = tid; idx < kDvBlock * dkp; idx += kThreads) Ct[idx] = 0.0f;
  for (int idx = tid; idx < dkp; idx += kThreads) ns[idx] = 0.0f;
  const int p_bytes = lower_tiles(L) * 16 * 8 * 4;  // P a chunk, every CTA
  const uint32_t bar0 = smem_addr(bars);
  if (cluster > 1) {
    if (tid == 0) {
      bar_init(bar0);
      bar_init(bar0 + 8);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      bar_arm(bar0, p_bytes);                      // chunk 0
      if (nchunks > 1) bar_arm(bar0 + 8, p_bytes);  // chunk 1
    }
    // every CTA's barriers are armed before a peer stores into it
    cluster_sync();
  }

  auto q_off = [](int r, int c) { return tile_off<TK>(r, c); };
  auto v_off = [](int r, int c) { return r * kLdv + c; };
  // q, k tile kt of the chunk from step t0 (nvalid steps) into its stages
  auto issue = [&](int kt, int t0, int nvalid) {
    stage<TK>(qs + (kt & 1) * L * TK, q_bh, L, nvalid, t0, dk, kt * TK, vec, q_off);
    stage<TK>(ks + (kt % KST) * L * TK, k_bh, L, nvalid, t0, dk, kt * TK, vec, q_off);
    cp_async_commit();
  };
  auto issue_v = [&](int t0, int nvalid) {
    stage<kDvBlock>(vs, v_bh, L, nvalid, t0, dv, v0, vec, v_off);
    cp_async_commit();
  };
  // the first chunk's first tile, v and lf (each later chunk's are
  // fetched during the chunk before it)
  issue(0, 0, min(L, seq));
  issue_v(0, min(L, seq));
  float lf_next = tid < min(L, seq) ? lf_bh[tid] : 0.0f;

  for (int ch = 0; ch < nchunks; ++ch) {
    const int t0 = ch * L;
    const int nvalid = min(L, seq - t0);
    __syncthreads();  // the previous chunk's readers of ds .. ps are done

    if (tid < L) ds[tid] = lf_next;  // d_i
    __syncthreads();
    if (tid < 32) {  // inclusive cumulative sum (warp 0)
      constexpr int kPer = (L + 31) / 32;
      float local[kPer];
      float run = 0.0f;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int idx = tid * kPer + e;
        run += idx < L ? ds[idx] : 0.0f;
        local[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float y = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += y;
      }
      const float excl = incl - run;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int idx = tid * kPer + e;
        if (idx < L) ds[idx] = local[e] + excl;
      }
    }
    __syncthreads();
    if (tid < L) {
      eds[tid] = expf(ds[tid]);
      wts[tid] = expf(ds[L - 1] - ds[tid]);
    }
    const float eD = expf(ds[L - 1]);

    float qc[NQ][4], sacc[NS][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) qc[n][e] = 0.0f;
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[i][e] = 0.0f;
    float qn = 0.0f;
    const int qn_row = tid / G, qn_lane = tid % G;

    // n of tile kt from its partial sums
    auto reduce_n = [&](int kt) {
      if (tid < TK) {
        const float* part = npart + (kt & 1) * kWarps * TK;
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += part[w * TK + tid];
        ns[kt * TK + tid] = eD * ns[kt * TK + tid] + s;
      }
    };
    // q.C (the old C), the scores and q.n of tile kt
    auto products = [&](int kt) {
      const int k0 = kt * TK;
      const float* qb = qs + (kt & 1) * L * TK;
      const float* kb = ks + (kt % KST) * L * TK;
#pragma unroll
      for (int kc = 0; kc < TK; kc += 16) {
        AFrag a;
        const int r = 16 * qm + g;
        split_a(*reinterpret_cast<const float4*>(qb + tile_off<TK>(r, kc + 4 * t)),
                *reinterpret_cast<const float4*>(qb + tile_off<TK>(r + 8, kc + 4 * t)),
                a);
        BFrag b[NQ + NS];  // q.C's column tiles, then the score tiles
#pragma unroll
        for (int n = 0; n < NQ; ++n)
          split_b(*reinterpret_cast<const float4*>(
                      Ct + ct_off(8 * (nq0 + n) + g, k0 + kc + 4 * t, dkp)),
                  b[n]);
#pragma unroll
        for (int i = 0; i < NS; ++i)
          split_b(*reinterpret_cast<const float4*>(
                      kb + tile_off<TK>(8 * s_nt[i] + g, kc + 4 * t)),
                  b[NQ + i]);
        float blk[NQ + NS][4];
#pragma unroll
        for (int f = 0; f < NQ + NS; ++f)
#pragma unroll
          for (int e = 0; e < 4; ++e) blk[f][e] = 0.0f;
        mma16_all<NQ + NS>(blk, a, b);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int n = 0; n < NQ; ++n) qc[n][e] += blk[n][e];
#pragma unroll
          for (int i = 0; i < NS; ++i) sacc[i][e] += blk[NQ + i][e];
        }
      }
#pragma unroll
      for (int kk = qn_lane; kk < TK; kk += G)
        qn = fmaf(qb[tile_off<TK>(qn_row, kk)], ns[k0 + kk], qn);
    };
    // state of tile kt: Ct[:, tile] = exp(D) Ct[:, tile] + v^T (w k)[:, tile],
    // the product summed from zero (see mma16) in two interleaved halves
    // of the chunk's steps, then added in f32; n's partial sums
    auto state = [&](int kt) {
      const int k0 = kt * TK;
      const float* kb = ks + (kt % KST) * L * TK;
      float acc[2][NST][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int i = 0; i < NST; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[hh][i][e] = 0.0f;
      // two steps of 8 a round, each into its own set: consecutive MMAs go
      // to the 2 NST accumulators in turn (see mma16_all)
#pragma unroll
      for (int kk0 = 0; kk0 < L / 8; kk0 += 2) {
        uint32_t ab[2][4], as[2][4], bb[2][NST][2], bs[2][NST][2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int kk = kk0 + hh;
          const int j0 = 8 * kk + t, j1 = j0 + 4;
          const float w0 = wts[j0], w1 = wts[j1];
          const float* va = vs + j0 * kLdv + 16 * sm + g;
          const float* vb = vs + j1 * kLdv + 16 * sm + g;
          split_tf32(va[0], ab[hh][0], as[hh][0]);
          split_tf32(va[8], ab[hh][1], as[hh][1]);
          split_tf32(vb[0], ab[hh][2], as[hh][2]);
          split_tf32(vb[8], ab[hh][3], as[hh][3]);
#pragma unroll
          for (int i = 0; i < NST; ++i) {
            const int col = 8 * (sn0 + i) + g;
            split_tf32(kb[tile_off<TK>(j0, col)] * w0, bb[hh][i][0], bs[hh][i][0]);
            split_tf32(kb[tile_off<TK>(j1, col)] * w1, bb[hh][i][1], bs[hh][i][1]);
          }
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int i = 0; i < NST; ++i)
            mma_tf32(acc[hh][i], as[hh], bb[hh][i][0], bb[hh][i][1]);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int i = 0; i < NST; ++i)
            mma_tf32(acc[hh][i], ab[hh], bs[hh][i][0], bs[hh][i][1]);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int i = 0; i < NST; ++i)
            mma_tf32(acc[hh][i], ab[hh], bb[hh][i][0], bb[hh][i][1]);
      }
#pragma unroll
      for (int i = 0; i < NST; ++i) {
        const int d = k0 + 8 * (sn0 + i) + 2 * t;
        float2* c01 = reinterpret_cast<float2*>(Ct + ct_off(16 * sm + g, d, dkp));
        float2* c23 = reinterpret_cast<float2*>(Ct + ct_off(16 * sm + g + 8, d, dkp));
        const float2 o01 = *c01, o23 = *c23;
        *c01 = make_float2(fmaf(eD, o01.x, acc[0][i][0] + acc[1][i][0]),
                           fmaf(eD, o01.y, acc[0][i][1] + acc[1][i][1]));
        *c23 = make_float2(fmaf(eD, o23.x, acc[0][i][2] + acc[1][i][2]),
                           fmaf(eD, o23.y, acc[0][i][3] + acc[1][i][3]));
      }
      // n's partial sums: warp w sums rows w L/8 .. of w k
      constexpr int kRows = L / kWarps;
      float* part = npart + (kt & 1) * kWarps * TK;
      float s = 0.0f;
      if constexpr (TK == 32) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int j = warp * kRows + r;
          s = fmaf(kb[tile_off<TK>(j, lane)], wts[j], s);
        }
        part[warp * TK + lane] = s;
      } else {
        const int half = lane >> 4, col = lane & 15;
#pragma unroll
        for (int r = 0; r < kRows / 2; ++r) {
          const int j = warp * kRows + half * (kRows / 2) + r;
          s = fmaf(kb[tile_off<TK>(j, col)], wts[j], s);
        }
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (half == 0) part[warp * TK + col] = s;
      }
    };
    // One barrier phase: tile kt's products beside tile kt - 1's state
    // update (straight-line code, so their chains interleave). The ring
    // of three k stages lets tile kt + 1's copy start at once; with two
    // it starts after a second barrier.
    auto step = [&](int kt, auto with_products, auto with_state) {
      cp_async_wait_all();
      __syncthreads();  // tile kt has landed; the last phase is done
      if constexpr (KST == 3) {
        if (kt + 1 < ntiles) issue(kt + 1, t0, nvalid);
      }
      if (kt >= 2) reduce_n(kt - 2);
      if constexpr (decltype(with_products)::value) products(kt);
      if constexpr (decltype(with_state)::value) state(kt - 1);
      if constexpr (KST == 2) {
        __syncthreads();  // every reader of tile kt - 1's k stage is done
        if (kt + 1 < ntiles) issue(kt + 1, t0, nvalid);
      }
    };
    step(0, std::true_type{}, std::false_type{});
    for (int kt = 1; kt < ntiles; ++kt) step(kt, std::true_type{}, std::true_type{});
    step(ntiles, std::false_type{}, std::true_type{});
    __syncthreads();  // the last tile's partial sums are in
    reduce_n(ntiles - 1);
    const int t0n = t0 + L, nvalid_n = min(L, seq - t0n);
    if (ch + 1 < nchunks) {  // the next chunk's first tile and lf, now
      issue(0, t0n, nvalid_n);
      lf_next = tid < nvalid_n ? lf_bh[t0n + tid] : 0.0f;
    }
#pragma unroll
    for (int off = G / 2; off > 0; off /= 2)
      qn += __shfl_xor_sync(0xffffffffu, qn, off);
    if (qn_lane == 0) qns[qn_row] = qn;

    // this warp's score tiles, decayed and masked, into every CTA's P
    float* pb = ps + (np == 2 ? (ch & 1) : 0) * L * LDP;
    const int r0 = 16 * qm + g;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      if (!s_ok[i]) continue;
      const int j0 = 8 * s_nt[i] + 2 * t;
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + 8 * (e >> 1), col = j0 + (e & 1);
        p[e] = col <= row ? sacc[i][e] * expf(ds[row] - ds[col]) : 0.0f;
      }
      float* p01 = pb + r0 * LDP + j0;
      float* p23 = p01 + 8 * LDP;
      if (cluster == 1) {
        *reinterpret_cast<float2*>(p01) = make_float2(p[0], p[1]);
        *reinterpret_cast<float2*>(p23) = make_float2(p[2], p[3]);
      } else {
        const uint32_t a01 = smem_addr(p01), a23 = smem_addr(p23);
        const uint32_t bar = bar0 + 8 * (ch & 1);
        for (int dst = 0; dst < cluster; ++dst) {
          const uint32_t pbar = map_rank(bar, dst);
          st_async2(map_rank(a01, dst), p[0], p[1], pbar);
          st_async2(map_rank(a23, dst), p[2], p[3], pbar);
        }
      }
    }
    __syncthreads();  // q.n and (alone) P are in
    if (cluster > 1) {
      const uint32_t bar = bar0 + 8 * (ch & 1);
      bar_wait(bar, (ch >> 1) & 1);  // every CTA's share of P has landed
      // re-arm for chunk ch + 2: its stores come only after every CTA of
      // the cluster has received this CTA's share of chunk ch + 1
      if (tid == 0 && ch + 2 < nchunks) bar_arm(bar, p_bytes);
    }

    // denominators of this warp's 16 rows: lane pairs sum a row's P
    float den_g = 1.0f, den_g8 = 1.0f;
    if (normalize) {
      const int row = 16 * qm + (lane >> 1);
      float rs = 0.0f;
      for (int j = lane & 1; j <= row; j += 2) rs += pb[row * LDP + j];
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      const float den = fmaxf(fabsf(rs + eds[row] * qns[row]), 1.0f);
      den_g = __shfl_sync(0xffffffffu, den, 2 * g);
      den_g8 = __shfl_sync(0xffffffffu, den, 2 * g + 16);
    }

    // h = (P v + exp(d_i) q_i C) / den_i
    const float ed0 = eds[r0], ed1 = eds[r0 + 8];
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      qc[n][0] *= ed0;
      qc[n][1] *= ed0;
      qc[n][2] *= ed1;
      qc[n][3] *= ed1;
    }
    // P v in blocks of 16 steps, each summed from zero (see mma16); P is
    // 0 above the diagonal block
#pragma unroll
    for (int kb2 = 0; kb2 < MT; ++kb2) {
      if (kb2 > qm) break;
      float blk[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) blk[n][e] = 0.0f;
      AFrag a;  // P rows r0, r0 + 8 at steps 16 kb2 .. 16 kb2 + 15
      BFrag b[NQ];
#pragma unroll
      for (int hs = 0; hs < 2; ++hs) {
        const float* pa = pb + r0 * LDP + 8 * (2 * kb2 + hs) + t;
        split_tf32(pa[0], a.big[hs][0], a.small[hs][0]);
        split_tf32(pa[8 * LDP], a.big[hs][1], a.small[hs][1]);
        split_tf32(pa[4], a.big[hs][2], a.small[hs][2]);
        split_tf32(pa[8 * LDP + 4], a.big[hs][3], a.small[hs][3]);
        const float* vr0 = vs + (8 * (2 * kb2 + hs) + t) * kLdv + g;
        const float* vr1 = vr0 + 4 * kLdv;
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          split_tf32(vr0[8 * (nq0 + n)], b[n].big[hs][0], b[n].small[hs][0]);
          split_tf32(vr1[8 * (nq0 + n)], b[n].big[hs][1], b[n].small[hs][1]);
        }
      }
      mma16_all<NQ>(blk, a, b);
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) qc[n][e] += blk[n][e];
    }
    if (ch + 1 < nchunks) {  // every reader of v is done: the next chunk's
      __syncthreads();
      issue_v(t0n, nvalid_n);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + 8 * hh;
      if (row >= nvalid) continue;
      const float den = hh ? den_g8 : den_g;
      float* hrow = h_bh + (int64_t)(t0 + row) * dv;
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const int col = v0 + 8 * (nq0 + n) + 2 * t;
        const float x0 = qc[n][2 * hh] / den, x1 = qc[n][2 * hh + 1] / den;
        if (vec) {
          if (col < dv) *reinterpret_cast<float2*>(hrow + col) = make_float2(x0, x1);
        } else {
          if (col < dv) hrow[col] = x0;
          if (col + 1 < dv) hrow[col + 1] = x1;
        }
      }
    }
  }
  __syncthreads();

  if (c_out != nullptr) {
    float* c_bh = c_out + (int64_t)bh * dk * dv;
    for (int idx = tid; idx < dk * kDvBlock; idx += kThreads) {
      const int row = idx / kDvBlock, col = idx % kDvBlock;
      if (v0 + col < dv)
        c_bh[(int64_t)row * dv + v0 + col] = Ct[ct_off(col, row, dkp)];
    }
  }
  if (n_out != nullptr && cb == 0)
    for (int idx = tid; idx < dk; idx += kThreads)
      n_out[(int64_t)bh * dk + idx] = ns[idx];
}

// ---- host side: the plan, occupancy, launch ----

constexpr int kClusters[4] = {1, 2, 4, 8};

// The partition of a call.
struct Plan {
  int cluster;    // CTAs a cluster: 1, 2, 4 or 8 (0: no plan)
  int tk;         // dk a q / k tile: 32 or 16
  int blocks;     // column blocks of 64 a (b, h)
  int blocks_pad; // blocks rounded up to the cluster
  int ctas;       // bh * blocks_pad
  int clusters;   // ctas / cluster
  int waves;      // clusters over the clusters the card holds at once
  int smem;       // dynamic shared memory bytes a CTA
};

// The plan of (bh, dk, dv) at chunk L, given active[i] = the clusters of
// kClusters[i] CTAs (of this L and that size's TK and shared memory)
// the card holds at once (0: none, or not asked): at L = kShareChunk, the
// largest cluster of 2, 4, 8 that is at most the column blocks, fits in
// shared memory, and whose grid takes no more waves than the
// cluster-free grid; else (and at every other L) 1. Returns a plan with
// cluster 0 when nothing fits.
Plan make_plan(int bh, int dk, int dv, int L, const int active[4]) {
  Plan p{};
  p.blocks = (dv + kDvBlock - 1) / kDvBlock;
  auto shape = [&](int c) {
    Plan x = p;
    x.cluster = c;
    x.tk = pick_tk(L, dk, c);
    x.blocks_pad = round_up(p.blocks, c);
    x.ctas = bh * x.blocks_pad;
    x.clusters = x.ctas / c;
    x.smem = (int)smem_bytes_tk(L, dk, x.tk ? x.tk : 16, c);
    return x;
  };
  auto ok = [&](int i) {
    const int c = kClusters[i];
    return (c == 1 || (L == kShareChunk && c <= p.blocks)) &&
           pick_tk(L, dk, c) != 0 && active[i] >= 1;
  };
  auto waves = [&](int i, const Plan& x) {
    return (x.clusters + active[i] - 1) / active[i];
  };
  if (!ok(0)) return p;
  Plan best = shape(1);
  best.waves = waves(0, best);
  const int waves1 = best.waves;
  for (int i = 1; i < 4; ++i) {
    if (!ok(i)) continue;
    Plan x = shape(kClusters[i]);
    x.waves = waves(i, x);
    if (x.waves <= waves1) best = x;
  }
  return best;
}

template <int N>
using Int = std::integral_constant<int, N>;

// The kernel instance of (L, TK, the score slots of `cluster`), for a
// function of Int<L>, Int<TK>, Int<NS>; cudaErrorInvalidValue for another.
// Only chunk kShareChunk is built for clusters of more than one CTA.
template <int TK, typename F>
int with_slots(int L, int cluster, F&& f) {
  static_assert(kShareChunk == 64, "the instances below share chunk 64's scores");
  if (cluster > 1 && L != kShareChunk) return (int)cudaErrorInvalidValue;
  const int ns = score_slots(L, cluster);
  switch (L) {
    case 16: return f(Int<16>{}, Int<TK>{}, Int<score_slots(16, 1)>{});
    case 32: return f(Int<32>{}, Int<TK>{}, Int<score_slots(32, 1)>{});
    case 64:
      if (ns == score_slots(64, 1)) return f(Int<64>{}, Int<TK>{}, Int<score_slots(64, 1)>{});
      if (ns == score_slots(64, 2)) return f(Int<64>{}, Int<TK>{}, Int<score_slots(64, 2)>{});
      return f(Int<64>{}, Int<TK>{}, Int<score_slots(64, 4)>{});
    case 128: return f(Int<128>{}, Int<TK>{}, Int<score_slots(128, 1)>{});
  }
  return (int)cudaErrorInvalidValue;
}
template <typename F>
int with_kernel(int L, int tk, int cluster, F&& f) {
  if (tk == 32) return with_slots<32>(L, cluster, f);
  if (tk == 16) return with_slots<16>(L, cluster, f);
  return (int)cudaErrorInvalidValue;
}

// The launch configuration of a plan; the cluster shape as an attribute
// when the cluster has more than one CTA.
struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  Launch(int cluster, int ctas, int smem, cudaStream_t stream) : cfg{} {
    cfg.gridDim = dim3((unsigned)ctas);
    cfg.blockDim = dim3((unsigned)kThreads);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = cluster > 1 ? 1 : 0;
  }
};

// Raise a kernel's dynamic shared-memory limit to the most a block may
// have, on the current device: a call of another shape may lower it, so
// before every occupancy query and launch.
template <typename K>
int allow_smem(K kern) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
}

// How many clusters of `cluster` CTAs of the (L, tk) kernel with `smem`
// bytes the current device holds at once, cached per (device, L, tk,
// cluster, smem).
int active_clusters(int L, int tk, int cluster, int smem, int* active) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int, int, int>, int> cache;
  int device = 0;
  int err = (int)cudaGetDevice(&device);
  if (err != 0) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(device, L, tk, cluster, smem);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *active = hit->second;
    return 0;
  }
  err = with_kernel(L, tk, cluster, [&](auto l, auto k, auto ns) {
    auto kern = mlstm_kernel<decltype(l)::value, decltype(k)::value,
                             decltype(ns)::value>;
    int e = allow_smem(kern);
    if (e != 0) return e;
    if (cluster == 1) {
      int per_sm = 0, sms = 0;
      e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                             kThreads, smem);
      if (e != 0) return e;
      e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device);
      *active = per_sm * sms;
      return e;
    }
    Launch l1(cluster, cluster, smem, nullptr);
    return (int)cudaOccupancyMaxActiveClusters(active, kern, &l1.cfg);
  });
  if (err != 0) return err;
  cache[key] = *active;
  return 0;
}

// The plan of a call on the current device, with active[] filled for
// the cluster sizes the plan considered (0 for the others).
int plan_call(int bh, int dk, int dv, int L, Plan* out, int active[4]) {
  const int blocks = (dv + kDvBlock - 1) / kDvBlock;
  for (int i = 0; i < 4; ++i) {
    active[i] = 0;
    const int c = kClusters[i];
    if (c > 1 && (L != kShareChunk || c > blocks)) continue;
    const int tk = pick_tk(L, dk, c);
    if (tk == 0) continue;
    const int err = active_clusters(
        L, tk, c, (int)smem_bytes_tk(L, dk, tk, c), &active[i]);
    if (err != 0) return err;
  }
  *out = make_plan(bh, dk, dv, L, active);
  return 0;
}

int launch(const float* q, const float* k, const float* v, const float* lf,
           float* h, float* c, float* n, int bh, int seq, int dk, int dv,
           int chunk, int normalize, cudaStream_t stream) {
  if (bh < 1 || seq < 1 || dk < 1 || dv < 1) return (int)cudaErrorInvalidValue;
  if (chunk != 16 && chunk != 32 && chunk != 64 && chunk != 128)
    return (int)cudaErrorInvalidValue;
  Plan p;
  int active[4];
  int err = plan_call(bh, dk, dv, chunk, &p, active);
  if (err != 0) return err;
  if (p.cluster == 0) {
    // nothing fits: too much shared memory, or no CTA the card holds
    return pick_tk(chunk, dk, 1) == 0 ? (int)cudaErrorInvalidValue
                                      : kClusterUnschedulable;
  }
  if ((int64_t)bh * p.blocks_pad > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int vec = dk % 4 == 0 && dv % 4 == 0 &&
                  ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(h)) %
                   16) == 0;
  Launch l(p.cluster, p.ctas, p.smem, stream);
  err = with_kernel(chunk, p.tk, p.cluster, [&](auto lc, auto kc, auto ns) {
    auto kern = mlstm_kernel<decltype(lc)::value, decltype(kc)::value,
                             decltype(ns)::value>;
    const int e = allow_smem(kern);
    if (e != 0) return e;
    return (int)cudaLaunchKernelEx(&l.cfg, kern, q, k, v, lf, h, c, n, seq,
                                   dk, dv, p.blocks_pad, p.cluster, normalize,
                                   vec);
  });
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes.
//
// mlstm_scan_f32: q, k contiguous (bh, seq, dk), v (bh, seq, dv), lf
// (bh, seq), h out (bh, seq, dv); c out (bh, dk, dv) and n out (bh, dk),
// each may be null (not written). All f32 on the device of `stream`;
// chunk is 16, 32, 64 or 128. The cluster size is the plan's. Returns
// cudaGetLastError() after the launch, a CUDA error of the set-up, or -1
// when the card cannot hold one cluster of the plan.
extern "C" int mlstm_scan_f32(const void* q, const void* k, const void* v,
                              const void* lf, void* h, void* c, void* n,
                              int bh, int seq, int dk, int dv, int chunk,
                              int normalize, void* stream) {
  return launch(static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<const float*>(lf),
                static_cast<float*>(h), static_cast<float*>(c),
                static_cast<float*>(n), bh, seq, dk, dv, chunk, normalize,
                static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory bytes of one CTA at chunk and dk in a cluster of
// `cluster` CTAs (with the TK the kernel picks), or -1 where nothing
// fits.
extern "C" int mlstm_smem_bytes(int chunk, int dk, int cluster) {
  if (dk < 1 || cluster < 1) return -1;
  const int tk = pick_tk(chunk, dk, cluster);
  return tk == 0 ? -1 : (int)smem_bytes_tk(chunk, dk, tk, cluster);
}

// The column tile of score slot `slot` of warp `warp` of cluster rank
// `rank` at chunk and cluster (score_tile, as the kernel deals them), or
// -1 where the slot holds none; -2 for a chunk or cluster the kernel is
// not built for, or a rank, warp or slot out of range.
extern "C" int mlstm_score_tile(int chunk, int cluster, int rank, int warp,
                                int slot) {
  if ((chunk != 16 && chunk != 32 && chunk != 64 && chunk != 128) ||
      (cluster != 1 && (chunk != kShareChunk ||
                        (cluster != 2 && cluster != 4 && cluster != 8))) ||
      rank < 0 || rank >= cluster || warp < 0 || warp >= kWarps || slot < 0 ||
      slot >= score_slots(chunk, cluster))
    return -2;
  return score_tile(chunk, cluster, rank, warp, slot);
}

// The plan of a call on the current device, for the launcher's tests and
// chip_smoke.py: out[0..7] = cluster, tk, blocks, blocks_pad, ctas,
// clusters, waves, smem; out[8..11] = the clusters of 1, 2, 4 and 8 CTAs
// the device holds at once (0 where not asked). Returns 0 or a CUDA
// error (out[0] = 0 when nothing fits).
extern "C" int mlstm_scan_plan(int bh, int dk, int dv, int chunk, int* out) {
  if (bh < 1 || dk < 1 || dv < 1 ||
      (chunk != 16 && chunk != 32 && chunk != 64 && chunk != 128))
    return (int)cudaErrorInvalidValue;
  Plan p;
  int active[4];
  const int err = plan_call(bh, dk, dv, chunk, &p, active);
  if (err != 0) return err;
  const int fields[8] = {p.cluster, p.tk,       p.blocks, p.blocks_pad,
                         p.ctas,    p.clusters, p.waves,  p.smem};
  for (int i = 0; i < 8; ++i) out[i] = fields[i];
  for (int i = 0; i < 4; ++i) out[8 + i] = active[i];
  return 0;
}
