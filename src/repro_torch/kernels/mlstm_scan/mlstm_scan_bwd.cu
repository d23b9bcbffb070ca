// Backward of the chunkwise gated linear scan (the mLSTM cell of xLSTM,
// and the Mamba-2 heads with normalize off) in f32, on the tensor cores.
//
// Replaces no TPU kernel: the reference differentiates its XLA
// gated_linear_scan (src/repro/models/recurrent.py:28-112) with jax.grad,
// and its Pallas scan (src/repro/kernels/mlstm_scan/mlstm_scan.py:88)
// has no backward. Forward, per (b, h), with the per-step log decay
// lf_t <= 0 and b_t = lf_0 + .. + lf_t:
//   h^_t = q_t [C_t | n_t],  C_t = sum_{s<=t} exp(b_t - b_s) k_s v_s^T,
//   n_t the same with v = 1;  h_t = h^_t[:dv] / max(|h^_t[dv]|, 1)
// (h_t = h^_t[:dv] without normalize). The normalizer is one more value
// column, so the normalize step's backward is elementwise per row (du =
// dh / den, ds = -(dh . h) / den * sign(s) [|s| >= 1], torch.abs /
// clamp_min's derivative), and what is left is the backward of the
// unnormalized scan with v~ = [v | 1], dh~ = [du | ds]:
//   dq_t = sum_{s<=t} exp(b_t - b_s) (dh~_t . v~_s) k_s
//   dk_j = sum_{i>=j} exp(b_i - b_j) (v~_j . dh~_i) q_i
//   dv_j = sum_{i>=j} exp(b_i - b_j) (k_j . q_i) du_i
// three gated linear scans, the first causal, the other two anti-causal,
// and dlf_s = sum_{t>=s} (q_t . dq_t - k_t . dk_t) (the scalar-gate
// identity of Gated Linear Attention and Mamba-2's SSD backward).
//
// Chunkwise, per (b, h) and chunk c of L = 64 steps (d_i the in-chunk
// cumulative log decay, D = d_{L-1}), with the forward state before the
// chunk F_c = sum_{s<t0} exp(b_{t0-1} - b_s) k_s v~_s^T (dk x P, P = dv
// (+ 1); its column dv is the normalizer's n) and the gradient state
// after it R_c = sum_{s>t1} exp(b_s - b_{t1}) q_s dh~_s^T (dk x P):
//   dq = P_A k + exp(d) (dh~ F_c^T)
//   dk = P_A^T q + exp(D - d) (v~ R_c^T)
//   dv = P_Q^T du + exp(D - d) (k R_c[:, :dv])
// where P_A[r, s] = (dh~_r . v~_s) exp(d_r - d_s) and P_Q[r, s] = (q_r .
// k_s) exp(d_r - d_s) for s <= r, else 0 (masked BEFORE the exponent:
// above the diagonal it is positive and may overflow). The dk scan's
// scores are the transpose of the dq scan's, the dv scan's are the
// forward's, and dk and dv read one state: a chunk has two score
// matrices and two states.
//
// Bound: operations. Per (b, h) and chunk of L, with P = dv + 1 (dv
// without normalize): the two score matrices L(L+1) (P + dk), the three
// in-chunk sums L(L+1) (2 dk + dv), and in every chunk but the first of
// each sweep 2 L P dk (q.C, twice) + 2 L dk dv, as many again for the
// state updates of every chunk but the last (chip_smoke.py's
// mlstm_bwd_flops, the count of the chunkwise form whatever implements
// it). At (8, 4, 128, 512, 512), normalize on: 7.16 GFLOP, 0.0434 ms at
// the 3xTF32 rate of the tensor cores (three TF32 products for each f32
// one at 495 TFLOP/s), against 67 MB of HBM traffic (0.020 ms); at
// hymba's Mamba heads (2, 25, 2048, 16, 64) 2.40 GFLOP but 106 MB, so
// bytes: 0.0315 ms.
//
// Design: chunk-parallel, five launches of four kernels.
// 1. mlstm_bwd_state (forward): each CTA one (b, h), chunk c < nc - 1 and
//    64 x 64 tile of the dk x P state: the chunk's summary U_c = sum_s
//    exp(D - d_s) k_s v~_s^T into slot c of F; the last CTA of a (b, h,
//    tile) to finish (an integer counter; no float atomics) turns the
//    slots into the states in place, F_{c+1} = exp(D_c) F_c + U_c, each
//    entry's sum over chunks in chunk order.
// 2. mlstm_bwd_scores: each CTA one (b, h), chunk and score matrix: the
//    raw dh v^T (over dv) or q k^T (over dk), 64 x 64, into scratch, so
//    that each is computed once per (b, h), whatever the columns that read
//    it. With normalize the q k^T CTA also does the normalize step: q_t .
//    n_t is the row sum of the chunk's decayed q k^T plus exp(d_t) q_t .
//    n (n from F's column dv), then den, du = dh / den, ds.
// 3. mlstm_bwd_state (reverse): the same for R, V_c = sum_s exp(d_s) q_s
//    dh~_s^T for chunks c >= 1, R_{c-1} = exp(D_c) R_c + V_c.
// 4. mlstm_bwd_chunk: each CTA of 16 warps one (b, h), chunk and 64
//    columns of dq, dk and dv (a narrow head, dk = 16, gives its 16
//    columns to 8 of them): the three inter-chunk products in one
//    double-buffered cp.async pipeline of 32-wide slices of the reduction
//    axis, while the chunk's scores and its k, q and du columns, fetched
//    first, arrive. Then the scores decayed and masked in shared memory (with
//    normalize P_A = (dh v^T / den + ds) decayed), the three in-chunk
//    products over their triangles, and each row's q . dq - k . dk over
//    the CTA's columns into scratch.
// 5. mlstm_bwd_dlogf: one CTA a (b, h): those partial sums summed over the
//    column tiles in order, then the suffix sum over S as a block scan of
//    1024 steps at a time with a carried total.
// Every product is 3xTF32 mma.sync.m16n8k8 (x = big + small, each a TF32
// value; small*big + big*small + big*big) with f32 accumulators, each
// 16-deep block summed from zero and added in f32 (tf32_mma.cuh); plain
// TF32 would break mlstm_grad_error_bound. Of a CTA of W warps, a warp
// owns one 16-row tile and every (W / 4)-th 8-column tile of each output
// (m = warp % 4, n = warp / 4 + W / 4 i), so that narrow outputs still
// reach most warps. The in-chunk cumulative decay is one warp's scan.
// Every sum runs in a fixed order, so two calls give the same bits.
//
// What holds it back (PERF.md §6, tools/torch_bwd_ablation.py): moving
// data more than the products. Without its MMAs a call takes about 0.25
// of its 0.39 ms at xlstm's shape and 0.29 of 0.42 at hymba's. The chunk
// kernel, about 0.21 ms at xlstm's shape, stages the chunk's dh~, v~ and
// k rows again for each of its 64-column tiles (8 at dk = 512) and holds
// one CTA an SM (130 KB of shared memory); the states make a round trip
// through HBM (dk x P floats a chunk boundary, twice), the two state
// launches about 0.11 ms at both shapes; so do the scores (2 x 64 x 64
// floats a chunk), which at hymba's shape, one column tile a chunk, cost
// about 0.06 ms a call against computing them in the chunk CTAs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;     // a state, score and dlogf CTA
constexpr int kWarps = kThreads / 32;
constexpr int kWideWarps = 16;    // a score or chunk CTA
constexpr int kWideThreads = 32 * kWideWarps;
constexpr int kL = 64;            // chunk: time rows
constexpr int kTile = 64;         // output columns (and state tile rows) a CTA
constexpr int kTK = 32;           // reduction slice of the staged products
constexpr int kLda = kTK + 4;     // stride of (rows, 32) tiles (4 mod 32)
constexpr int kLdb = kTile + 8;   // stride of (rows, 64) tiles (8 mod 32)
constexpr int kStageA = kL * kLda;          // one A slice, (64, 32)
constexpr int kStage = 2 * kStageA;         // A and B slices of one stage
constexpr int kWide = kL * kLdb;            // one (64, 64) tile
constexpr int kRing = 2;          // stages of the slice pipeline
constexpr int kScan = 1024;       // steps of one block scan of dlog_f

__host__ __device__ constexpr int ceil_div(int x, int m) { return (x + m - 1) / m; }
__host__ __device__ constexpr int64_t round4(int64_t x) { return (x + 3) / 4 * 4; }

// Dynamic shared memory of a chunk CTA: the ring of the inter-chunk
// products' slices, the scores (P_A, P_Q), the k, q and du column tiles,
// five rows of per-step values and two of the states' column dv.
constexpr int kChunkSmem = 4 * (kRing * kStage + 5 * kWide + 7 * kL);
// A state CTA: the a and b tiles, the decays and weights.
constexpr int kStateSmem = 4 * (2 * kWide + 2 * kL);
// A score CTA: the ring of its a and b slices, the decays, four rows of
// partial row sums.
constexpr int kScoreSmem = 4 * (kRing * kStage + 5 * kL);

// One operand: rows of `dim` floats (row r at x + r dim), plus one more
// column where mode is kOnes (1 everywhere) or kExtra (extra[r]); zero
// past it. vec: dim % 4 == 0 and x 16-byte aligned (cp.async).
enum { kNone = 0, kOnes = 1, kExtra = 2 };
struct Operand {
  const float* x;
  const float* extra;
  int dim;
  int mode;
  int vec;
};

__device__ __forceinline__ float op_value(const Operand& o, int64_t row, int col) {
  if (col < o.dim) return o.x[row * o.dim + col];
  if (col == o.dim) {
    if (o.mode == kOnes) return 1.0f;
    if (o.mode == kExtra) return o.extra[row];
  }
  return 0.0f;
}

// Stage `rows` rows of `o` from row `row0` (rows from `valid` on read as
// zero), columns c0 .. c0 + W - 1, into a tile of stride ld: 16-byte
// cp.async where a whole 4-float group lies inside the operand's rows,
// else plain loads and stores (the extra column, the ragged edges).
template <int W>
__device__ __forceinline__ void stage(float* dst, int ld, const Operand& o,
                                      int64_t row0, int valid, int c0, int rows) {
  constexpr int kChunks = W / 4;
  for (int e = threadIdx.x; e < rows * kChunks; e += blockDim.x) {
    const int r = e / kChunks, c = 4 * (e % kChunks), col = c0 + c;
    float* d = dst + r * ld + c;
    if (r < valid && o.vec && col + 4 <= o.dim) {
      cp_async16(d, o.x + (row0 + r) * o.dim + col, 16);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] = r < valid ? op_value(o, row0 + r, col + i) : 0.0f;
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;  // lane 0's is the sum
}

// The in-chunk inclusive cumulative log decay of chunk t0 (steps past
// `valid` add 0), by one warp: lane l holds steps 2l and 2l + 1. Every
// kernel computes a chunk's decays with it, so they agree bit for bit.
__device__ __forceinline__ void warp_decays(const float* lf, int t0, int valid,
                                            int lane, float& d0, float& d1) {
  const float a = 2 * lane < valid ? lf[t0 + 2 * lane] : 0.0f;
  const float b = 2 * lane + 1 < valid ? lf[t0 + 2 * lane + 1] : 0.0f;
  float incl = a + b;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const float y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0f;
  d0 = excl + a;
  d1 = d0 + b;
}

// d[i] for the chunk (warp 0); the caller synchronizes.
__device__ __forceinline__ void chunk_decays(const float* lf, int t0, int valid, float* d) {
  if (threadIdx.x < 32) {
    float d0, d1;
    warp_decays(lf, t0, valid, threadIdx.x, d0, d1);
    d[2 * threadIdx.x] = d0;
    d[2 * threadIdx.x + 1] = d1;
  }
}

// The A fragment of the transposed tile (A[m][k] = tile[k][m]): rows r0 +
// g, r0 + g + 8 and k k0 + t, k0 + t + 4, each k row scaled by w[k] when
// w is given, split.
__device__ __forceinline__ void load_at(uint32_t (&big)[4], uint32_t (&small)[4],
                                        const float* tile, int ld, int r0, int k0,
                                        int g, int t, const float* w) {
  const float* p = tile + (k0 + t) * ld + r0 + g;
  const float w0 = w ? w[k0 + t] : 1.0f, w1 = w ? w[k0 + t + 4] : 1.0f;
  split_tf32(p[0] * w0, big[0], small[0]);
  split_tf32(p[8] * w0, big[1], small[1]);
  split_tf32(p[4 * ld] * w1, big[2], small[2]);
  split_tf32(p[4 * ld + 8] * w1, big[3], small[3]);
}

// The A fragments of one 16-deep block (k8 steps k0 and k0 + 8), split.
struct ABlock {
  uint32_t big[2][4], small[2][4];
};
// The B fragments of one 16-deep block for each of a warp's NF frags.
template <int NF>
struct BBlock {
  uint32_t big[NF][2][2], small[NF][2][2];
};

// acc[f] += A B[f] over one 16-deep block, for the first nf frags: the
// block summed from zero, then added in f32 (the tensor cores truncate a
// product added to a large running sum). The MMAs go term by term
// across the frags, small*big, big*small, big*big of each k8 step.
template <int NF>
__device__ __forceinline__ void mma_block(float (*acc)[4], const ABlock& a,
                                          const BBlock<NF>& b, int nf) {
  float blk[NF][4];
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) blk[f][e] = 0.0f;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int f = 0; f < NF; ++f)
      if (f < nf) mma_tf32(blk[f], a.small[s], b.big[f][s][0], b.big[f][s][1]);
#pragma unroll
    for (int f = 0; f < NF; ++f)
      if (f < nf) mma_tf32(blk[f], a.big[s], b.small[f][s][0], b.small[f][s][1]);
#pragma unroll
    for (int f = 0; f < NF; ++f)
      if (f < nf) mma_tf32(blk[f], a.big[s], b.big[f][s][0], b.big[f][s][1]);
  }
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] += blk[f][e];
}

// The deal of a 64 x 64 output of 4 x 8 frags to the W warps of a CTA:
// warp w owns row tile w % 4 and the 8-column tiles n = w / 4 + (W / 4) f,
// f < NF = 32 / W; nf_of the frags below nt column tiles.
template <int W>
__host__ __device__ constexpr int frags_of() { return 32 / W; }
template <int W>
__device__ __forceinline__ int frag_n(int warp, int f) { return warp / 4 + (W / 4) * f; }
template <int W>
__device__ __forceinline__ int nf_of(int warp, int nt) {
  const int first = warp / 4;
  return first < nt ? min(frags_of<W>(), (nt - first + W / 4 - 1) / (W / 4)) : 0;
}

template <int NF>
__device__ __forceinline__ void zero(float (*acc)[4]) {
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = 0.0f;
}

// Rows of a frag scaled: c0, c1 in row r0 + g, c2, c3 in row r0 + g + 8.
template <int NF>
__device__ __forceinline__ void scale_rows(float (*acc)[4], const float* s, int r0, int g) {
  const float s0 = s[r0 + g], s1 = s[r0 + g + 8];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    acc[f][0] *= s0;
    acc[f][1] *= s0;
    acc[f][2] *= s1;
    acc[f][3] *= s1;
  }
}

// A pipeline of n slices through a ring of kRing stages: slice i is
// staged by fetch(i, stage) (cp.async, one commit group a slice) kRing - 1
// slices ahead of compute(i, stage); one barrier a slice. Groups
// committed before it (the caller's own) complete first.
template <typename Fetch, typename Compute>
__device__ __forceinline__ void ring(int n, float* stages, Fetch fetch, Compute compute) {
#pragma unroll
  for (int i = 0; i < kRing - 1; ++i) {
    if (i < n) fetch(i, stages + i * kStage);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<kRing - 2>();  // slice i has landed
    __syncthreads();             // and every warp is done with slice i - 1
    const int next = i + kRing - 1;
    if (next < n) fetch(next, stages + (next % kRing) * kStage);
    cp_async_commit();
    compute(i, stages + (i % kRing) * kStage);
  }
  cp_async_wait<0>();
  __syncthreads();  // the stages are free again
}

// acc[f] += A B[f] over one staged slice (reduction steps k0 .. k0 + 31,
// those below len): A (64 rows, 32) at st, B at st + kStageA, (32, 64) at
// stride kLdb (kKN) or (64 columns, 32) at stride kLda (B = tile^T).
template <bool kKN, int W>
__device__ __forceinline__ void slice_mma(float (*acc)[4], int nf, int m, int g, int t,
                                          const float* st, int k0, int len) {
  constexpr int NF = frags_of<W>();
  if (nf == 0) return;
  const int warp = threadIdx.x / 32;
  const float* bs = st + kStageA;
#pragma unroll
  for (int k16 = 0; k16 < kTK; k16 += 16) {
    if (k0 + k16 >= len) break;
    ABlock ab;
    BBlock<NF> bb;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      load_a(ab.big[s], ab.small[s], st, kLda, 16 * m, k16 + 8 * s, g, t);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        if (f >= nf) continue;
        const int n = 8 * frag_n<W>(warp, f) + g;
        if (kKN)
          load_b_kn(bb.big[f][s], bb.small[f][s], bs, kLdb, k16 + 8 * s, n, t);
        else
          load_b_nk(bb.big[f][s], bb.small[f][s], bs, kLda, n, k16 + 8 * s, t);
      }
    }
    mma_block(acc, ab, bb, nf);
  }
}

// ---- 1, 3: the chunk summaries and the states ----

// out slot of chunk c (forward: c < nc - 1, slot c; reverse: c >= 1, slot
// c - 1) = sum over the chunk's steps s of w_s a_s b_s^T (dk x Pp, a 64 x
// 64 tile), w_s = exp(D - d_s) forward, exp(d_s) reverse.
struct StateJob {
  Operand a;     // k (forward) or q (reverse), dim dk
  Operand b;     // v~ (forward) or dh~ (reverse), width P
  float* out;    // (bh, slots, dk, pp)
  int* counter;  // (bh, tiles_j, tiles_p), zero before the launch
  int reverse;
};

// Grid: bh * max(slots, 1) * tiles_j * tiles_p CTAs, the tiles of one
// (b, h, slot) consecutive.
__global__ void __launch_bounds__(kThreads, 3)
mlstm_bwd_state(StateJob job, const float* __restrict__ lf, int seq, int dk,
                int p_all, int pp, int slots) {
  extern __shared__ __align__(16) float smem[];
  float* as = smem;             // (64 steps, 64 of a), stride kLdb
  float* bs = as + kWide;       // (64 steps, 64 of b)
  float* d = bs + kWide;        // d_i
  float* w = d + kL;            // w_i
  __shared__ int last;
  const int tiles_j = ceil_div(dk, kTile), tiles_p = ceil_div(p_all, kTile);
  int idx = blockIdx.x;
  const int pt = idx % tiles_p; idx /= tiles_p;
  const int jt = idx % tiles_j; idx /= tiles_j;
  const int slot = idx % max(slots, 1);
  const int64_t bh = idx / max(slots, 1);
  if (slot >= slots) return;  // one chunk: no state
  const int c = job.reverse ? slot + 1 : slot;
  const int t0 = c * kL, valid = min(kL, seq - t0);
  const int j0 = jt * kTile, p0 = pt * kTile;
  const float* lf_bh = lf + bh * seq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  stage<kTile>(as, kLdb, job.a, bh * seq + t0, valid, j0, kL);
  stage<kTile>(bs, kLdb, job.b, bh * seq + t0, valid, p0, kL);
  cp_async_commit();
  chunk_decays(lf_bh, t0, valid, d);
  __syncthreads();
  if (tid < kL) w[tid] = job.reverse ? expf(d[tid]) : expf(d[kL - 1] - d[tid]);
  cp_async_wait<0>();
  __syncthreads();

  // rows j of the tile in 1, 2 or 4 row tiles (a narrow head's 16 rows
  // give every warp one of its 8 column tiles)
  const int rows = min(kTile, dk - j0);
  const int mt = rows <= 16 ? 1 : rows <= 32 ? 2 : 4;
  const int nt = ceil_div(min(kTile, p_all - p0), 8);
  const int m = warp % mt, n0 = warp / mt, nstep = kWarps / mt;
  constexpr int NF = 4;  // a warp's frags at most: 4 x 8 over 8 warps
  const int nf = n0 < nt ? min(NF, (nt - n0 + nstep - 1) / nstep) : 0;
  float acc[NF][4];
  zero<NF>(acc);
  if (nf > 0) {
#pragma unroll
    for (int k16 = 0; k16 < kL; k16 += 16) {
      ABlock a;
      BBlock<NF> b;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        load_at(a.big[s], a.small[s], as, kLdb, 16 * m, k16 + 8 * s, g, t, w);
#pragma unroll
        for (int f = 0; f < NF; ++f)
          if (f < nf)
            load_b_kn(b.big[f][s], b.small[f][s], bs, kLdb, k16 + 8 * s,
                      8 * (n0 + nstep * f) + g, t);
      }
      mma_block(acc, a, b, nf);
    }
  }
  // the tile through shared memory (the a tile's), stored a row of 16-byte
  // groups at a time: pp and p0 are multiples of 4
  __syncthreads();  // every warp is done with the a and b tiles
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    if (f >= nf) continue;
    const int col = 8 * (n0 + nstep * f) + 2 * t;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(as + (16 * m + g + 8 * hh) * kLdb + col) =
          make_float2(acc[f][2 * hh], acc[f][2 * hh + 1]);
  }
  __syncthreads();
  const int cols = min(kTile, pp - p0);
  const int64_t plane = (int64_t)dk * pp;
  float* tile0 = job.out + bh * slots * plane + (int64_t)j0 * pp + p0;
  for (int e = tid; e < rows * (cols / 4); e += kThreads) {
    const int r = e / (cols / 4), c4 = 4 * (e % (cols / 4));
    *reinterpret_cast<float4*>(tile0 + slot * plane + (int64_t)r * pp + c4) =
        *reinterpret_cast<const float4*>(as + r * kLdb + c4);
  }
  if (slots < 2) return;  // one state: nothing to chain

  // the last CTA of this (b, h, tile) turns the summaries into states
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* cnt = job.counter + (bh * tiles_j + jt) * tiles_p + pt;
    last = atomicAdd(cnt, 1) == slots - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // forward: slot s = exp(D_s) slot s-1 + U_s for s = 1 .. slots - 1;
  // reverse: slot s = exp(D_{s+1}) slot s+1 + V_{s+1} for s = slots - 2 ..
  // 0. Update u (of slots - 1) reads chunk ch = 1 + u (forward) or slots
  // - 1 - u (reverse), a whole chunk: their exp(D), kPass at a time into
  // the b tile (free now). The tile's entries are dealt to the threads in
  // turn; a thread takes kQ of them at a time through kB updates whose
  // loads are in flight together before their chained fmas.
  constexpr int kPer = kTile * kTile / kThreads, kQ = 4, kB = 4, kPass = 1024;
  const int n_el = rows * cols;
  int off[kPer];  // this thread's entries, from the tile's first in a slot
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int e = tid + kThreads * q;
    off[q] = e < n_el ? (e / cols) * pp + e % cols : -1;
  }
  auto at = [&](int q, int s) { return tile0 + s * plane + off[q]; };
  auto slot_of = [&](int u) { return job.reverse ? slots - 2 - u : u + 1; };
  float* dec = bs;
  float carry[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q)
    carry[q] = off[q] >= 0 ? __ldcg(at(q, job.reverse ? slots - 1 : 0)) : 0.0f;
  for (int u0 = 0; u0 < slots - 1; u0 += kPass) {
    const int nb = min(kPass, slots - 1 - u0);
    __syncthreads();  // the last block's reads of dec are done
    for (int i = warp; i < nb; i += kWarps) {
      const int ch = job.reverse ? slots - 1 - (u0 + i) : 1 + u0 + i;
      float d0, d1;
      warp_decays(lf_bh, ch * kL, kL, lane, d0, d1);
      if (lane == 31) dec[i] = expf(d1);
    }
    __syncthreads();
#pragma unroll
    for (int q0 = 0; q0 < kPer; q0 += kQ) {
      if (off[q0] < 0) continue;  // (a thread's valid entries come first)
      for (int i0 = 0; i0 < nb; i0 += kB) {
        float x[kB][kQ];
#pragma unroll
        for (int j = 0; j < kB; ++j)
#pragma unroll
          for (int q = 0; q < kQ; ++q)
            x[j][q] = i0 + j < nb && off[q0 + q] >= 0
                          ? __ldcg(at(q0 + q, slot_of(u0 + i0 + j))) : 0.0f;
#pragma unroll
        for (int j = 0; j < kB; ++j) {
          if (i0 + j >= nb) break;
          const float decay = dec[i0 + j];
          const int s = slot_of(u0 + i0 + j);
#pragma unroll
          for (int q = 0; q < kQ; ++q) {
            if (off[q0 + q] < 0) continue;
            carry[q0 + q] = fmaf(decay, carry[q0 + q], x[j][q]);
            *at(q0 + q, s) = carry[q0 + q];
          }
        }
      }
    }
  }
}

// ---- 2: the scores, and the normalize step's backward ----

struct ScoreArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* dh;
  const float* h;
  const float* f_state;  // (bh, slots, dk, pp): n is column dv
  float* scores;         // (bh, nc, 2, 64, 64): dh v^T, then q k^T
  float* du;             // (bh, S, dv), normalize only
  float* ds;             // (bh, S)
  float* den;            // (bh, S)
  int vec_q, vec_v;      // dk, dv % 4 == 0 and 16-byte aligned bases
};

// Grid: bh * nc * 2 CTAs of kWideThreads: (b, h, chunk, which), which 0:
// dh v^T over dv, 1: q k^T over dk (with normalize, then the normalize
// step's backward). The whole 64 x 64 square, dealt as a chunk CTA deals
// its outputs.
__global__ void __launch_bounds__(kWideThreads, 1)
mlstm_bwd_scores(ScoreArgs sa, const float* __restrict__ lf, int seq, int dk,
                 int dv, int pp, int slots, int normalize) {
  extern __shared__ __align__(16) float smem[];
  float* stages = smem;                // kRing x (a slice, b slice), (64, 32) each
  float* d = stages + kRing * kStage;  // d_i
  float* rsum = d + kL;            // W / 4 x 64 partial row sums
  const int nc = ceil_div(seq, kL);
  const int which = blockIdx.x % 2;
  const int c = (blockIdx.x / 2) % nc;
  const int64_t bh = blockIdx.x / 2 / nc;
  const int t0 = c * kL, valid = min(kL, seq - t0);
  const int64_t row0 = bh * seq + t0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4, m = warp % 4;
  const int dim = which ? dk : dv;
  const Operand a = which ? Operand{sa.q, nullptr, dk, kNone, sa.vec_q}
                          : Operand{sa.dh, nullptr, dv, kNone, sa.vec_v};
  const Operand b = which ? Operand{sa.k, nullptr, dk, kNone, sa.vec_q}
                          : Operand{sa.v, nullptr, dv, kNone, sa.vec_v};
  chunk_decays(lf + bh * seq, t0, valid, d);
  constexpr int W = kWideWarps, NF = frags_of<W>();
  float acc[NF][4];
  zero<NF>(acc);
  ring(ceil_div(dim, kTK), stages,
       [&](int kt, float* st) {
         stage<kTK>(st, kLda, a, row0, valid, kt * kTK, kL);
         stage<kTK>(st + kStageA, kLda, b, row0, valid, kt * kTK, kL);
       },
       [&](int kt, const float* st) {
         slice_mma<false, W>(acc, NF, m, g, t, st, kt * kTK, dim);
       });
  float* out = sa.scores + ((bh * nc + c) * 2 + which) * (int64_t)(kL * kL);
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int col = 8 * frag_n<W>(warp, f) + 2 * t;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = 16 * m + g + 8 * hh;
      *reinterpret_cast<float2*>(out + row * kL + col) =
          make_float2(acc[f][2 * hh], acc[f][2 * hh + 1]);
    }
  }
  if (!normalize || which == 0) return;

  // q_t . n_t = sum_{s<=t} exp(d_t - d_s) q_t . k_s + exp(d_t) q_t . n:
  // the decayed, masked row sums, over this thread's frags, its quad and
  // the W / 4 warps of its row tile, in that order
  float rs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int col = 8 * frag_n<W>(warp, f) + 2 * t;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * m + g + 8 * (e >> 1), s = col + (e & 1);
      rs[e >> 1] += s <= row ? acc[f][e] * expf(d[row] - d[s]) : 0.0f;
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
    rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
    if (t == 0) rsum[(warp / 4) * kL + 16 * m + g + 8 * hh] = rs[hh];
  }
  __syncthreads();
  const float* nprev = c > 0 ? sa.f_state + (bh * slots + c - 1) * (int64_t)dk * pp + dv
                             : nullptr;
  for (int r = warp; r < valid; r += W) {
    const int64_t row = row0 + r;
    float qn = 0.0f;
    if (nprev != nullptr)
      for (int p = lane; p < dk; p += 32)
        qn = fmaf(sa.q[row * dk + p], nprev[(int64_t)p * pp], qn);
    qn = warp_sum(qn);
    float gh = 0.0f;
    for (int col = lane; col < dv; col += 32)
      gh = fmaf(sa.dh[row * dv + col], sa.h[row * dv + col], gh);
    gh = warp_sum(gh);
    float rs_r = 0.0f;
#pragma unroll
    for (int w4 = 0; w4 < W / 4; ++w4) rs_r += rsum[w4 * kL + r];
    const float s = __shfl_sync(0xffffffffu, rs_r + expf(d[r]) * qn, 0);
    const float dn = fmaxf(fabsf(s), 1.0f);
    for (int col = lane; col < dv; col += 32) sa.du[row * dv + col] = sa.dh[row * dv + col] / dn;
    if (lane == 0) {
      const float gate = fabsf(s) >= 1.0f ? (s > 0.0f ? 1.0f : (s < 0.0f ? -1.0f : 0.0f)) : 0.0f;
      sa.ds[row] = -gh / dn * gate;
      sa.den[row] = dn;
    }
  }
}

// ---- 4: the outputs of a chunk ----

struct ChunkArgs {
  Operand dht;        // dh~ = [du | ds] (dh without normalize), width P
  Operand vt;         // v~ = [v | 1] (v), width P
  Operand ko, qo;     // k, q, dim dk
  Operand uo;         // du (dh), dim dv
  const float* f_state;  // (bh, slots, dk, pp)
  const float* r_state;
  const float* scores;   // (bh, nc, 2, 64, 64)
  const float* den;      // (bh, S), normalize only
  const float* ds;
  float* dq;
  float* dk;
  float* dv;
  float* part;        // (bh, tiles, S): each row's q . dq - k . dk over the tile
  int vec_q, vec_v;   // the outputs' rows take float2 stores
};

// acc[f] += sum over the chunk's steps of A B[f] from shared memory: A =
// P (kTrans: A[r][s] = P[s][r], the steps s >= r; else A = P, s <= r), B
// the (64 steps, 64 columns) tile; only the 16-step blocks on r's side of
// the diagonal.
template <bool kTrans, int W>
__device__ __forceinline__ void intra_product(float (*acc)[4], int nf, int m, int g, int t,
                                              const float* p, const float* b) {
  constexpr int NF = frags_of<W>();
  if (nf == 0) return;
  const int warp = threadIdx.x / 32;
  const int lo = kTrans ? m : 0, hi = kTrans ? kL / 16 - 1 : m;
  for (int blk = lo; blk <= hi; ++blk) {
    ABlock ab;
    BBlock<NF> bb;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int k0 = 16 * blk + 8 * s;
      if (kTrans)
        load_at(ab.big[s], ab.small[s], p, kLdb, 16 * m, k0, g, t, nullptr);
      else
        load_a(ab.big[s], ab.small[s], p, kLdb, 16 * m, k0, g, t);
#pragma unroll
      for (int f = 0; f < NF; ++f)
        if (f < nf)
          load_b_kn(bb.big[f][s], bb.small[f][s], b, kLdb, k0, 8 * frag_n<W>(warp, f) + g, t);
    }
    mma_block(acc, ab, bb, nf);
  }
}

// Grid: bh * nc * tiles CTAs of kWideThreads, the tiles of one (b, h,
// chunk) consecutive: CTA (b, h, chunk, tile) writes columns 64 tile .. +
// 63 of dq and dk (where below dk) and of dv (where below dv) for the
// chunk's rows. 16 warps, so that each owns at most two frags of each
// output and the SM has twice the warps to hide the MMAs' and the
// slices' latency behind.
__global__ void __launch_bounds__(kWideThreads, 1)
mlstm_bwd_chunk(ChunkArgs ca, const float* __restrict__ lf, int seq, int dk,
                int dv, int p_all, int pp, int slots, int tiles, int normalize) {
  extern __shared__ __align__(16) float smem[];
  float* stages = smem;                  // kRing x (A slice, B slice)
  float* pa = stages + kRing * kStage;   // P_A, (64, 64) stride kLdb
  float* pq = pa + kWide;             // P_Q
  float* kt_ = pq + kWide;            // k columns j0 .. j0 + 63
  float* qt = kt_ + kWide;            // q columns j0 ..
  float* ut = qt + kWide;             // du (dh) columns j0 ..
  float* d = ut + kWide;              // d_i
  float* ed = d + kL;                 // exp(d_i)
  float* ew = ed + kL;                // exp(D - d_i)
  float* dn = ew + kL;                // den_i (1 without normalize)
  float* dsr = dn + kL;               // ds_i (0 without normalize)
  float* fcol = dsr + kL;             // F_c[j0 + j][dv], R_c[j0 + j][dv] (normalize)
  float* rcol = fcol + kL;
  const int nc = ceil_div(seq, kL);
  const int tile = blockIdx.x % tiles;
  const int c = (blockIdx.x / tiles) % nc;
  const int64_t bh = blockIdx.x / tiles / nc;
  const int t0 = c * kL, valid = min(kL, seq - t0);
  const int64_t row0 = bh * seq + t0;
  const int j0 = tile * kTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4, m = warp % 4;
  const int ntq = j0 < dk ? ceil_div(min(kTile, dk - j0), 8) : 0;
  const int ntv = j0 < dv ? ceil_div(min(kTile, dv - j0), 8) : 0;
  constexpr int W = kWideWarps, NF = frags_of<W>();
  const int nfq = nf_of<W>(warp, ntq), nfv = nf_of<W>(warp, ntv);

  // the chunk's scores and column tiles first: they land while the
  // inter-chunk products run
  const float* sc = ca.scores + (bh * nc + c) * 2 * (int64_t)(kL * kL);
  const Operand so = {sc, nullptr, kL, kNone, 1};
  stage<kTile>(pa, kLdb, so, 0, kL, 0, kL);
  stage<kTile>(pq, kLdb, so, kL, kL, 0, kL);
  stage<kTile>(kt_, kLdb, ca.ko, row0, valid, j0, kL);
  stage<kTile>(qt, kLdb, ca.qo, row0, valid, j0, kL);
  stage<kTile>(ut, kLdb, ca.uo, row0, valid, j0, kL);
  cp_async_commit();
  chunk_decays(lf + bh * seq, t0, valid, d);
  __syncthreads();
  if (tid < kL) {
    ed[tid] = expf(d[tid]);
    ew[tid] = expf(d[kL - 1] - d[tid]);
    const bool in = normalize && tid < valid;
    dn[tid] = in ? ca.den[row0 + tid] : 1.0f;
    dsr[tid] = in ? ca.ds[row0 + tid] : 0.0f;
    const int64_t at = (int64_t)(j0 + tid) * pp + dv;
    const bool col = normalize && j0 + tid < dk;
    fcol[tid] = col && c > 0 ? ca.f_state[(bh * slots + c - 1) * (int64_t)dk * pp + at] : 0.0f;
    rcol[tid] = col && c < nc - 1 ? ca.r_state[(bh * slots + c) * (int64_t)dk * pp + at] : 0.0f;
  }

  float aq[NF][4], ak[NF][4], av[NF][4];
  zero<NF>(aq);
  zero<NF>(ak);
  zero<NF>(av);
  // One pipeline of 32-wide slices of the inter-chunk products, dq = dh~
  // F_c^T over P (c > 0), dk = v~ R_c^T over P and dv = k R_c[:, :dv] over
  // dk (c < nc - 1), each then scaled by its rows' decay. With normalize
  // the column dv of dh~ and v~ (ds and 1) stays out of the slices (it
  // would take a whole one at dv = 512): it adds ds_r F[j][dv] to dq and
  // R[j][dv] to dk, a rank-1 term, before the decay.
  const int64_t plane = (int64_t)dk * pp;
  Operand dh_mma = ca.dht, v_mma = ca.vt;
  dh_mma.mode = v_mma.mode = kNone;
  const int p_mma = normalize ? dv : p_all;
  const Operand fo = {ca.f_state + (bh * slots + c - 1) * plane, nullptr, pp, kNone, 1};
  const Operand ro = {ca.r_state + (bh * slots + c) * plane, nullptr, pp, kNone, 1};
  const int nq = ntq > 0 && c > 0 ? ceil_div(p_mma, kTK) : 0;
  const int nk = ntq > 0 && c < nc - 1 ? ceil_div(p_mma, kTK) : 0;
  const int nv = ntv > 0 && c < nc - 1 ? ceil_div(dk, kTK) : 0;
  const int e1 = nq, e2 = e1 + nk;
  auto add_rank1 = [&](float (*acc)[4], const float* row, const float* col) {
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int lc = 8 * frag_n<W>(warp, f) + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[f][e] += (row ? row[16 * m + g + 8 * (e >> 1)] : 1.0f) * col[lc + (e & 1)];
    }
  };
  ring(e2 + nv, stages,
       [&](int i, float* st) {
         if (i < e1) {
           const int kt = i;
           stage<kTK>(st, kLda, dh_mma, row0, valid, kt * kTK, kL);
           stage<kTK>(st + kStageA, kLda, fo, j0, dk - j0, kt * kTK, kTile);
         } else if (i < e2) {
           const int kt = i - e1;
           stage<kTK>(st, kLda, v_mma, row0, valid, kt * kTK, kL);
           stage<kTK>(st + kStageA, kLda, ro, j0, dk - j0, kt * kTK, kTile);
         } else {
           const int kt = i - e2;
           stage<kTK>(st, kLda, ca.ko, row0, valid, kt * kTK, kL);
           stage<kTile>(st + kStageA, kLdb, ro, kt * kTK, dk - kt * kTK, j0, kTK);
         }
       },
       [&](int i, const float* st) {
         if (i < e1) {
           slice_mma<false, W>(aq, nfq, m, g, t, st, i * kTK, p_mma);
           if (i == e1 - 1) {
             if (normalize) add_rank1(aq, dsr, fcol);
             scale_rows<NF>(aq, ed, 16 * m, g);
           }
         } else if (i < e2) {
           slice_mma<false, W>(ak, nfq, m, g, t, st, (i - e1) * kTK, p_mma);
           if (i == e2 - 1) {
             if (normalize) add_rank1(ak, nullptr, rcol);
             scale_rows<NF>(ak, ew, 16 * m, g);
           }
         } else {
           slice_mma<true, W>(av, nfv, m, g, t, st, (i - e2) * kTK, dk);
           if (i == e2 + nv - 1) scale_rows<NF>(av, ew, 16 * m, g);
         }
       });
  // the scores decayed and masked in place: P_A = (dh v^T / den + ds)
  // exp(d_r - d_s) (dh v^T without normalize), P_Q = q k^T exp(d_r - d_s),
  // for s <= r, else 0
  for (int e = tid; e < kL * kL; e += kWideThreads) {
    const int r = e / kL, s = e % kL;
    float* a = pa + r * kLdb + s;
    float* q = pq + r * kLdb + s;
    if (s <= r) {
      const float decay = expf(d[r] - d[s]);
      *a = (normalize ? *a / dn[r] + dsr[r] : *a) * decay;
      *q *= decay;
    } else {
      *a = 0.0f;
      *q = 0.0f;
    }
  }
  __syncthreads();
  intra_product<false, W>(aq, nfq, m, g, t, pa, kt_);  // dq += P_A k
  intra_product<true, W>(ak, nfq, m, g, t, pa, qt);    // dk += P_A^T q
  intra_product<true, W>(av, nfv, m, g, t, pq, ut);    // dv += P_Q^T du

  // stores, and each row's q . dq - k . dk over this tile's columns
  float x[2] = {0.0f, 0.0f};
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int lc = 8 * frag_n<W>(warp, f) + 2 * t, col = j0 + lc;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * m + g + 8 * hh;
      if (f < nfq) {
        x[hh] += qt[r * kLdb + lc] * aq[f][2 * hh] + qt[r * kLdb + lc + 1] * aq[f][2 * hh + 1]
               - (kt_[r * kLdb + lc] * ak[f][2 * hh] + kt_[r * kLdb + lc + 1] * ak[f][2 * hh + 1]);
      }
      if (r >= valid) continue;
      const int64_t row = row0 + r;
      if (f < nfq) {
        float* oq = ca.dq + row * dk + col;
        float* ok = ca.dk + row * dk + col;
        if (ca.vec_q && col + 1 < dk) {
          *reinterpret_cast<float2*>(oq) = make_float2(aq[f][2 * hh], aq[f][2 * hh + 1]);
          *reinterpret_cast<float2*>(ok) = make_float2(ak[f][2 * hh], ak[f][2 * hh + 1]);
        } else {
          if (col < dk) {
            oq[0] = aq[f][2 * hh];
            ok[0] = ak[f][2 * hh];
          }
          if (col + 1 < dk) {
            oq[1] = aq[f][2 * hh + 1];
            ok[1] = ak[f][2 * hh + 1];
          }
        }
      }
      if (f < nfv) {
        float* ov = ca.dv + row * dv + col;
        if (ca.vec_v && col + 1 < dv) {
          *reinterpret_cast<float2*>(ov) = make_float2(av[f][2 * hh], av[f][2 * hh + 1]);
        } else {
          if (col < dv) ov[0] = av[f][2 * hh];
          if (col + 1 < dv) ov[1] = av[f][2 * hh + 1];
        }
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    x[hh] += __shfl_xor_sync(0xffffffffu, x[hh], 1);
    x[hh] += __shfl_xor_sync(0xffffffffu, x[hh], 2);
  }
  __syncthreads();  // every thread is past its reads of the tiles
  float* xrow = pa;  // W / 4 x 64 partial sums, in the P_A tile
  if (t == 0) {
    xrow[(warp / 4) * kL + 16 * m + g] = x[0];
    xrow[(warp / 4) * kL + 16 * m + g + 8] = x[1];
  }
  __syncthreads();
  if (tid < valid) {
    float sum = 0.0f;
#pragma unroll
    for (int w4 = 0; w4 < W / 4; ++w4) sum += xrow[w4 * kL + tid];
    ca.part[(bh * tiles + tile) * (int64_t)seq + t0 + tid] = sum;
  }
}

// ---- 5: dlog_f ----

// dlf_s = sum_{t>=s} x_t, x_t = sum over the column tiles of part (in
// tile order): a block scan of kScan steps at a time from the end, each
// thread 4 consecutive steps, with the total of the later blocks carried.
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_dlogf(const float* __restrict__ part, float* __restrict__ dlf, int seq,
                int tiles) {
  __shared__ float wsum[kWarps];
  __shared__ float carry_s;
  const int64_t bh = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float carry = 0.0f;
  for (int end = seq; end > 0; end -= kScan) {
    const int start = max(0, end - kScan);
    const int base = end - kScan + 4 * tid;  // this thread's first step
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = base + i;
      float v = 0.0f;
      if (s >= start)
        for (int tl = 0; tl < tiles; ++tl) v += part[(bh * tiles + tl) * (int64_t)seq + s];
      x[i] = v;
    }
    // suffix sums within the thread, then across lanes (later lanes hold
    // later steps), then across warps
    x[2] += x[3];
    x[1] += x[2];
    x[0] += x[1];
    float incl = x[0];
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const float y = __shfl_down_sync(0xffffffffu, incl, off);
      if (lane + off < 32) incl += y;
    }
    float excl = __shfl_down_sync(0xffffffffu, incl, 1);
    if (lane == 31) excl = 0.0f;
    if (lane == 0) wsum[warp] = incl;
    __syncthreads();
    if (tid == 0) {  // the warps' exclusive suffixes, in warp order from the end
      float run = carry;
      for (int w = kWarps - 1; w >= 0; --w) {
        const float tot = wsum[w];
        wsum[w] = run;
        run += tot;
      }
      carry_s = run;
    }
    __syncthreads();
    const float after = excl + wsum[warp];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = base + i;
      if (s >= start) dlf[bh * seq + s] = x[i] + after;
    }
    carry = carry_s;
    __syncthreads();  // wsum and carry_s are rewritten by the next block
  }
}

// ---- host side ----

// The scratch of a call, in floats from its start (each region 16-byte
// aligned): du and den (normalize only), the forward and reverse states,
// the scores, the dlog_f partial sums, the state counters (ints).
struct Work {
  int64_t du, den, f, r, scores, part, counters, floats;
};

struct Shape {
  int nc, slots, p_all, pp, tiles, tiles_j, tiles_p;
};

Shape shape_of(int seq, int dk, int dv, int normalize) {
  Shape s;
  s.nc = ceil_div(seq, kL);
  s.slots = s.nc - 1;
  s.p_all = dv + (normalize ? 1 : 0);
  s.pp = (int)round4(s.p_all);
  s.tiles = ceil_div(dk > dv ? dk : dv, kTile);
  s.tiles_j = ceil_div(dk, kTile);
  s.tiles_p = ceil_div(s.p_all, kTile);
  return s;
}

Work work_of(int bh, int seq, int dk, int dv, int normalize) {
  const Shape s = shape_of(seq, dk, dv, normalize);
  Work w;
  int64_t off = 0;
  auto take = [&](int64_t n) {
    const int64_t at = off;
    off += round4(n);
    return at;
  };
  w.du = take(normalize ? (int64_t)bh * seq * dv : 0);
  w.den = take(normalize ? (int64_t)bh * seq : 0);
  w.f = take((int64_t)bh * s.slots * dk * s.pp);
  w.r = take((int64_t)bh * s.slots * dk * s.pp);
  w.scores = take((int64_t)bh * s.nc * 2 * kL * kL);
  w.part = take((int64_t)bh * s.tiles * seq);
  w.counters = take(2 * (int64_t)bh * s.tiles_j * s.tiles_p);
  w.floats = off;
  return w;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The score and chunk kernels' dynamic shared memory is above the 48 KB a
// block gets by default.
int allow_smem() {
  int err = (int)cudaFuncSetAttribute(
      mlstm_bwd_scores, cudaFuncAttributeMaxDynamicSharedMemorySize, kScoreSmem);
  if (err == 0)
    err = (int)cudaFuncSetAttribute(
        mlstm_bwd_chunk, cudaFuncAttributeMaxDynamicSharedMemorySize, kChunkSmem);
  return err;
}

// CTAs of each launch: state (each direction), scores, chunk, dlogf.
// False where a grid would not fit an int.
bool grids(int bh, const Shape& s, int64_t out[4]) {
  const int64_t slots = s.slots > 1 ? s.slots : 1;
  out[0] = (int64_t)bh * slots * s.tiles_j * s.tiles_p;
  out[1] = (int64_t)bh * s.nc * 2;
  out[2] = (int64_t)bh * s.nc * s.tiles;
  out[3] = bh;
  for (int i = 0; i < 4; ++i)
    if (out[i] > 0x7fffffff) return false;
  return true;
}

// Launches of a call: the state kernel twice, the scores, the chunks, dlogf.
constexpr int kLaunches = 5;

}  // namespace

// Bytes of the scratch a call at (bh, seq, dk, dv, normalize) needs in
// mlstm_scan_bwd_f32's `du` argument.
extern "C" long long mlstm_bwd_work_bytes(int bh, int seq, int dk, int dv, int normalize) {
  if (bh < 1 || seq < 1 || dk < 1 || dv < 1) return -1;
  return 4 * (long long)work_of(bh, seq, dk, dv, normalize).floats;
}

// The partition of a call, for the launcher's tests and chip_smoke.py:
// out[0..3] = CTAs of the state (each direction), scores, chunk and
// dlogf launches; out[4..7] = their blocks an SM holds at once on the current
// device; out[8] = the device's SMs; out[9..10] = chunks, column tiles;
// out[11..13] = the dynamic shared memory of a state, score and chunk
// CTA; out[14] = the launches of a call. Returns 0 or a CUDA error.
extern "C" int mlstm_bwd_plan(int bh, int seq, int dk, int dv, int normalize, int* out) {
  if (bh < 1 || seq < 1 || dk < 1 || dv < 1) return (int)cudaErrorInvalidValue;
  const Shape s = shape_of(seq, dk, dv, normalize);
  int64_t ctas[4];
  if (!grids(bh, s, ctas)) return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  int err = (int)cudaGetDevice(&device);
  if (err == 0) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == 0) err = allow_smem();
  int per_sm[4] = {0, 0, 0, 0};
  if (err == 0)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[0], mlstm_bwd_state,
                                                             kThreads, kStateSmem);
  if (err == 0)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[1], mlstm_bwd_scores,
                                                             kWideThreads, kScoreSmem);
  if (err == 0)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[2], mlstm_bwd_chunk,
                                                             kWideThreads, kChunkSmem);
  if (err == 0)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[3], mlstm_bwd_dlogf,
                                                             kThreads, 0);
  if (err != 0) return err;
  for (int i = 0; i < 4; ++i) {
    out[i] = (int)ctas[i];
    out[4 + i] = per_sm[i];
  }
  out[8] = sms;
  out[9] = s.nc;
  out[10] = s.tiles;
  out[11] = kStateSmem;
  out[12] = kScoreSmem;
  out[13] = kChunkSmem;
  out[14] = kLaunches;
  return 0;
}

// The backward of one call: q, k (bh, S, dk), v, h, dh (bh, S, dv), lf
// (bh, S) in; dq, dk (bh, S, dk), dv (bh, S, dv), dlf (bh, S) out; du the
// scratch, at least mlstm_bwd_work_bytes bytes, 16-byte aligned; ds (bh,
// S) scratch, used with normalize only. Launches the forward states, the
// scores, the reverse states, the chunks and dlogf on `stream`.
// Returns 0 or the first CUDA error.
extern "C" int mlstm_scan_bwd_f32(const void* q, const void* k, const void* v,
                                  const void* lf, const void* h, const void* dh,
                                  void* dq, void* dk, void* dv, void* dlf,
                                  void* du, void* ds, int bh, int seq, int dkd,
                                  int dvd, int normalize, void* stream) {
  if (bh < 1 || seq < 1 || dkd < 1 || dvd < 1 || du == nullptr || !aligned16(du) ||
      (normalize && ds == nullptr))
    return (int)cudaErrorInvalidValue;
  const Shape s = shape_of(seq, dkd, dvd, normalize);
  int64_t ctas[4];
  if (!grids(bh, s, ctas)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Work w = work_of(bh, seq, dkd, dvd, normalize);
  float* work = static_cast<float*>(du);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* lff = static_cast<const float*>(lf);
  const float* dhf = static_cast<const float*>(dh);
  float* duf = work + w.du;
  float* dsf = static_cast<float*>(ds);
  float* denf = work + w.den;
  float* fst = work + w.f;
  float* rst = work + w.r;
  float* scores = work + w.scores;
  float* part = work + w.part;
  int* counters = reinterpret_cast<int*>(work + w.counters);
  const int ncount = s.tiles_j * s.tiles_p * bh;
  const int vec_q = dkd % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(dq) &&
                    aligned16(dk);
  const int vec_v = dvd % 4 == 0 && aligned16(v) && aligned16(dh) && aligned16(dv);
  const Operand ko = {kf, nullptr, dkd, kNone, vec_q};
  const Operand qo = {qf, nullptr, dkd, kNone, vec_q};
  const Operand vt = {vf, nullptr, dvd, normalize ? kOnes : kNone, vec_v};
  const Operand dht = normalize ? Operand{duf, dsf, dvd, kExtra, vec_v}
                                : Operand{dhf, nullptr, dvd, kNone, vec_v};
  const Operand uo = {normalize ? duf : dhf, nullptr, dvd, kNone, vec_v};

  cudaError_t err = cudaMemsetAsync(counters, 0, 2 * (size_t)ncount * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  if ((err = (cudaError_t)allow_smem()) != cudaSuccess) return (int)err;

  const StateJob fwd = {ko, vt, fst, counters, 0};
  mlstm_bwd_state<<<(unsigned)ctas[0], kThreads, kStateSmem, st>>>(fwd, lff, seq, dkd,
                                                                   s.p_all, s.pp, s.slots);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const ScoreArgs sa = {qf, kf, vf, dhf, static_cast<const float*>(h), fst, scores,
                        duf, dsf, denf, vec_q, vec_v};
  mlstm_bwd_scores<<<(unsigned)ctas[1], kWideThreads, kScoreSmem, st>>>(
      sa, lff, seq, dkd, dvd, s.pp, s.slots, normalize);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const StateJob rev = {qo, dht, rst, counters + ncount, 1};
  mlstm_bwd_state<<<(unsigned)ctas[0], kThreads, kStateSmem, st>>>(rev, lff, seq, dkd,
                                                                   s.p_all, s.pp, s.slots);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const ChunkArgs ca = {dht, vt, ko, qo, uo, fst, rst, scores, denf, dsf,
                        static_cast<float*>(dq), static_cast<float*>(dk),
                        static_cast<float*>(dv), part, vec_q, vec_v};
  mlstm_bwd_chunk<<<(unsigned)ctas[2], kWideThreads, kChunkSmem, st>>>(
      ca, lff, seq, dkd, dvd, s.p_all, s.pp, s.slots, s.tiles, normalize);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  mlstm_bwd_dlogf<<<(unsigned)ctas[3], kThreads, 0, st>>>(part, static_cast<float*>(dlf),
                                                          seq, s.tiles);
  return (int)cudaGetLastError();
}
