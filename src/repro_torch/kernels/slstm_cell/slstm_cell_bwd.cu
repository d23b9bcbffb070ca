// Backward (BPTT) of the stabilized sLSTM recurrence of slstm_cell.cu: the
// gradient of the gate pre-activations from the gradient of the outputs,
// with r_h resident across a thread-block cluster.
//
// Replaces no TPU kernel: the reference differentiates its XLA form
// (jax.grad through lax.scan, src/repro/models/recurrent.py:199-219) and
// has no Pallas backward. It was added so that the federated trainer's
// recurrent encoders carry their gradients through a kernel on the card.
//
// Inputs, all f32 and contiguous, for C clients of B rows each:
//   save (C*B, H, S, 7, hd): per step the gate sums a = pre + h_prev @ r_h
//        (z, i, f, o) and the state (c, n, m) after the step, as the
//        forward kernel writes them;
//   rt   (C, H, 4hd, hd): each client's r_h transposed;
//   dhs  (C*B, H, S, hd): the gradient of the output h.
// Output: dpre (C*B, H, S, 4, hd), the gradient of each step's gate sums,
// which is that of pre_x and of the recurrent product alike. The
// gradient of r is sum over rows and steps of h_prev^T dpre, one batched
// product the launcher leaves to the caller.
//
// Per step t = S-1 .. 0, per (row, unit), with (dc, dn, dm) carried from
// step t+1 (zero at S-1) and dh = dhs[t] + (dpre[t+1] @ r_h^T)[unit]:
//   the exact adjoint of the forward's step (the state before the step is
//   the saved one of t-1, or c = n = 0, m = -1e30 at t = 0), including the
//   path through the stabilizer m. Where max(|n|, 1) or max(log_f + m,
//   log_i) ties, each side takes half of the gradient, as jnp.maximum's
//   derivative does: at t = 0, n = 1 exactly in every row.
//
// Bound. The recurrent products are those of the forward, B*H*S*2*hd*4hd
// f32 FLOPs (C*B = 1024, H = 4, S = 64, hd = 256: 137 GFLOP), run here in
// 3xTF32 on the tensor cores (three TF32 products for each f32 one, 412
// GFLOP of TF32: 0.83 ms at 495 TFLOP/s), against reading save, dhs and r
// and writing dpre (12 floats a (row, unit, step): 3.29 GB at that shape,
// 0.98 ms at 3.35 TB/s): bytes bound it.
//
// Design (plan() below; slstm_cell_bwd.py mirrors it for the tests): the
// partition of the forward (slstm_cell.cu), run backward.
// - A cluster of 1..8 CTAs (the smallest power of two with hd/C <= 32)
//   serves one (client, head) and one group of up to 32 rows, sized as
//   the forward sizes it from this kernel's own cluster budget
//   (cudaOccupancyMaxActiveClusters, cached; 15 clusters of 8 on an
//   H100). CTA k owns the units [k*U, (k+1)*U), U = ceil(hd/C), and all
//   four gate columns of each.
// - CTA k loads its slice of r_h^T (its 4U gate columns, each a row of hd
//   inputs: 128 KiB at hd = 256) into shared memory once per call, rows
//   XOR-swizzled so that the B-fragment loads are free of bank conflicts.
//   r_h is read once per cluster per call, not once per block and step.
// - Per step each CTA (512 threads)
//   1. computes the adjoint of its (row, unit) pairs, 2 a thread, with
//      (dc, dn, dm) and the state in registers and no branch between the
//      pairs; each thread's next step's saved values (4 gate sums, the
//      state before it, dhs) are loaded one step ahead. It writes dpre[t]
//      and keeps its gate gradients in shared memory split once into
//      their TF32 big and small parts (rows 4 mod 32 floats apart);
//   2. forms the partial dh_part[row, i] = sum over its 4U gate columns j
//      of dpre[row, j] r_h[i, j], for all hd inputs i: (rows x 4U) x (4U x
//      hd) in 3xTF32 mma.sync.m16n8k8 (tf32_mma.cuh), each of 16 warps on
//      two 8-input n-tiles of every 16-row m-tile, the A fragments by
//      ldmatrix from the pre-split gradients;
//   3. reduce-scatters the partials: each value goes by st.async (8
//      bytes, two inputs of a row, where the units a CTA are even) to the
//      CTA that owns input i, into a receive slot of the sending CTA,
//      double-buffered by the step's parity and counted on the owner's
//      mbarrier. The owner waits for its barrier and sums the C slots in
//      rank order, then adds dhs[t-1]: the forward's all-gather of h, run
//      backward (red.async has no f32 add, so the sum takes buffers).
// - Rows past the batch and units past hd compute on zeros and store
//   nothing. The launcher refuses (kClusterUnschedulable) when no cluster
//   fits: there is no other design to fall back to.
// Shared memory: 4 * kpad * round_up(hd, 32) bytes of r_h^T, 2 x 4 *
// rows_pad * lda of split gate gradients, 8 * C * rows * U of receive
// slots and two 8-byte barriers: 230,416 bytes at hd = 256 and 32 rows,
// within the 232,448 a block may use. At the stacked training shape (64
// (client, head) pairs of 64 rows) the plan makes 128 clusters of 8, 8.53
// waves of the 15 an H100 holds at once.
//
// Measured (tools/torch_bwd_ablation.py and chip_smoke.py phase 22, one
// "NVIDIA H100 80GB HBM3" at 700.00 W; PERF.md has the runs): 5.29-5.64
// ms a call at (1024, 4, 64, 256), 16 clients, against 11.06-11.21 ms of
// the one-block design this replaces (r^T streamed from L2 by every
// block every step) timed in turns in the same runs; 0.56-0.58 ms
// against 6.37-6.54 at one client's 64 rows. Without the products the
// call takes 3.1 ms, without the exchange 4.5, with one TF32 product in
// place of three 4.0: the products and the step's serial chain (adjoint,
// product, exchange, in lock step across the cluster) set the pace.
// Earlier forms, same tool: SIMT products 10.55 ms (their FMAs at about
// 38% of the f32 peak); 256 threads with tensor-core products 7.24-7.39;
// two independent 16-row halves a CTA 8.88-9.11 (each half re-splits r_h).
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

#include "cluster.cuh"
#include "cp_async.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHd = 256;     // r_h^T's slice must fit a CTA's shared memory
constexpr int kMaxUnits = 32;   // units a CTA, hd / cluster size
constexpr int kMaxRows = 32;    // rows a cluster
constexpr int kMaxPairs = kMaxRows * kMaxUnits / kThreads;  // (row, unit) a thread
constexpr int kMaxTilesPerWarp = 2;  // ceil(ceil(256 / 8) / kWarps)
constexpr int kClusterUnschedulable = -1;

struct Plan {
  int cluster;   // CTAs a cluster: 1, 2, 4 or 8
  int units;     // units a CTA (the last CTA may own fewer)
  int rows;      // rows a cluster, as the forward rounds them
  int groups;    // row groups a (client, head)
  int kpad;      // the product's depth: 4 * units gate columns, rounded to 8
  int lda;       // floats a row of the gate gradients (4 mod 32)
  int ldr;       // floats a row of the r_h^T slice: hd rounded to 32
  int rows_pad;  // rows rounded to the 16 of an m-tile
  int n_tiles;   // 8-input tiles of the partial: ceil(hd / 8)
  int tiles_per_warp;  // of them a warp takes: ceil(n_tiles / 16)
  int smem;      // dynamic shared memory bytes a CTA
};

int ceil_div(int a, int b) { return (a + b - 1) / b; }
int round_up(int a, int b) { return ceil_div(a, b) * b; }

// The partition of a call, as slstm_cell.cu's plan() makes it for the
// cluster, the units and the rows (its rows rounded to its rows a
// thread); the product's tiles and the shared memory are this kernel's:
// the slice, the gate gradients split into their TF32 big and small
// parts, two parities of receive slots and two barriers.
Plan plan(int batch, int n_heads, int hd, int budget) {
  Plan p;
  p.cluster = 1;
  while (p.cluster * kMaxUnits < hd) p.cluster *= 2;
  p.units = ceil_div(hd, p.cluster);
  const int per_head = budget / n_heads;
  int rows = ceil_div(batch, per_head > 1 ? per_head : 1);
  rows = rows < kMaxRows ? rows : kMaxRows;
  const int fwd_rpt = rows >= 16 ? 4 : rows >= 8 ? 2 : 1;
  p.rows = round_up(rows, fwd_rpt);
  p.groups = ceil_div(batch, p.rows);
  p.kpad = round_up(4 * p.units, 8);
  p.lda = round_up(p.kpad, 32) + 4;
  p.ldr = round_up(hd, 32);
  p.rows_pad = round_up(p.rows, 16);
  p.n_tiles = ceil_div(hd, 8);
  p.tiles_per_warp = ceil_div(p.n_tiles, kWarps);
  p.smem = 4 * (p.kpad * p.ldr + 2 * p.rows_pad * p.lda +
                2 * p.cluster * p.rows * p.units) +
           2 * (int)sizeof(uint64_t);
  return p;
}

// The column of row k of the slice where its input i is kept: i with
// bits 3-4 flipped by k % 4, so that a B fragment's loads (rows k0 + t,
// columns n0 + g) fall in 32 distinct banks.
__device__ __forceinline__ int swz(int k, int i) { return i ^ ((k & 3) << 3); }

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

// The A fragment of a TF32 m16n8k8 product from a row-major tile in
// shared memory, in one instruction: ldmatrix moves 16-byte rows of 8 x 8
// b16 matrices, so that lane l receives 32-bit word l % 4 of row l / 4 of
// each of four 8 x 4 sub-tiles of 32-bit values (rows 0-7 and 8-15 of
// columns 0-3, then of columns 4-7): a0 .. a3. `row` is the address of
// this lane's row: row (l % 8) + 8 ((l / 8) % 2), column 4 (l / 16).
__device__ __forceinline__ void ldmatrix_a(uint32_t (&a)[4], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(row)));
}

// Message u (the partial dh of step S-2-u, sent in iteration u = S-1-t)
// fills receive buffer u & 1; it is the (u >> 1)-th phase of that
// buffer's barrier.
__device__ __forceinline__ void wait_msg(uint32_t bar0, int u) {
  bar_wait(bar0 + 8 * (u & 1), (u >> 1) & 1);
}

// What a (row, unit) reads for one step: the gate sums a, the state
// (c1, n1, m1) after the step, the state (c0, n0, m0) before it, dhs.
struct Step {
  float a[4], c1, n1, m1, c0, n0, m0, dh;
};

// The adjoint of one (row, unit) at one step: g, the gradient of its four
// gate sums, from dh (dhs plus the recurrent gradient) and the carried
// (dc, dn, dm), which it updates. The arithmetic of the plain backward.
__device__ __forceinline__ void adjoint(const Step& x, float dh, float& dc,
                                        float& dn, float& dm, float (&g)[4]) {
  const float z = tanhf(x.a[0]);
  const float log_i = x.a[1];
  const float log_f = log_sigmoid(x.a[2]);
  const float o = 1.0f / (1.0f + expf(-x.a[3]));
  const float i_g = expf(log_i - x.m1);
  const float f_g = expf(log_f + x.m0 - x.m1);
  const float an = fabsf(x.n1);
  const float den = fmaxf(an, 1.0f);
  // h = o * c / den
  const float d_o = dh * x.c1 / den;
  const float dct = dc + dh * o / den;
  const float dden = -dh * o * x.c1 / (den * den);
  const float w = an > 1.0f ? 1.0f : an == 1.0f ? 0.5f : 0.0f;
  const float sgn = x.n1 > 0.0f ? 1.0f : x.n1 < 0.0f ? -1.0f : 0.0f;
  const float dnt = dn + dden * w * sgn;
  // c = f c0 + i z; n = f n0 + i
  const float df = dct * x.c0 + dnt * x.n0;
  const float di = dct * z + dnt;
  const float dz = dct * i_g;
  // i = exp(log_i - m); f = exp(log_f + m0 - m)
  float dlog_i = di * i_g;
  float dlog_f = df * f_g;
  float dm0 = df * f_g;
  const float dmt = dm - di * i_g - df * f_g;
  // m = max(log_f + m0, log_i), half each way at a tie
  const float lhs = log_f + x.m0;
  if (lhs > log_i) {
    dlog_f += dmt;
    dm0 += dmt;
  } else if (lhs < log_i) {
    dlog_i += dmt;
  } else {
    dlog_f += 0.5f * dmt;
    dm0 += 0.5f * dmt;
    dlog_i += 0.5f * dmt;
  }
  const float sig_neg = 1.0f / (1.0f + expf(x.a[2]));  // 1 - sigmoid(a_f)
  g[0] = dz * (1.0f - z * z);
  g[1] = dlog_i;
  g[2] = dlog_f * sig_neg;
  g[3] = d_o * o * (1.0f - o);
  dc = dct * f_g;
  dn = dnt * f_g;
  dm = dm0;
}

// Grid: (n_heads * groups) clusters of pl.cluster CTAs, n_heads = clients
// * heads (client c's head h is head c * heads + h; its rows are c *
// batch + b). Elementwise, thread tid takes the pairs p = tid + q *
// kThreads (row p / units, unit p % units of its CTA); in the product,
// warp w takes every m-tile (16 rows, MT of them) of its n-tiles w *
// tiles_per_warp .. + tiles_per_warp - 1 (8 inputs each).
template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
    slstm_bwd_kernel(const float* __restrict__ save,
                     const float* __restrict__ rt,
                     const float* __restrict__ dhs, float* __restrict__ dpre,
                     int batch, int heads, int seq, int hd, Plan pl) {
  extern __shared__ float4 smem4[];
  const int units = pl.units, rows = pl.rows;
  float* rts = reinterpret_cast<float*>(smem4);  // (kpad, ldr): r_h^T slice
  // (rows_pad, lda) each: the gate gradients' TF32 big and small parts
  uint32_t* dab = reinterpret_cast<uint32_t*>(rts + pl.kpad * pl.ldr);
  uint32_t* das = dab + pl.rows_pad * pl.lda;
  float* recv = reinterpret_cast<float*>(das + pl.rows_pad * pl.lda);
  const int slot = rows * units;                 // floats a sender's slot
  const int buf = pl.cluster * slot;             // floats a parity
  const uint32_t bar0 = smem_addr(recv + 2 * buf);  // (2,): one a parity

  const int cid = blockIdx.x / pl.cluster;
  const int rank = blockIdx.x % pl.cluster;  // the cluster spans x
  const int vhead = cid / pl.groups;         // client * heads + head
  const int group = cid - vhead * pl.groups;
  const int client = vhead / heads;
  const int head = vhead - client * heads;
  const int b0 = group * rows;
  const int u0 = rank * units;
  const int own = min(units, hd - u0);  // units this CTA owns
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // zeros where the products read padding: r_h^T's rows past 4 * own and
  // inputs past hd, the gate gradients' rows past `rows`
  for (int e = tid; e < (pl.kpad * pl.ldr + 2 * pl.rows_pad * pl.lda) / 4;
       e += kThreads)
    smem4[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();
  // the slice: row u * 4 + gate of rts is r_h^T's row gate * hd + u0 + u
  {
    const float* src = rt + (int64_t)vhead * 4 * hd * hd;
    const int q4 = hd / 4;
    for (int e = tid; e < 4 * own * q4; e += kThreads) {
      const int row = e / q4, c = 4 * (e - row * q4);
      const int u = row >> 2, gate = row & 3;
      cp_async16(rts + row * pl.ldr + swz(row, c),
                 src + (int64_t)(gate * hd + u0 + u) * hd + c, 16);
    }
    cp_async_commit();
  }

  // this thread's pairs, and what step S-1 reads
  const int pairs = rows * units;
  int p_row[kMaxPairs], p_unit[kMaxPairs];
  bool p_in[kMaxPairs], p_ok[kMaxPairs];
  int64_t p_bh[kMaxPairs];  // (row, head) index times seq
  Step cur[kMaxPairs];
  float dc[kMaxPairs], dn[kMaxPairs], dm[kMaxPairs];
#pragma unroll
  for (int q = 0; q < kMaxPairs; ++q) {
    const int p = tid + q * kThreads;
    p_in[q] = p < pairs;
    p_row[q] = p_in[q] ? p / units : 0;
    p_unit[q] = p_in[q] ? p % units : 0;
    p_ok[q] = p_in[q] && p_unit[q] < own && b0 + p_row[q] < batch;
    const int64_t bh =
        ((int64_t)client * batch + (p_ok[q] ? b0 + p_row[q] : 0)) * heads + head;
    p_bh[q] = bh * seq;
    dc[q] = dn[q] = dm[q] = 0.0f;
    Step& x = cur[q];
    x = Step{{0.0f, 0.0f, 0.0f, 0.0f}, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, -1e30f, 0.0f};
    if (p_ok[q]) {
      const int unit = u0 + p_unit[q];
      const float* sv = save + ((p_bh[q] + seq - 1) * 7) * hd + unit;
#pragma unroll
      for (int k = 0; k < 4; ++k) x.a[k] = sv[k * hd];
      x.c1 = sv[4 * hd];
      x.n1 = sv[5 * hd];
      x.m1 = sv[6 * hd];
      if (seq > 1) {
        x.c0 = sv[4 * hd - 7 * hd];
        x.n0 = sv[5 * hd - 7 * hd];
        x.m0 = sv[6 * hd - 7 * hd];
      }
      x.dh = dhs[(p_bh[q] + seq - 1) * hd + unit];
    }
  }

  // where the product's values go: column i of the partial belongs to
  // CTA i / units, in its slot `rank`, column i % units. With an even
  // units a CTA, a thread's two columns 2t, 2t + 1 of an n-tile share an
  // owner and go in one 8-byte store (16-byte stores, after lanes t and
  // t ^ 1 swap halves, measured no faster: tools/torch_bwd_ablation.py).
  const int tile0 = warp * pl.tiles_per_warp;
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 4 * (lane >> 4);
  const bool pairs_of_cols = units % 2 == 0;
  uint32_t dst[kMaxTilesPerWarp], dst_bar[kMaxTilesPerWarp];
#pragma unroll
  for (int j = 0; j < kMaxTilesPerWarp; ++j) {
    const int i = min(8 * (tile0 + j) + 2 * t, hd - 1);
    const int owner = i / units;
    dst[j] = map_rank(smem_addr(recv + rank * slot + (i - owner * units)), owner);
    dst_bar[j] = map_rank(bar0, owner);
  }
  // a message's bytes into this CTA: every CTA's partial of its units
  const int msg_bytes = pl.cluster * rows * own * (int)sizeof(float);

  if (tid == 0) {
    bar_init(bar0);
    bar_init(bar0 + 8);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    bar_arm(bar0, msg_bytes);      // message 0
    bar_arm(bar0 + 8, msg_bytes);  // message 1
  }
  cp_async_wait<0>();
  // every CTA of the cluster is running, its slice loaded and its
  // barriers armed before any step reads them or a peer stores into them
  cluster_sync();

  for (int t_step = seq - 1; t_step >= 0; --t_step) {
    const int u = seq - 1 - t_step;  // iteration; message u - 1 holds this step's
    if (u > 0) {
      wait_msg(bar0, u - 1);
      if (tid == 0 && u + 1 <= seq - 2)
        bar_arm(bar0 + 8 * ((u - 1) & 1), msg_bytes);  // message u + 1
    }
    const float* rb = recv + ((u - 1) & 1) * buf;
    // the adjoints of this thread's pairs, without branches between them
    // so that their dependency chains interleave; pairs that store nothing
    // compute on their zero state and keep zero gradients
    float g4[kMaxPairs][4];
#pragma unroll
    for (int q = 0; q < kMaxPairs; ++q) {
      float dh = cur[q].dh;
      if (u > 0) {  // the cluster's partials of this (row, unit), in rank order
        const float* rp = rb + p_row[q] * units + p_unit[q];
        float rec = rp[0];
        for (int k = 1; k < pl.cluster; ++k) rec += rp[k * slot];
        dh += rec;
      }
      adjoint(cur[q], dh, dc[q], dn[q], dm[q], g4[q]);
    }
#pragma unroll
    for (int q = 0; q < kMaxPairs; ++q) {
      if (!p_in[q]) continue;
      if (!p_ok[q]) g4[q][0] = g4[q][1] = g4[q][2] = g4[q][3] = 0.0f;
      // the product's A operand, split once here for every warp
      uint4 big, small;
      split_tf32(g4[q][0], big.x, small.x);
      split_tf32(g4[q][1], big.y, small.y);
      split_tf32(g4[q][2], big.z, small.z);
      split_tf32(g4[q][3], big.w, small.w);
      const int at = p_row[q] * pl.lda + 4 * p_unit[q];
      *reinterpret_cast<uint4*>(dab + at) = big;
      *reinterpret_cast<uint4*>(das + at) = small;
      if (!p_ok[q]) continue;
      const int unit = u0 + p_unit[q];
      float* dp = dpre + ((p_bh[q] + t_step) * 4) * hd + unit;
#pragma unroll
      for (int k = 0; k < 4; ++k) dp[k * hd] = g4[q][k];
      // step t-1: its state after is this step's state before
      Step& x = cur[q];
      x.c1 = x.c0;
      x.n1 = x.n0;
      x.m1 = x.m0;
      if (t_step >= 1) {
        const float* sv = save + ((p_bh[q] + t_step - 1) * 7) * hd + unit;
#pragma unroll
        for (int k = 0; k < 4; ++k) x.a[k] = sv[k * hd];
        if (t_step >= 2) {
          x.c0 = sv[4 * hd - 7 * hd];
          x.n0 = sv[5 * hd - 7 * hd];
          x.m0 = sv[6 * hd - 7 * hd];
        } else {
          x.c0 = 0.0f;
          x.n0 = 0.0f;
          x.m0 = -1e30f;
        }
        x.dh = dhs[(p_bh[q] + t_step - 1) * hd + unit];
      }
    }
    if (t_step == 0) break;
    __syncthreads();  // every gate gradient of step t is in dab / das

    // the partial (rows, hd) = gate gradients (rows, kpad) x rts (kpad, hd)
    // in 3xTF32 on the tensor cores
    float acc[MT][kMaxTilesPerWarp][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < kMaxTilesPerWarp; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.0f;
#pragma unroll 4
    for (int k0 = 0; k0 < pl.kpad; k0 += 8) {
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int at = (16 * m + a_row) * pl.lda + k0 + a_col;
        ldmatrix_a(ab[m], dab + at);
        ldmatrix_a(as[m], das + at);
      }
#pragma unroll
      for (int j = 0; j < kMaxTilesPerWarp; ++j) {
        if (j >= pl.tiles_per_warp || tile0 + j >= pl.n_tiles) break;
        const int n = 8 * (tile0 + j) + g;
        uint32_t bb[2], bs[2];
        split_tf32(rts[(k0 + t) * pl.ldr + swz(t, n)], bb[0], bs[0]);
        split_tf32(rts[(k0 + t + 4) * pl.ldr + swz(t, n)], bb[1], bs[1]);
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_3xtf32(acc[m][j], ab[m], as[m], bb, bs);
      }
    }
    // message u: buffer u & 1 of each column's owner
    const int off = (u & 1) * buf * (int)sizeof(float);
#pragma unroll
    for (int j = 0; j < kMaxTilesPerWarp; ++j) {
      if (j >= pl.tiles_per_warp || tile0 + j >= pl.n_tiles) break;
      const int col = 8 * (tile0 + j) + 2 * t;
      if (col >= hd) continue;  // hd is a multiple of 4: col + 1 < hd too
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * m + g + 8 * h;
          if (row >= rows) continue;
          const float a = acc[m][j][2 * h], b = acc[m][j][2 * h + 1];
          if (pairs_of_cols) {
            st_async2(dst[j] + off + row * units * (int)sizeof(float), a, b,
                      dst_bar[j] + 8 * (u & 1));
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = col + e, owner = i / units;
              st_async(map_rank(smem_addr(recv + (u & 1) * buf + rank * slot +
                                          row * units + (i - owner * units)),
                                owner),
                       e == 0 ? a : b, map_rank(bar0 + 8 * (u & 1), owner));
            }
          }
        }
    }
    __syncthreads();  // every read of the gradients is done before step t-1
  }
  // Every message into this CTA was waited for above, so no peer stores
  // into its shared memory after it leaves.
}

// The launch configuration of a plan; the cluster shape as an attribute.
struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  Launch(const Plan& pl, int n_heads, void* stream) : cfg{} {
    cfg.gridDim = dim3((unsigned)(pl.cluster * n_heads * pl.groups));
    cfg.blockDim = dim3((unsigned)kThreads);
    cfg.dynamicSmemBytes = (size_t)pl.smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)pl.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Set the kernel's dynamic shared-memory limit to the plan's; with
// `active`, also ask how many of its clusters the card can hold at once.
template <int MT>
int prepare(const Launch& l, int* active) {
  const int err = (int)cudaFuncSetAttribute(
      slstm_bwd_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)l.cfg.dynamicSmemBytes);
  if (err != 0 || active == nullptr) return err;
  return (int)cudaOccupancyMaxActiveClusters(active, slstm_bwd_kernel<MT>,
                                             &l.cfg);
}

// The kernel instance of a plan: one or two m-tiles of 16 rows.
int prepare_plan(const Plan& pl, const Launch& l, int* active) {
  return pl.rows_pad == 16 ? prepare<1>(l, active) : prepare<2>(l, active);
}

// Set the kernel's shared-memory limit to the plan's and check, once per
// (device, m-tiles, cluster, shared memory), that the card holds one of
// its clusters.
int ready(const Plan& pl, const Launch& l) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int, int>, int> active_of;
  int device = 0;
  int err = (int)cudaGetDevice(&device);
  if (err != 0) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(device, pl.rows_pad, pl.cluster, pl.smem);
  auto hit = active_of.find(key);
  if (hit == active_of.end()) {
    int active = 0;
    err = prepare_plan(pl, l, &active);
    if (err != 0) return err;
    hit = active_of.emplace(key, active).first;
  } else {
    err = prepare_plan(pl, l, nullptr);
    if (err != 0) return err;
  }
  return hit->second < 1 ? kClusterUnschedulable : 0;
}

// How many clusters of hd's largest plan (kMaxRows rows: the most shared
// memory) the current device holds at once, cached per (device, hd): the
// budget plan() spreads a call's row groups over.
int cluster_budget(int hd, int* budget) {
  static std::mutex mu;
  static std::map<std::pair<int, int>, int> cache;
  int device = 0;
  int err = (int)cudaGetDevice(&device);
  if (err != 0) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(device, hd);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *budget = hit->second;
    return 0;
  }
  const Plan big = plan(kMaxRows, 1, hd, 1);
  err = prepare_plan(big, Launch(big, 1, nullptr), budget);
  if (err != 0) return err;
  if (*budget < 1) return kClusterUnschedulable;
  cache[key] = *budget;
  return 0;
}

}  // namespace

// Plain C entry point for ctypes. save (clients * batch, heads, seq, 7,
// hd), rt (clients, heads, 4 * hd, hd), dhs (clients * batch, heads, seq,
// hd) and dpre (clients * batch, heads, seq, 4, hd), all contiguous f32 on
// the device of `stream`; hd a multiple of 4, at most 256; 16-byte
// aligned pointers. Sets the kernel's shared-memory limit at every call
// (a plan query may have set another) and checks, once per plan shape,
// that a cluster of it fits the card. Returns
// cudaGetLastError() after the launch, a CUDA error of the set-up, or -1
// when the card cannot hold one cluster of the plan.
extern "C" int slstm_cell_bwd_f32(const float* save, const float* rt,
                                  const float* dhs, float* dpre, int clients,
                                  int batch, int heads, int seq, int hd,
                                  void* stream) {
  if (hd < 4 || hd > kMaxHd || hd % 4 != 0 || batch < 1 || heads < 1 ||
      clients < 1 || seq < 1 || (int64_t)clients * heads > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  int budget = 0;
  int err = cluster_budget(hd, &budget);
  if (err != 0) return err;
  const int n_heads = clients * heads;
  const Plan pl = plan(batch, n_heads, hd, budget);
  if ((int64_t)pl.cluster * n_heads * pl.groups > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const Launch l(pl, n_heads, stream);
  err = ready(pl, l);
  if (err != 0) return err;
  err = pl.rows_pad == 16
            ? (int)cudaLaunchKernelEx(&l.cfg, slstm_bwd_kernel<1>, save, rt, dhs,
                                      dpre, batch, heads, seq, hd, pl)
            : (int)cudaLaunchKernelEx(&l.cfg, slstm_bwd_kernel<2>, save, rt, dhs,
                                      dpre, batch, heads, seq, hd, pl);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

// The plan of a call, for the launcher's tests: out[0..10] = cluster,
// units, rows, groups, kpad, lda, ldr, rows_pad, n_tiles,
// tiles_per_warp, smem; out[11] = the cluster budget it was made with;
// out[12] = the
// clusters of it the current device can hold at once
// (cudaOccupancyMaxActiveClusters). Returns 0, a CUDA error, or -1 as the
// entry point does.
extern "C" int slstm_cell_bwd_plan(int batch, int n_heads, int hd, int* out) {
  if (hd < 4 || hd > kMaxHd || hd % 4 != 0 || batch < 1 || n_heads < 1)
    return (int)cudaErrorInvalidValue;
  int budget = 0;
  const int err = cluster_budget(hd, &budget);
  if (err != 0) return err;
  const Plan pl = plan(batch, n_heads, hd, budget);
  const int fields[11] = {pl.cluster, pl.units,   pl.rows,     pl.groups,
                          pl.kpad,    pl.lda,     pl.ldr,      pl.rows_pad,
                          pl.n_tiles, pl.tiles_per_warp, pl.smem};
  for (int i = 0; i < 11; ++i) out[i] = fields[i];
  out[11] = budget;
  return prepare_plan(pl, Launch(pl, n_heads, nullptr), &out[12]);
}
