// Stabilized sLSTM recurrence (Beck et al.) over a whole sequence, with
// r_h resident across a thread-block cluster.
//
// Replaces the TPU kernel src/repro/kernels/slstm_cell/slstm_cell.py:73
// (slstm_cell_pallas, its pl.pallas_call at :87 and _kernel body), which
// pins the recurrent weights r_h in VMEM and steps the recurrence over a
// sequential chunk axis. Its chunk axis and zero padding are a VMEM
// tiling detail and are not carried over: here one cluster walks the
// whole sequence of one head and one group of rows.
//
// Per step t, with pre = pre_x[b, h, t] (4, hd) and state (c, n, m, h):
//   rec   = h_prev @ r_h                        (4hd,), gate-major z,i,f,o
//   z     = tanh(pre_z + rec_z)
//   log_i = pre_i + rec_i
//   log_f = log_sigmoid(pre_f + rec_f)
//   o     = sigmoid(pre_o + rec_o)
//   m_t   = max(log_f + m, log_i);  i = exp(log_i - m_t);  f = exp(log_f + m - m_t)
//   c_t   = f*c + i*z;  n_t = f*n + i;  h_t = o * c_t / max(|n_t|, 1)
// The state starts at c = n = h = 0 and m = -1e30, so that f is exactly
// 0 at step 0, or at a given (c, n, m, h) (the language model's prefill
// and decode continue from the state a previous call left, and a decode
// step is a launch at S = 1); the final state is written when asked for.
// Everything is computed in f32; pre_x, r and the output are f32, or all
// bf16; the state is f32.
//
// Stacked clients (the federated trainer's encoders): r may hold C
// clients' weights, (C, H, hd, 4hd), with pre_x (C*B, H, S, 4, hd); rows
// [c*B, (c+1)*B) run with client c's r_h, in the same launch. The grid
// takes the C*H (client, head) pairs as its heads; with C = 1 the plan,
// the arithmetic and the output are those of the unstacked call. For the
// backward (slstm_cell_bwd.cu) the kernel can also write, per step, each
// unit's gate sums a = pre + h_prev @ r_h (z, i, f, o) and its state
// (c, n, m) after the step: `save`, (C*B, H, S, 7, hd) f32, null when no
// gradient is wanted.
//
// Bound. A call does B*H*S*2*hd*4hd f32 FLOPs in the recurrent products
// (at B=64, H=4, S=64, hd=256: 8.6 GFLOP, 128 us at 67 TFLOP/s) against
// 88 MB of HBM traffic (26 us at 3.35 TB/s): operations. Beside it sits
// a serial floor: each gate pre-activation is one chain of hd dependent
// fmaf (the sum order the plain version is held to and that this kernel
// keeps), about hd * 4 cycles a step (0.55 us at hd = 256), whatever the
// batch: S * 0.55 us = 0.28 ms at S = 512.
//
// Design (plan() below; slstm_cell.py mirrors it for the tests):
// - A cluster of C = 1..8 CTAs (the smallest power of two with hd/C <= 32)
//   serves one head and one group of up to 32 rows. CTA k owns the units
//   [k*U, (k+1)*U), U = ceil(hd/C), and all four gate columns of each, so
//   the gate math and the (c, n, m) state of a unit stay in the threads
//   that compute its products: the state never leaves registers.
// - CTA k loads its r_h slice (hd x U x 4 gates, widened to f32: 128 KiB
//   at hd = 256) into shared memory once per call with all 256 threads,
//   laid out (i, unit, gate) so that one 16-byte load gives a unit's four
//   gate weights at input i. r_h is read once per cluster per call, not
//   once per row and step.
// - A thread owns RT (1, 2 or 4) rows of one unit and its four gates;
//   eight consecutive units share a warp with four row lanes. At one row
//   a cluster a thread owns one gate (four lanes a unit, gathered by
//   shuffles before the same state update), so that 4 warps, not 1,
//   share the step. Each product is a serial fmaf chain over i = 0..hd-1
//   in order, then pre + acc: the arithmetic of the one-block-per-(b, h)
//   design this replaces, whose f32 outputs it matches bit for bit.
// - h_{t-1} of every row of the group sits in each CTA's shared memory,
//   double-buffered by t's parity. After the gate math each thread
//   stores its h_t values into every CTA's next buffer with st.async,
//   which counts the bytes on that CTA's mbarrier; a CTA starts step t+1
//   when its barrier has seen the whole step's h (rows * hd * 4 bytes).
//   A cluster barrier (barrier.cluster.arrive.release / wait.acquire)
//   runs once, after set-up: it lowers to MEMBAR.ALL.GPU and an L1
//   invalidation (cuobjdump -sass), which wait for every load and store
//   in flight, the next step's pre-activations among them.
// - Each thread loads its own pre-activations one step ahead into
//   registers, so the load's latency hides behind a step of products; no
//   thread needs another's, so no shared-memory stage is spent on them.
// - Rows per cluster: a head's rows are split into budget / H groups,
//   where the budget is the clusters the card holds at once
//   (cudaOccupancyMaxActiveClusters on the largest plan of hd, cached),
//   so that all clusters run in one wave: an H100 holds 15 clusters of 8
//   (chip_smoke.py phase 9 prints it), not 132 / 8. Rows and units past
//   the edges compute on zeros and store nothing.
// Shared memory: 16 * hd * round_up(U, 8) bytes of r_h, two h buffers of
// rows * (round_up(hd, 32) + 4) floats and two 8-byte barriers: 197,648
// bytes at hd = 256 and 32 rows, within the 232,448 a block may use. The
// launcher sets the dynamic shared-memory limit and refuses to launch
// (kClusterUnschedulable) when no cluster fits: there is no other design
// to fall back to.
// Measured (chip_smoke.py phases 9 and 14, tools/torch_slstm_ablation.py;
// one "NVIDIA H100 80GB HBM3" at 700.00 W, the two designs in turns in
// one run): f32 at (64, 4, 64, 256) 0.592-0.596 ms a call against the
// one-block-per-(b, h) design's 1.985; (2, 4, 64, 256) 0.106 against
// 0.794; (8, 4, 512, 256) from a state 1.350-1.354 against 6.455-6.478;
// a decode step (8, 4, 1, 256) 11.4 us of device time against 28.4; f32
// outputs bitwise equal. Without products (64, 4, 64, 256) takes 0.187
// ms, without the exchange 0.514 ms: the products set the pace, at 4.6x
// the operations bound. ptxas: 155 registers (f32, 4 rows a thread), 72
// (one gate a thread), no stack or spills.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr int kMaxHd = 256;        // r_h's slice must fit a CTA's shared memory
constexpr int kMaxUnits = 32;      // units a CTA, hd / cluster size
constexpr int kUnitLanes = 8;      // consecutive units of a warp
constexpr int kMaxRows = 32;       // rows a cluster
constexpr int kThreads = 256;      // a CTA; Plan::threads of them compute
constexpr int kClusterUnschedulable = -1;

struct Plan {
  int cluster;          // CTAs a cluster: 1, 2, 4 or 8
  int units;            // units a CTA (the last CTA may own fewer)
  int unit_pad;         // units rounded up to the 8 unit lanes
  int rows;             // rows a cluster, a multiple of rows_per_thread
  int rows_per_thread;  // RT
  int gates_per_thread;  // GT: 4, or 1 at 1 row (4x the threads)
  int row_lanes;        // rows / RT
  int groups;           // row groups a head
  int threads;          // computing threads: 4 / GT * unit_pad * row_lanes
  int hstride;          // floats a row of an h buffer: 4 mod 32
  int smem;             // dynamic shared memory bytes a CTA
};

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The partition of a call whose row groups, `budget` clusters at most
// when the heads allow, all run at once (one wave).
Plan plan(int batch, int n_heads, int hd, int budget) {
  Plan p;
  p.cluster = 1;
  while (p.cluster * kMaxUnits < hd) p.cluster *= 2;
  p.units = ceil_div(hd, p.cluster);
  p.unit_pad = ceil_div(p.units, kUnitLanes) * kUnitLanes;
  const int per_head = budget / n_heads;
  int rows = ceil_div(batch, per_head > 1 ? per_head : 1);
  rows = rows < kMaxRows ? rows : kMaxRows;
  p.rows_per_thread = rows >= 16 ? 4 : rows >= 8 ? 2 : 1;
  p.gates_per_thread = rows == 1 ? 1 : 4;
  p.row_lanes = ceil_div(rows, p.rows_per_thread);
  p.rows = p.row_lanes * p.rows_per_thread;
  p.groups = ceil_div(batch, p.rows);
  p.threads = 4 / p.gates_per_thread * p.unit_pad * p.row_lanes;
  p.hstride = ceil_div(hd, 32) * 32 + 4;
  p.smem = (int)sizeof(float4) * hd * p.unit_pad +
           (int)sizeof(float) * 2 * p.rows * p.hstride + 2 * (int)sizeof(uint64_t);
  return p;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

// The cluster barrier: once, after set-up (it lowers to a GPU-wide
// memory barrier and an L1 invalidation, too dear for every step).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
// A 4-byte store into another CTA's shared memory that counts its bytes
// on that CTA's barrier `bar` (both cluster addresses).
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
      ::"r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

// State (c, n, m, h), each (batch * n_heads, hd) f32: s0 is read when
// not null, else the zero state; s1 is written when not null.
struct State {
  float* save;  // (rows, heads, seq, 7, hd): a_z, a_i, a_f, a_o, c, n, m
  const float* c0;
  const float* n0;
  const float* m0;
  const float* h0;
  float* c1;
  float* n1;
  float* m1;
  float* h1;
};

// GT consecutive gate weights of one unit at one input: a float4 (GT =
// 4, the unit's z, i, f, o) or one float (GT = 1).
template <int GT>
struct Gates {
  float v[GT];
};
template <int GT>
__device__ __forceinline__ Gates<GT> load_gates(const float* p) {
  Gates<GT> w;
  if constexpr (GT == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    w.v[0] = x.x;
    w.v[1] = x.y;
    w.v[2] = x.z;
    w.v[3] = x.w;
  } else {
    w.v[0] = *p;
  }
  return w;
}

// acc[k][g] = sum over i of h[row k][i] * r_h[i][gate * hd + unit], one
// fmaf chain a (row, gate) in i order, for this thread's GT gates. rg
// points at them in the (hd, unit_pad, 4) slice (`stride` floats an
// input); hb at the thread's first row of an h buffer, `hstride` floats
// a row (16 bytes of four inputs a load).
template <int RT, int GT>
__device__ __forceinline__ void products(const float* __restrict__ rg,
                                         const float* __restrict__ hb, int hd,
                                         int hstride, int stride,
                                         float (&acc)[RT][GT]) {
  constexpr int kUnroll = RT >= 4 ? 4 : 8;
  const int hd4 = hd & ~3;
#pragma unroll kUnroll
  for (int i = 0; i < hd4; i += 4) {
    float hx[RT][4];
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(hb + k * hstride + i);
      hx[k][0] = v.x;
      hx[k][1] = v.y;
      hx[k][2] = v.z;
      hx[k][3] = v.w;
    }
    Gates<GT> w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = load_gates<GT>(rg + (i + j) * stride);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < RT; ++k)
#pragma unroll
        for (int g = 0; g < GT; ++g)
          acc[k][g] = fmaf(hx[k][j], w[j].v[g], acc[k][g]);
  }
  for (int i = hd4; i < hd; ++i) {
    const Gates<GT> w = load_gates<GT>(rg + i * stride);
#pragma unroll
    for (int k = 0; k < RT; ++k)
#pragma unroll
      for (int g = 0; g < GT; ++g)
        acc[k][g] = fmaf(hb[k * hstride + i], w.v[g], acc[k][g]);
  }
}

// One step of one (row, unit): the gates from x = pre + acc (z, i, f,
// o), the state update in place, h_t returned.
__device__ __forceinline__ float cell_update(const float (&x)[4], float& c,
                                             float& n, float& m) {
  const float z = tanhf(x[0]);
  const float log_i = x[1];
  const float log_f = log_sigmoid(x[2]);
  const float o = 1.0f / (1.0f + expf(-x[3]));
  const float m_new = fmaxf(log_f + m, log_i);
  const float i_g = expf(log_i - m_new);
  const float f_g = expf(log_f + m - m_new);
  c = f_g * c + i_g * z;
  n = f_g * n + i_g;
  m = m_new;
  return o * c / fmaxf(fabsf(n), 1.0f);
}

// h_t of this thread's RT rows at its unit into the next h buffer `next`
// (byte offset `off` of its first row, `hstride` floats a row) of CTAs
// first, first + step, ... of the cluster (its own among them), each
// 4-byte store counted on that CTA's barrier `bar`.
template <int RT>
__device__ __forceinline__ void exchange_h(uint32_t next, uint32_t bar,
                                           const float (&hn)[RT], int off,
                                           int hstride, int first, int step,
                                           int n_cta) {
  for (int q = first; q < n_cta; q += step) {
    const uint32_t peer = map_rank(next, q), peer_bar = map_rank(bar, q);
#pragma unroll
    for (int k = 0; k < RT; ++k)
      st_async(peer + off + 4 * k * hstride, hn[k], peer_bar);
  }
}

// Wait until the h that step t reads (t >= 1; t = seq after the loop: the
// last h stored here) has landed: step t's h fills buffer t & 1, the
// ((t - 1) / 2)-th phase of its barrier.
__device__ __forceinline__ void wait_h(uint32_t bar0, int t) {
  bar_wait(bar0 + 8 * (t & 1), ((t - 1) >> 1) & 1);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// r_h's slice into shared memory: (i, unit) holds the unit's four gate
// columns of row i of the head's (hd, 4hd) r (rh points at unit u0 of
// row 0); units past the slice or past hd are zero. Every thread of the
// block loads, many loads in flight each: the slice is the one large
// read of a call. Four units of a gate at once where r's layout allows.
template <typename T>
__device__ __forceinline__ void load_slice(float4* __restrict__ rs,
                                           const T* __restrict__ rh, int hd,
                                           int u0, const Plan& pl, int tid) {
  if (hd % 4 == 0 && pl.units % 4 == 0 &&
      reinterpret_cast<uintptr_t>(rh) % (4 * sizeof(T)) == 0) {
    const int quads = pl.unit_pad / 4;
#pragma unroll 4
    for (int it = tid; it < hd * quads; it += kThreads) {
      const int i = it / quads, uq = 4 * (it - i * quads);
      float4 g[4] = {};
      if (uq < pl.units && u0 + uq < hd) {
#pragma unroll
        for (int gg = 0; gg < 4; ++gg)
          g[gg] = load4(rh + (int64_t)i * 4 * hd + gg * hd + uq);
      }
      float4* dst = rs + (size_t)i * pl.unit_pad + uq;
      dst[0] = make_float4(g[0].x, g[1].x, g[2].x, g[3].x);
      dst[1] = make_float4(g[0].y, g[1].y, g[2].y, g[3].y);
      dst[2] = make_float4(g[0].z, g[1].z, g[2].z, g[3].z);
      dst[3] = make_float4(g[0].w, g[1].w, g[2].w, g[3].w);
    }
    return;
  }
#pragma unroll 8
  for (int it = tid; it < hd * pl.unit_pad; it += kThreads) {
    const int i = it / pl.unit_pad, uu = it - i * pl.unit_pad;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (uu < pl.units && u0 + uu < hd) {
      const T* src = rh + (int64_t)i * 4 * hd + uu;
      v = make_float4(to_f32(src[0]), to_f32(src[hd]), to_f32(src[2 * hd]),
                      to_f32(src[3 * hd]));
    }
    rs[it] = v;
  }
}

// Grid: (n_heads * groups) clusters, n_heads = clients * heads (client
// c's head h is head c * heads + h; its rows are c * batch + b) of pl.cluster CTAs of kThreads
// threads; the first pl.threads compute, each RT rows of one unit and GT
// of its gates (GT < 4: the unit's four gates on 4 / GT adjacent lanes,
// which gather the gate values by shuffles and run the same state
// update). Thread t: gate lane t % GL (GL = 4 / GT), and with t' = t /
// GL: unit lane t' % 8, row lane (t' / 8) % row_lanes, unit group t' /
// (8 * row_lanes); rows row_lane * RT + k, k < RT.
template <typename T, int RT, int GT>
__global__ void __launch_bounds__(kThreads, 1)
    slstm_kernel(const T* __restrict__ pre_x, const T* __restrict__ r,
                 T* __restrict__ out, int batch, int n_heads, int heads,
                 int seq, int hd, Plan pl, State st) {
  constexpr int GL = 4 / GT;
  extern __shared__ float4 smem4[];
  float4* rs_all = smem4;  // (hd, unit_pad) float4: gates z, i, f, o
  float* hbuf = reinterpret_cast<float*>(smem4 + (size_t)hd * pl.unit_pad);
  const int hbuf_size = pl.rows * pl.hstride;  // one parity
  // barrier p counts the h stores into buffer p
  const uint32_t bar0 = smem_addr(hbuf + 2 * hbuf_size);
  const int h_bytes = pl.rows * hd * (int)sizeof(float);  // a step's h, all rows

  const int cid = blockIdx.x / pl.cluster;
  const int rank = blockIdx.x % pl.cluster;  // the cluster spans x
  const int vhead = cid / pl.groups;  // client * heads + head
  const int client = vhead / heads;
  const int head = vhead - client * heads;
  const int group = cid % pl.groups;
  const int64_t row_base = (int64_t)client * batch;  // the client's first row
  const int u0 = rank * pl.units;
  const int tid = threadIdx.x;

  load_slice<T>(rs_all, r + (int64_t)vhead * hd * 4 * hd + u0, hd, u0, pl, tid);
  // h_{-1} of every row of the group into the parity-0 buffer.
  for (int idx = tid; idx < hbuf_size; idx += kThreads) {
    const int row = idx / pl.hstride, i = idx - row * pl.hstride;
    const int b = group * pl.rows + row;
    hbuf[idx] = (st.h0 != nullptr && b < batch && i < hd)
                    ? st.h0[((row_base + b) * heads + head) * hd + i]
                    : 0.0f;
  }

  // threads past pl.threads only load; whole warps, as pl.threads is a
  // multiple of 32 whenever GT = 1 (the shuffles need every lane)
  const bool computes = tid < pl.threads;
  const int gl = tid % GL;
  const int tu = tid / GL;
  const int ul = tu % kUnitLanes;
  const int lane_q = tu / kUnitLanes;
  const int rl = lane_q % pl.row_lanes;
  const int u = (lane_q / pl.row_lanes) * kUnitLanes + ul;
  const int unit = u0 + u;
  const bool unit_ok = computes && u < pl.units && unit < hd;
  const float* rg = reinterpret_cast<const float*>(rs_all + u) + gl * GT;

  bool row_ok[RT];
  const T* pre_k[RT];
  T* out_k[RT];
  float* save_k[RT];
  float c[RT], n[RT], m[RT], hl[RT];
#pragma unroll
  for (int k = 0; k < RT; ++k) {
    const int b = group * pl.rows + rl * RT + k;
    row_ok[k] = unit_ok && b < batch;
    const int64_t bh = (row_base + (row_ok[k] ? b : 0)) * heads + head;
    pre_k[k] = pre_x + bh * seq * 4 * hd + (unit_ok ? gl * GT * hd + unit : 0);
    out_k[k] = out + bh * seq * hd + (unit_ok ? unit : 0);
    save_k[k] = st.save + (st.save != nullptr ? bh * seq * 7 * hd + (unit_ok ? unit : 0) : 0);
    c[k] = 0.0f;
    n[k] = 0.0f;
    m[k] = -1e30f;
    hl[k] = 0.0f;
    if (st.c0 != nullptr && row_ok[k]) {
      const int64_t sj = bh * hd + unit;
      c[k] = st.c0[sj];
      n[k] = st.n0[sj];
      m[k] = st.m0[sj];
      hl[k] = st.h0[sj];
    }
  }

  // pre-activations of step t of this thread's gates, 0 where no row
  float nxt[RT][GT];
#pragma unroll
  for (int k = 0; k < RT; ++k)
#pragma unroll
    for (int g = 0; g < GT; ++g)
      nxt[k][g] = (row_ok[k] && seq > 0) ? to_f32(pre_k[k][g * hd]) : 0.0f;

  if (tid == 0) {
    bar_init(bar0);
    bar_init(bar0 + 8);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    bar_arm(bar0 + 8, h_bytes);  // step 1's h
    bar_arm(bar0, h_bytes);      // step 2's h
  }
  // every CTA of the cluster is running, its buffers filled and its
  // barriers armed before any step reads them or a peer stores into them
  cluster_sync();
  if (!computes) return;
  const uint32_t hbuf_addr = smem_addr(hbuf);
  const int row0 = rl * RT;                         // this thread's first row
  const int off = 4 * (row0 * pl.hstride + unit);  // its h, in bytes

  for (int t = 0; t < seq; ++t) {
    if (t > 0) {
      wait_h(bar0, t);
      if (tid == 0 && t + 2 <= seq)
        bar_arm(bar0 + 8 * (t & 1), h_bytes);  // step t + 2's h
    }
    float p[RT][GT];
#pragma unroll
    for (int k = 0; k < RT; ++k)
#pragma unroll
      for (int g = 0; g < GT; ++g) p[k][g] = nxt[k][g];
    if (t + 1 < seq) {
#pragma unroll
      for (int k = 0; k < RT; ++k)
#pragma unroll
        for (int g = 0; g < GT; ++g)
          if (row_ok[k])
            nxt[k][g] = to_f32(pre_k[k][(int64_t)(t + 1) * 4 * hd + g * hd]);
    }
    float acc[RT][GT];
#pragma unroll
    for (int k = 0; k < RT; ++k)
#pragma unroll
      for (int g = 0; g < GT; ++g) acc[k][g] = 0.0f;
    if (unit_ok)
      products<RT, GT>(rg, hbuf + (t & 1) * hbuf_size + row0 * pl.hstride, hd,
                       pl.hstride, 4 * pl.unit_pad, acc);

    float hn[RT];
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      float x[4];
      if constexpr (GT == 4) {
#pragma unroll
        for (int g = 0; g < 4; ++g) x[g] = p[k][g] + acc[k][g];
      } else {  // gate g is gate g % GT of lane g / GT of the unit's GL
        float mine[GT];
#pragma unroll
        for (int g = 0; g < GT; ++g) mine[g] = p[k][g] + acc[k][g];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          x[g] = __shfl_sync(0xffffffffu, mine[g % GT],
                             (tid & 31 & ~(GL - 1)) | (g / GT));
      }
      hn[k] = cell_update(x, c[k], n[k], m[k]);
      if (st.save != nullptr && row_ok[k] && gl == 0) {
        float* sp = save_k[k] + (int64_t)t * 7 * hd;
#pragma unroll
        for (int g = 0; g < 4; ++g) sp[g * hd] = x[g];
        sp[4 * hd] = c[k];
        sp[5 * hd] = n[k];
        sp[6 * hd] = m[k];
      }
    }

    if (unit_ok)
      exchange_h<RT>(hbuf_addr + 4 * ((t + 1) & 1) * hbuf_size,
                     bar0 + 8 * ((t + 1) & 1), hn, off, pl.hstride, gl, GL,
                     pl.cluster);
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      hl[k] = hn[k];
      if (row_ok[k] && gl == 0) store(out_k[k] + (int64_t)t * hd, hn[k]);
    }
  }
  // no CTA leaves while a peer may still store into its shared memory
  if (seq > 0) wait_h(bar0, seq);

  if (st.c1 != nullptr && gl == 0) {
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      if (!row_ok[k]) continue;
      const int64_t sj =
          ((row_base + group * pl.rows + rl * RT + k) * heads + head) * hd + unit;
      st.c1[sj] = c[k];
      st.n1[sj] = n[k];
      st.m1[sj] = m[k];
      st.h1[sj] = hl[k];
    }
  }
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

// The dynamic shared-memory limit last set on a kernel instance (on the
// current device; a change of device re-prepares, see run()).
template <typename T, int RT, int GT>
int& smem_limit() {
  static int bytes = -1;
  return bytes;
}

// Set the kernel's dynamic shared-memory limit to `bytes`.
template <typename T, int RT, int GT>
int set_smem_limit(int bytes) {
  const int err = (int)cudaFuncSetAttribute(
      slstm_kernel<T, RT, GT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  smem_limit<T, RT, GT>() = err == 0 ? bytes : -1;
  return err;
}

// Set the kernel's dynamic shared-memory limit to the plan's, then ask
// how many of its clusters the card can hold at once (*active).
template <typename T, int RT, int GT>
int prepare(const Launch& l, int* active) {
  const int err = set_smem_limit<T, RT, GT>((int)l.cfg.dynamicSmemBytes);
  if (err != 0) return err;
  return (int)cudaOccupancyMaxActiveClusters(active, slstm_kernel<T, RT, GT>,
                                             &l.cfg);
}

// The occupancy answer of the last (device, plan) checked, per kernel.
struct Checked {
  int device = -1, cluster = 0, threads = 0, smem = 0;
};

template <typename T, int RT, int GT>
int run(const Plan& pl, const void* pre_x, const void* r, void* out,
        int batch, int n_heads, int heads, int seq, int hd, State st,
        void* stream) {
  static std::mutex mu;
  static Checked last;
  Launch l(pl, n_heads, stream);
  int device = 0;
  int err = (int)cudaGetDevice(&device);
  if (err != 0) return err;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (last.device != device || last.cluster != pl.cluster ||
        last.threads != pl.threads || last.smem != pl.smem) {
      int active = 0;
      err = prepare<T, RT, GT>(l, &active);
      if (err != 0) return err;
      if (active < 1) return kClusterUnschedulable;
      last = Checked{device, pl.cluster, pl.threads, pl.smem};
    } else if (smem_limit<T, RT, GT>() != pl.smem) {
      // a plan query (cluster_budget, active_clusters) set another limit
      err = set_smem_limit<T, RT, GT>(pl.smem);
      if (err != 0) return err;
    }
  }
  err = (int)cudaLaunchKernelEx(
      &l.cfg, slstm_kernel<T, RT, GT>, static_cast<const T*>(pre_x),
      static_cast<const T*>(r), static_cast<T*>(out), batch, n_heads, heads,
      seq, hd, pl, st);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

// How many clusters of hd's largest plan (kMaxRows rows: the most shared
// memory) the current device holds at once, cached per (device, hd): the
// budget plan() spreads a call's row groups over. An H100 holds 15
// clusters of 8 CTAs of this kernel at hd = 256, not 132 / 8.
template <typename T>
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
  err = prepare<T, 4, 4>(Launch(big, 1, nullptr), budget);
  if (err != 0) return err;
  if (*budget < 1) return kClusterUnschedulable;
  cache[key] = *budget;
  return 0;
}

// batch rows a client; the grid's heads are the clients' (client, head)
// pairs, so a stacked call plans as one of clients * heads heads.
template <typename T>
int launch(const void* pre_x, const void* r, void* out, int clients,
           int batch, int heads, int seq, int hd, State st, void* stream) {
  if (hd < 1 || hd > kMaxHd || batch < 1 || heads < 1 || clients < 1 ||
      seq < 0 || (int64_t)clients * heads > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  int budget = 0;
  const int err = cluster_budget<T>(hd, &budget);
  if (err != 0) return err;
  const int n_heads = clients * heads;
  const Plan pl = plan(batch, n_heads, hd, budget);
  if (pl.gates_per_thread == 1)
    return run<T, 1, 1>(pl, pre_x, r, out, batch, n_heads, heads, seq, hd, st,
                        stream);
  switch (pl.rows_per_thread) {
    case 1:
      return run<T, 1, 4>(pl, pre_x, r, out, batch, n_heads, heads, seq, hd,
                          st, stream);
    case 2:
      return run<T, 2, 4>(pl, pre_x, r, out, batch, n_heads, heads, seq, hd,
                          st, stream);
    default:
      return run<T, 4, 4>(pl, pre_x, r, out, batch, n_heads, heads, seq, hd,
                          st, stream);
  }
}

template <typename T>
int active_clusters(const Plan& pl, int n_heads, int* active) {
  Launch l(pl, n_heads, nullptr);
  if (pl.gates_per_thread == 1) return prepare<T, 1, 1>(l, active);
  switch (pl.rows_per_thread) {
    case 1: return prepare<T, 1, 4>(l, active);
    case 2: return prepare<T, 2, 4>(l, active);
    default: return prepare<T, 4, 4>(l, active);
  }
}

}  // namespace

// Plain C entry points for ctypes, one a dtype. pre_x is a contiguous
// (clients * batch, n_heads, seq, 4, hd) array, r a contiguous (clients,
// n_heads, hd, 4 * hd) array (clients = 1: one head set for every row)
// and out a contiguous (clients * batch, n_heads, seq, hd) array, all of
// the named dtype and on the device of `stream`; 1 <= hd <= 256. Rows
// [c * batch, (c + 1) * batch) run with client c's r. save is null or a
// contiguous (clients * batch, n_heads, seq, 7, hd) f32 array that
// receives each step's gate sums and (c, n, m). c0, n0, m0, h0 are the
// initial state and c1, n1, m1, h1 the final state, each a contiguous
// (clients * batch, n_heads, hd) f32 array: c0 .. h0 all null (the zero
// state) or none, and likewise c1 .. h1 (not written). Returns
// cudaGetLastError() after the launch, a CUDA error of the set-up, or
// -1 when the card cannot hold one cluster of the plan.
#define STATE_ARGS                                                        \
  const float *c0, const float *n0, const float *m0, const float *h0,    \
      float *c1, float *n1, float *m1, float *h1

extern "C" int slstm_cell_stacked_f32(const void* pre_x, const void* r,
                                      void* out, float* save, STATE_ARGS,
                                      int clients, int batch, int heads,
                                      int seq, int hd, void* stream) {
  return launch<float>(pre_x, r, out, clients, batch, heads, seq, hd,
                       State{save, c0, n0, m0, h0, c1, n1, m1, h1}, stream);
}

extern "C" int slstm_cell_stacked_bf16(const void* pre_x, const void* r,
                                       void* out, float* save, STATE_ARGS,
                                       int clients, int batch, int heads,
                                       int seq, int hd, void* stream) {
  return launch<__nv_bfloat16>(pre_x, r, out, clients, batch, heads, seq, hd,
                               State{save, c0, n0, m0, h0, c1, n1, m1, h1},
                               stream);
}

// The plan of a call, for the launcher's tests: out[0..10] = cluster,
// units, unit_pad, rows, rows_per_thread, gates_per_thread, row_lanes,
// groups, threads, hstride, smem; out[11] = the cluster budget it was
// made with; out[12] = the clusters of it the current device can hold
// at once (cudaOccupancyMaxActiveClusters), for the f32 (bf16 = 0) or
// bf16 kernel. Returns 0, a CUDA error, or -1 as the entry points do.
extern "C" int slstm_cell_plan(int batch, int n_heads, int hd, int bf16,
                               int* out) {
  if (hd < 1 || hd > kMaxHd || batch < 1 || n_heads < 1)
    return (int)cudaErrorInvalidValue;
  int budget = 0;
  const int err = bf16 ? cluster_budget<__nv_bfloat16>(hd, &budget)
                       : cluster_budget<float>(hd, &budget);
  if (err != 0) return err;
  const Plan pl = plan(batch, n_heads, hd, budget);
  const int fields[11] = {pl.cluster,   pl.units,
                          pl.unit_pad,  pl.rows,
                          pl.rows_per_thread, pl.gates_per_thread,
                          pl.row_lanes, pl.groups,
                          pl.threads,   pl.hstride,
                          pl.smem};
  for (int i = 0; i < 11; ++i) out[i] = fields[i];
  out[11] = budget;
  return bf16 ? active_clusters<__nv_bfloat16>(pl, n_heads, &out[12])
              : active_clusters<float>(pl, n_heads, &out[12]);
}
