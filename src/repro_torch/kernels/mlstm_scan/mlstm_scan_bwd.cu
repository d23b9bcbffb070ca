// Backward of the chunkwise gated linear scan (the mLSTM cell of xLSTM,
// and the Mamba-2 heads with normalize off) in f32, on SIMT.
//
// Replaces no TPU kernel: the reference differentiates its XLA
// gated_linear_scan (src/repro/models/recurrent.py:28-112) with jax.grad,
// and its Pallas scan (src/repro/kernels/mlstm_scan/mlstm_scan.py:88)
// has no backward. Forward, per (b, h), with the per-step log decay
// lf_t <= 0 and b_t = lf_0 + .. + lf_t:
//   h^_t = q_t [C_t | n_t],  C_t = sum_{s<=t} exp(b_t - b_s) k_s v_s^T,
//   n_t the same with v = 1;  h_t = h^_t[:dv] / max(|h^_t[dv]|, 1)
// (h_t = h^_t[:dv] without normalize). The normalizer is one more value
// column, so the normalize step's backward is elementwise per row (the
// prep kernel: du = dh / den, ds = -(dh . h) / den * sign(s) [|s| >= 1],
// torch.abs / clamp_min's derivative), and what is left is the backward
// of the unnormalized scan with v~ = [v | 1], dh~ = [du | ds]:
//   dq_t = sum_{s<=t} exp(b_t - b_s) (dh~_t . v~_s) k_s
//   dk_j = sum_{i>=j} exp(b_i - b_j) (v~_j . dh~_i) q_i
//   dv_j = sum_{i>=j} exp(b_i - b_j) (k_j . q_i) du_i
// three gated linear scans, the first causal, the other two anti-causal
// (the scan kernel, one launch for all three), and
//   dlf_s = sum_{t>=s} (q_t . dq_t - k_t . dk_t)
// (the scalar-gate identity of Gated Linear Attention and Mamba-2's SSD
// backward: d b_t = q_t . dq_t - k_t . dk_t; the dlogf kernel). So no
// decay gradient is carried and no forward state is stored: the causal
// scan rebuilds C chunk by chunk as the forward does, the anti-causal
// ones carry the state's gradient from the last chunk back.
//
// Bound: operations. Per (b, h) and chunk of L, with P = dv + 1 (dv
// without normalize): the two score matrices L(L+1) (P + dk), the three
// in-chunk sums L(L+1) (2 dk + dv), and in every chunk but the first of
// each sweep 2 L P dk (q.C, twice) + 2 L dk dv, as many again for the
// state updates of every chunk but the last. At (8, 4, 128, 512, 512),
// L = 64, normalize on: 7.16 GFLOP, 0.107 ms on SIMT f32 (67 TFLOP/s,
// the engine this kernel runs on; 0.043 ms at the 3xTF32 rate of the
// tensor cores), against 67 MB of HBM traffic (0.020 ms); chip_smoke.py
// phase 26 computes it from the call's shape (mlstm_bwd_flops).
//
// Design (simple first: SIMT f32, no tensor cores). Each CTA of the scan
// kernel owns one (job, b, h, 64 value columns): the job's state (P x
// 64, at most 704 rows) in shared memory for the whole sequence, walked
// chunk by chunk in the job's direction. A chunk streams the query axis
// in tiles of 32, each fetched into registers while the tile before it
// is computed: each tile's a and b rows give the L x L scores and the
// inter-chunk term a.M (4 x 4 of each a thread, in registers), then the
// tile's state rows are updated (their old values are read first; 2 x 4
// a thread). The scores are decayed and masked before the exponent (for
// a pair outside the triangle the exponent is positive and may
// overflow), then summed against the chunk's 64 value columns (4 x 4 a
// thread). Every column block recomputes the chunk's scores: P L^2 a
// chunk against the 4 P L 64 of its own products, the price of not
// sharing them across CTAs. Every sum over steps runs in step order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kL = 64;              // chunk: time rows a tile
constexpr int kCols = 64;           // value columns a CTA owns
constexpr int kTP = 32;             // query-axis tile
constexpr int kLdt = kTP + 1;       // row stride of the a / b tiles
constexpr int kLdc = kCols + 1;     // row stride of the value and score tiles
constexpr int kMaxSmem = 232448;    // dynamic shared memory a block may have
constexpr int kMaxDk = 4 * kThreads;  // the prep kernel's n in registers
constexpr int kJobs = 3;
constexpr int kFetch = kL * kTP / kThreads;  // a / b tile entries a thread loads

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Dynamic shared memory of a scan CTA whose query axis has P entries.
__host__ __device__ constexpr int scan_smem_bytes(int p) {
  return 4 * (round_up(p, kTP) * kCols + 2 * kL * kLdt + 2 * kL * kLdc +
              3 * kL);
}

// One scan operand: rows of `dim` floats, (bh, S, dim), plus optionally
// one more column: 1 everywhere (kOnes) or extra[bh * S + t] (kExtra).
enum { kNone = 0, kOnes = 1, kExtra = 2 };
struct Operand {
  const float* x;
  const float* extra;
  int dim;
  int mode;
};

// out_r = sum_s exp(-|b_r - b_s|) (a_r . b_s) c_s over s <= r (causal:
// chunks in order) or s >= r (anti-causal: chunks from the last), the
// state of the chunks already walked carried in shared memory.
struct Job {
  Operand a, b;
  const float* c;  // (bh, S, vdim) value rows
  float* out;      // (bh, S, vdim)
  int vdim;
  int reverse;
};

struct Jobs {
  Job job[kJobs];
  int count;
};

__device__ __forceinline__ int width(const Operand& o) {
  return o.dim + (o.mode != kNone ? 1 : 0);
}

__device__ __forceinline__ float load_op(const Operand& o, int64_t bh, int seq,
                                         int t, int p) {
  if (t >= seq) return 0.f;
  if (p < o.dim) return o.x[(bh * seq + t) * (int64_t)o.dim + p];
  if (p == o.dim) {
    if (o.mode == kOnes) return 1.f;
    if (o.mode == kExtra) return o.extra[bh * seq + t];
  }
  return 0.f;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The three scans of the backward, one CTA a (job, bh, column block).
__global__ void __launch_bounds__(kThreads, 1)
mlstm_bwd_scan(Jobs jobs, const float* __restrict__ lf, int bh_count, int seq) {
  extern __shared__ float smem[];
  // which job, (b, h) and column block this CTA owns
  int idx = blockIdx.x, j = 0;
  for (; j < jobs.count; ++j) {
    const int n = bh_count * ((jobs.job[j].vdim + kCols - 1) / kCols);
    if (idx < n) break;
    idx -= n;
  }
  const Job& job = jobs.job[j];
  const int blocks = (job.vdim + kCols - 1) / kCols;
  const int64_t bh = idx / blocks;
  const int col0 = (idx % blocks) * kCols;
  const int p_all = width(job.a);
  const int pp = round_up(p_all, kTP);

  float* ms = smem;                 // state, pp x kCols
  float* as = ms + pp * kCols;      // a tile, kL x kLdt
  float* bs = as + kL * kLdt;       // b tile
  float* cs = bs + kL * kLdt;       // value tile, kL x kLdc
  float* ps = cs + kL * kLdc;       // decayed, masked scores
  float* dl = ps + kL * kLdc;       // in-chunk cumulative log decay
  float* w_state = dl + kL;         // a row's weight into the carried state
  float* w_inter = w_state + kL;    // a row's weight on the carried state

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  for (int i = tid; i < pp * kCols; i += kThreads) ms[i] = 0.f;

  const int nc = (seq + kL - 1) / kL;
  for (int ci = 0; ci < nc; ++ci) {
    const int chunk = job.reverse ? nc - 1 - ci : ci;
    const int t0 = chunk * kL;
    const bool has_state = ci > 0;      // the first chunk of a sweep starts at 0
    const bool update = ci < nc - 1;    // the last one's state is never read
    __syncthreads();  // the previous chunk is done with cs, ps, dl
    if (tid < kL) dl[tid] = t0 + tid < seq ? lf[bh * seq + t0 + tid] : 0.f;
    for (int e = tid; e < kL * kCols; e += kThreads) {
      const int r = e / kCols, col = e % kCols;
      cs[r * kLdc + col] =
          (t0 + r < seq && col0 + col < job.vdim)
              ? job.c[(bh * seq + t0 + r) * (int64_t)job.vdim + col0 + col]
              : 0.f;
    }
    __syncthreads();
    if (tid == 0) {  // inclusive cumulative sum, in step order
      float acc = 0.f;
      for (int r = 0; r < kL; ++r) dl[r] = (acc += dl[r]);
    }
    __syncthreads();
    const float big_d = dl[kL - 1];
    if (tid < kL) {
      const float d = dl[tid];
      w_state[tid] = job.reverse ? expf(d) : expf(big_d - d);
      w_inter[tid] = job.reverse ? expf(big_d - d) : expf(d);
    }
    const float decay = expf(big_d);

    float sc[4][4], it[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) sc[a][b] = it[a][b] = 0.f;

    // the tiles of a and b stream through registers one tile ahead: a
    // tile's loads are in flight while the one before it is computed
    float ra[kFetch], rb[kFetch];
    auto fetch = [&](int p0) {
#pragma unroll
      for (int i = 0; i < kFetch; ++i) {
        const int e = tid + i * kThreads, r = e / kTP, p = e % kTP;
        ra[i] = load_op(job.a, bh, seq, t0 + r, p0 + p);
        rb[i] = load_op(job.b, bh, seq, t0 + r, p0 + p);
      }
    };
    fetch(0);
    for (int p0 = 0; p0 < pp; p0 += kTP) {
      __syncthreads();  // the last tile's products and update are done with as, bs
#pragma unroll
      for (int i = 0; i < kFetch; ++i) {
        const int e = tid + i * kThreads, r = e / kTP, p = e % kTP;
        as[r * kLdt + p] = ra[i];
        bs[r * kLdt + p] = rb[i];
      }
      __syncthreads();
      if (p0 + kTP < pp) fetch(p0 + kTP);
#pragma unroll 4
      for (int p = 0; p < kTP; ++p) {
        float ar[4], br[4], mr[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          ar[a] = as[(ty + 16 * a) * kLdt + p];
          br[a] = bs[(tx + 16 * a) * kLdt + p];
          mr[a] = ms[(p0 + p) * kCols + tx + 16 * a];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            sc[a][b] = fmaf(ar[a], br[b], sc[a][b]);
            it[a][b] = fmaf(ar[a], mr[b], it[a][b]);
          }
      }
      if (update) {
        // the tile's 32 state rows x 64 columns, 2 x 4 a thread (rows ty
        // and ty + 16, columns tx + 16 j), summed over the chunk in step order
        __syncthreads();  // every read of this tile's old state rows is done
        float acc[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
        for (int s = 0; s < kL; ++s) {
          const float w = w_state[s];
          const float bw[2] = {bs[s * kLdt + ty] * w, bs[s * kLdt + ty + 16] * w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float c = cs[s * kLdc + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 2; ++i) acc[i][j] = fmaf(bw[i], c, acc[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float* m = &ms[(p0 + ty + 16 * i) * kCols + tx + 16 * j];
            *m = fmaf(decay, *m, acc[i][j]);
          }
      }
    }
    // the scores on r's side of the diagonal, decayed; masked BEFORE the
    // exponent
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = ty + 16 * a, s = tx + 16 * b;
        const bool keep = job.reverse ? s >= r : s <= r;
        ps[r * kLdc + s] =
            keep ? sc[a][b] * expf(job.reverse ? dl[s] - dl[r] : dl[r] - dl[s])
                 : 0.f;
      }
    __syncthreads();
    // out = P c + w_inter (a.M): 4 x 4 a thread, summed in step order
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        acc[a][b] = has_state ? w_inter[ty + 16 * a] * it[a][b] : 0.f;
#pragma unroll 4
    for (int s = 0; s < kL; ++s) {
      float pr[4], cr[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        pr[a] = ps[(ty + 16 * a) * kLdc + s];
        cr[a] = cs[s * kLdc + tx + 16 * a];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(pr[a], cr[b], acc[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int col = tx + 16 * b;
        if (t0 + r < seq && col0 + col < job.vdim)
          job.out[(bh * seq + t0 + r) * (int64_t)job.vdim + col0 + col] = acc[a][b];
      }
    }
  }
}

// The normalize step's backward: s_t = q_t . n_t by the step recurrence
// (n in registers, each thread kMaxDk / kThreads of its entries, 32 steps
// a block barrier), then per row du = dh / den and ds = -(dh . h) / den
// * sign(s) [|s| >= 1], den = max(|s|, 1). One CTA a (b, h).
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_prep(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ lf, const float* __restrict__ h,
               const float* __restrict__ dh, float* __restrict__ du,
               float* __restrict__ ds, int seq, int dk, int dv) {
  __shared__ float red[kWarps][33];
  __shared__ float sv[32];
  const int64_t bh = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float* qb = q + bh * seq * (int64_t)dk;
  const float* kb = k + bh * seq * (int64_t)dk;
  float n[kMaxDk / kThreads];
#pragma unroll
  for (int e = 0; e < kMaxDk / kThreads; ++e) n[e] = 0.f;
  for (int t0 = 0; t0 < seq; t0 += 32) {
    const int steps = min(32, seq - t0);
    for (int i = 0; i < steps; ++i) {
      const int t = t0 + i;
      const float a = expf(lf[bh * seq + t]);
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < kMaxDk / kThreads; ++e) {
        const int p = tid + kThreads * e;
        if (p < dk) {
          n[e] = fmaf(a, n[e], kb[(int64_t)t * dk + p]);
          part = fmaf(qb[(int64_t)t * dk + p], n[e], part);
        }
      }
      part = warp_sum(part);
      if (lane == 0) red[warp][i] = part;
    }
    __syncthreads();
    if (tid < steps) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += red[w][tid];
      sv[tid] = s;
    }
    __syncthreads();
    for (int i = warp; i < steps; i += kWarps) {
      const int64_t row = (bh * seq + t0 + i) * (int64_t)dv;
      const float s = sv[i];
      const float den = fmaxf(fabsf(s), 1.f);
      float g = 0.f;
      for (int c = lane; c < dv; c += 32) g = fmaf(dh[row + c], h[row + c], g);
      g = warp_sum(g);
      for (int c = lane; c < dv; c += 32) du[row + c] = dh[row + c] / den;
      if (lane == 0) {
        const float gate =
            fabsf(s) >= 1.f ? (s > 0.f ? 1.f : (s < 0.f ? -1.f : 0.f)) : 0.f;
        ds[bh * seq + t0 + i] = -g / den * gate;
      }
    }
    __syncthreads();  // red and sv are reused by the next 32 steps
  }
}

// dlog_f_s = sum_{t >= s} (q_t . dq_t - k_t . dk_t): a warp a row's dot
// products, then one thread's reverse running sum, 256 rows at a time
// from the end. One CTA a (b, h).
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_dlogf(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ dq, const float* __restrict__ dk,
                float* __restrict__ dlf, int seq, int dkd) {
  __shared__ float db[kThreads];
  const int64_t bh = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float carry = 0.f;  // thread 0's
  for (int end = seq; end > 0; end -= kThreads) {
    const int start = max(0, end - kThreads);
    for (int t = start + warp; t < end; t += kWarps) {
      const int64_t row = (bh * seq + t) * (int64_t)dkd;
      float x = 0.f;
      for (int p = lane; p < dkd; p += 32)
        x += q[row + p] * dq[row + p] - k[row + p] * dk[row + p];
      x = warp_sum(x);
      if (lane == 0) db[t - start] = x;
    }
    __syncthreads();
    if (tid == 0)
      for (int t = end - 1; t >= start; --t) {
        carry += db[t - start];
        dlf[bh * seq + t] = carry;
      }
    __syncthreads();
  }
}

}  // namespace

// Dynamic shared memory bytes of a scan CTA at (dk, dv, normalize): the
// largest of the three jobs' (the query axis is dv (+ 1) for dq and dk,
// dk for dv), or -1 where it exceeds what a block may have or dk exceeds
// the prep kernel's registers.
extern "C" int mlstm_bwd_smem_bytes(int dk, int dv, int normalize) {
  if (dk < 1 || dv < 1 || (normalize && dk > kMaxDk)) return -1;
  const int p = dv + (normalize ? 1 : 0);
  const int bytes = scan_smem_bytes(p > dk ? p : dk);
  return bytes > kMaxSmem ? -1 : bytes;
}

// The backward of one call: q, k (bh, S, dk), v, h, dh (bh, S, dv), lf
// (bh, S) in; dq, dk (bh, S, dk), dv (bh, S, dv), dlf (bh, S) out; du
// (bh, S, dv) and ds (bh, S) scratch, used with normalize only. Launches
// the prep kernel (normalize only), the scan kernel and the dlogf kernel
// on `stream`. Returns 0 or the first CUDA error.
extern "C" int mlstm_scan_bwd_f32(const void* q, const void* k, const void* v,
                                  const void* lf, const void* h, const void* dh,
                                  void* dq, void* dk, void* dv, void* dlf,
                                  void* du, void* ds, int bh, int seq, int dkd,
                                  int dvd, int normalize, void* stream) {
  const int smem = mlstm_bwd_smem_bytes(dkd, dvd, normalize);
  if (smem < 0 || bh < 1 || seq < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* lff = static_cast<const float*>(lf);
  const float* dhf = static_cast<const float*>(dh);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  Operand qo = {qf, nullptr, dkd, kNone}, ko = {kf, nullptr, dkd, kNone};
  Operand vo = {vf, nullptr, dvd, normalize ? kOnes : kNone};
  Operand go = {dhf, nullptr, dvd, kNone};  // dh~
  const float* dvalues = dhf;               // the value rows of dh~
  if (normalize) {
    mlstm_bwd_prep<<<bh, kThreads, 0, st>>>(
        qf, kf, lff, static_cast<const float*>(h), dhf, static_cast<float*>(du),
        static_cast<float*>(ds), seq, dkd, dvd);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    go = {static_cast<const float*>(du), static_cast<const float*>(ds), dvd,
          kExtra};
    dvalues = static_cast<const float*>(du);
  }
  Jobs jobs;
  jobs.count = kJobs;
  jobs.job[0] = {go, vo, kf, dqf, dkd, 0};                              // dq
  jobs.job[1] = {vo, go, qf, dkf, dkd, 1};                              // dk
  jobs.job[2] = {ko, qo, dvalues, static_cast<float*>(dv), dvd, 1};     // dv
  int ctas = 0;
  for (int j = 0; j < kJobs; ++j)
    ctas += bh * ((jobs.job[j].vdim + kCols - 1) / kCols);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_bwd_scan, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  mlstm_bwd_scan<<<ctas, kThreads, smem, st>>>(jobs, lff, bh, seq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlstm_bwd_dlogf<<<bh, kThreads, 0, st>>>(qf, kf, dqf, dkf,
                                           static_cast<float*>(dlf), seq, dkd);
  return (int)cudaGetLastError();
}
