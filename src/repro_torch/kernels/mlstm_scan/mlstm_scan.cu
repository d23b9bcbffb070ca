// Chunkwise gated linear scan (the mLSTM cell of xLSTM) in f32.
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
// Design. An SM holds at most 227 KB of shared memory, and the state of
// one (b, h) at dk = dv = 512 is 1 MiB, so the dv axis is split: block
// (bh, y) owns C[:, 64y : 64y + 64] in shared memory (128 KB at dk = 512)
// for the whole sequence, and walks the chunks in order. Each block
// recomputes the full-dk pieces it needs: the (L, L) score matrix, q.n,
// and its own copy of n (at dk = 512 and 8 column blocks the scores are
// a third of the kernel's operations). q and k stream through shared
// memory in tiles of 32 of the dk axis, and the same q tile feeds the
// scores and q.C. Padded steps beyond S read as q = k = v = 0 and
// lf = 0, so they change neither h nor the state, and are not written.
// Every product is SIMT f32 FMA; no tensor cores, no TMA.
//
// Bound: operations. The chunkwise form does, per (b, h) and chunk,
// 2 L^2 dk (scores) + 2 L^2 dv (intra) + 2 L dk dv (q.C) + 2 L dk dv
// (state) FLOPs: 18.3 GFLOP at (B, H, S, dk, dv) = (8, 4, 512, 512, 512)
// with L = 64, 0.27 ms at 67 TFLOP/s, against 0.17 GB of HBM traffic
// (0.05 ms at 3.35 TB/s). The recomputed scores put this kernel above
// that count; PERF.md has its time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDvBlock = 64;      // columns of C (and of h) a block owns
constexpr int kTk = 32;           // rows of the dk axis a tile holds
constexpr int kTkPad = kTk + 4;   // row stride of the q / k tiles (16-byte aligned)

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Shared memory, in floats, of one block for chunk L and head dim dk.
__host__ __device__ inline size_t smem_floats(int chunk, int dk) {
  const int dkp = round_up(dk, kTk);
  return (size_t)dkp * kDvBlock      // C slice
         + dkp                       // n
         + 2 * (size_t)chunk * kTkPad  // q tile, k tile
         + (size_t)chunk * kDvBlock  // v slice of the chunk
         + (size_t)chunk * (chunk + 4)  // P
         + 5 * (size_t)chunk;        // d, exp(d), exp(D - d), q.n, denominators
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// L = chunk (16, 32, 64 or 128). Thread t works on rows i = t/16 + 16a
// (a < L/16) and columns t%16 + 16b of each (L, L) or (L, 64) tile, so
// that a quarter warp reads one row (a broadcast) and 16 neighbouring
// columns (no bank conflicts).
template <int L>
__global__ void __launch_bounds__(kThreads, 1)
    mlstm_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ lf,
                 float* __restrict__ h_out, float* __restrict__ c_out,
                 float* __restrict__ n_out, int seq, int dk, int dv,
                 int normalize) {
  constexpr int R = L / 16;          // rows (and score columns) a thread holds
  constexpr int G = kThreads / L;    // threads that share one row of q.n
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dkp = round_up(dk, kTk);
  float* Cs = smem;                          // (dkp, 64)
  float* ns = Cs + (size_t)dkp * kDvBlock;   // (dkp,)
  float* qs = ns + dkp;                      // (L, kTkPad)
  float* ks = qs + L * kTkPad;               // (L, kTkPad)
  float* vs = ks + L * kTkPad;               // (L, 64)
  float* Ps = vs + L * kDvBlock;             // (L, L + 4)
  float* ds = Ps + L * (L + 4);              // (L,) in-chunk cumulative decay
  float* eds = ds + L;                       // exp(d_i)
  float* wts = eds + L;                      // exp(D - d_j)
  float* qns = wts + L;                      // q_i . n_prev
  float* dens = qns + L;                     // max(|n.q_i|, 1), or 1

  const int tid = threadIdx.x;
  const int ti = tid / 16, tj = tid % 16;
  const int bh = blockIdx.x;
  const int v0 = blockIdx.y * kDvBlock;
  const float* q_bh = q + (int64_t)bh * seq * dk;
  const float* k_bh = k + (int64_t)bh * seq * dk;
  const float* v_bh = v + (int64_t)bh * seq * dv;
  const float* lf_bh = lf + (int64_t)bh * seq;
  float* h_bh = h_out + (int64_t)bh * seq * dv;

  for (int idx = tid; idx < dkp * kDvBlock; idx += kThreads) Cs[idx] = 0.0f;
  for (int idx = tid; idx < dkp; idx += kThreads) ns[idx] = 0.0f;

  for (int t0 = 0; t0 < seq; t0 += L) {
    const int nvalid = min(L, seq - t0);
    __syncthreads();  // the previous chunk's readers of ds .. vs are done

    // d_i: inclusive cumulative sum of lf over the chunk (warp 0)
    if (tid < L) ds[tid] = tid < nvalid ? lf_bh[t0 + tid] : 0.0f;
    __syncthreads();
    if (tid < 32) {
      constexpr int per = (L + 31) / 32;
      float local[per];
      float run = 0.0f;
#pragma unroll
      for (int e = 0; e < per; ++e) {
        const int idx = tid * per + e;
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
      for (int e = 0; e < per; ++e) {
        const int idx = tid * per + e;
        if (idx < L) ds[idx] = local[e] + excl;
      }
    }
    __syncthreads();
    if (tid < L) {
      eds[tid] = expf(ds[tid]);
      wts[tid] = expf(ds[L - 1] - ds[tid]);
    }

    // scores (q.k over all of dk), q.C for this block's columns, and q.n,
    // one dk tile at a time
    float sacc[R][R], hacc[R][4];
#pragma unroll
    for (int a = 0; a < R; ++a) {
#pragma unroll
      for (int b = 0; b < R; ++b) sacc[a][b] = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) hacc[a][c] = 0.0f;
    }
    float qn = 0.0f;
    const int qn_row = tid / G, qn_lane = tid % G;
    for (int k0 = 0; k0 < dkp; k0 += kTk) {
      for (int idx = tid; idx < L * kTk; idx += kThreads) {
        const int i = idx / kTk, kk = idx % kTk;
        const bool in = i < nvalid && k0 + kk < dk;
        const int64_t off = (int64_t)(t0 + i) * dk + k0 + kk;
        qs[i * kTkPad + kk] = in ? q_bh[off] : 0.0f;
        ks[i * kTkPad + kk] = in ? k_bh[off] : 0.0f;
      }
      __syncthreads();
#pragma unroll 2
      for (int kk = 0; kk < kTk; kk += 4) {
        float4 qa[R], kb[R];
#pragma unroll
        for (int a = 0; a < R; ++a)
          qa[a] = *reinterpret_cast<const float4*>(&qs[(ti + 16 * a) * kTkPad + kk]);
#pragma unroll
        for (int b = 0; b < R; ++b)
          kb[b] = *reinterpret_cast<const float4*>(&ks[(tj + 16 * b) * kTkPad + kk]);
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
          for (int b = 0; b < R; ++b) sacc[a][b] += dot4(qa[a], kb[b]);
        const float* crow = Cs + (size_t)(k0 + kk) * kDvBlock + tj;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float c0 = crow[16 * c], c1 = crow[kDvBlock + 16 * c],
                      c2 = crow[2 * kDvBlock + 16 * c],
                      c3 = crow[3 * kDvBlock + 16 * c];
#pragma unroll
          for (int a = 0; a < R; ++a)
            hacc[a][c] += qa[a].x * c0 + qa[a].y * c1 + qa[a].z * c2 + qa[a].w * c3;
        }
      }
      for (int kk = qn_lane; kk < kTk; kk += G)
        qn = fmaf(qs[qn_row * kTkPad + kk], ns[k0 + kk], qn);
      __syncthreads();  // the tiles are read before the next ones land
    }
#pragma unroll
    for (int off = G / 2; off > 0; off /= 2)
      qn += __shfl_xor_sync(0xffffffffu, qn, off);
    if (qn_lane == 0) qns[qn_row] = qn;

    // decay-masked scores; the chunk's slice of v
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const int i = ti + 16 * a;
#pragma unroll
      for (int b = 0; b < R; ++b) {
        const int j = tj + 16 * b;
        Ps[i * (L + 4) + j] = j <= i ? sacc[a][b] * expf(ds[i] - ds[j]) : 0.0f;
      }
    }
    for (int idx = tid; idx < L * kDvBlock; idx += kThreads) {
      const int j = idx / kDvBlock, col = idx % kDvBlock;
      vs[idx] = j < nvalid && v0 + col < dv
                    ? v_bh[(int64_t)(t0 + j) * dv + v0 + col] : 0.0f;
    }
    __syncthreads();
    if (tid < L) {
      float den = 1.0f;
      if (normalize) {
        float rs = 0.0f;
        for (int j = 0; j <= tid; ++j) rs += Ps[tid * (L + 4) + j];
        den = fmaxf(fabsf(rs + eds[tid] * qns[tid]), 1.0f);
      }
      dens[tid] = den;
    }
    __syncthreads();

    // h = (sum_j P_ij v_j + exp(d_i) q_i C) / den_i
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const int i = ti + 16 * a;
      float acc[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] = hacc[a][c] * eds[i];
      for (int j = 0; j < L; j += 4) {
        const float4 p = *reinterpret_cast<const float4*>(&Ps[i * (L + 4) + j]);
        const float* vrow = vs + j * kDvBlock + tj;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[c] += p.x * vrow[16 * c] + p.y * vrow[kDvBlock + 16 * c] +
                    p.z * vrow[2 * kDvBlock + 16 * c] +
                    p.w * vrow[3 * kDvBlock + 16 * c];
      }
      if (i < nvalid) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = v0 + tj + 16 * c;
          if (col < dv) h_bh[(int64_t)(t0 + i) * dv + col] = acc[c] / dens[i];
        }
      }
    }

    // state: C <- exp(D) C + sum_j exp(D - d_j) k_j v_j^T, n likewise,
    // one dk tile at a time (k is read again, weighted)
    const float eD = expf(ds[L - 1]);
    for (int k0 = 0; k0 < dkp; k0 += kTk) {
      __syncthreads();  // the previous readers of ks are done
      for (int idx = tid; idx < L * kTk; idx += kThreads) {
        const int j = idx / kTk, kk = idx % kTk;
        ks[j * kTkPad + kk] = j < nvalid && k0 + kk < dk
            ? k_bh[(int64_t)(t0 + j) * dk + k0 + kk] * wts[j] : 0.0f;
      }
      __syncthreads();
      float acc[kTk / 16][4];
#pragma unroll
      for (int a = 0; a < kTk / 16; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = 0.0f;
      for (int j = 0; j < L; ++j) {
        float vv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) vv[c] = vs[j * kDvBlock + tj + 16 * c];
#pragma unroll
        for (int a = 0; a < kTk / 16; ++a) {
          const float kw = ks[j * kTkPad + ti + 16 * a];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(kw, vv[c], acc[a][c]);
        }
      }
#pragma unroll
      for (int a = 0; a < kTk / 16; ++a) {
        float* crow = Cs + (size_t)(k0 + ti + 16 * a) * kDvBlock + tj;
#pragma unroll
        for (int c = 0; c < 4; ++c) crow[16 * c] = eD * crow[16 * c] + acc[a][c];
      }
      if (tid < kTk) {
        float kn = 0.0f;
        for (int j = 0; j < L; ++j) kn += ks[j * kTkPad + tid];
        ns[k0 + tid] = eD * ns[k0 + tid] + kn;
      }
    }
  }
  __syncthreads();

  if (c_out != nullptr) {
    float* c_bh = c_out + (int64_t)bh * dk * dv;
    for (int idx = tid; idx < dk * kDvBlock; idx += kThreads) {
      const int row = idx / kDvBlock, col = idx % kDvBlock;
      if (v0 + col < dv) c_bh[(int64_t)row * dv + v0 + col] = Cs[idx];
    }
  }
  if (n_out != nullptr && blockIdx.y == 0)
    for (int idx = tid; idx < dk; idx += kThreads)
      n_out[(int64_t)bh * dk + idx] = ns[idx];
}

template <int L>
int launch(const float* q, const float* k, const float* v, const float* lf,
           float* h, float* c, float* n, int bh, int seq, int dk, int dv,
           int normalize, cudaStream_t stream) {
  const size_t smem = smem_floats(L, dk) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)bh, (unsigned)((dv + kDvBlock - 1) / kDvBlock));
  mlstm_kernel<L><<<grid, kThreads, smem, stream>>>(q, k, v, lf, h, c, n, seq,
                                                    dk, dv, normalize);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.
//
// mlstm_scan_f32: q, k contiguous (bh, seq, dk), v (bh, seq, dv), lf
// (bh, seq), h out (bh, seq, dv); c out (bh, dk, dv) and n out (bh, dk),
// each may be null (not written). All f32 on the device of `stream`;
// chunk is 16, 32, 64 or 128. Returns cudaGetLastError() after the launch.
extern "C" int mlstm_scan_f32(const void* q, const void* k, const void* v,
                              const void* lf, void* h, void* c, void* n,
                              int bh, int seq, int dk, int dv, int chunk,
                              int normalize, void* stream) {
  if (bh < 1 || seq < 1 || dk < 1 || dv < 1) return (int)cudaErrorInvalidValue;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* lff = static_cast<const float*>(lf);
  auto* hf = static_cast<float*>(h);
  auto* cf = static_cast<float*>(c);
  auto* nf = static_cast<float*>(n);
  auto st = static_cast<cudaStream_t>(stream);
  switch (chunk) {
    case 16: return launch<16>(qf, kf, vf, lff, hf, cf, nf, bh, seq, dk, dv, normalize, st);
    case 32: return launch<32>(qf, kf, vf, lff, hf, cf, nf, bh, seq, dk, dv, normalize, st);
    case 64: return launch<64>(qf, kf, vf, lff, hf, cf, nf, bh, seq, dk, dv, normalize, st);
    case 128: return launch<128>(qf, kf, vf, lff, hf, cf, nf, bh, seq, dk, dv, normalize, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
