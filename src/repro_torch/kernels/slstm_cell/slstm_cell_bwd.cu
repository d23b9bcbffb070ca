// Backward (BPTT) of the stabilized sLSTM recurrence of slstm_cell.cu: the
// gradient of the gate pre-activations from the gradient of the outputs.
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
// f32 FLOPs (C*B = 1024, H = 4, S = 64, hd = 256: 137 GFLOP, 2.05 ms at
// 67 TFLOP/s), against reading save, dhs and writing dpre (12 floats a
// (row, unit, step): 3.2 GB at that shape, 0.96 ms at 3.35 TB/s):
// operations bound it.
//
// Design (simple first): one block of 512 threads a (client, head, group
// of up to 32 rows); no clusters. Each step the block
//   1. computes the adjoint of its rows x hd units, up to 16 (row, unit)
//      pairs a thread with their (dc, dn, dm) in registers, writes dpre[t]
//      and keeps the rows' 4hd gate gradients in shared memory;
//   2. forms dh_rec[row, i] = sum_k rt[k, i] * dpre[row, k] for the next
//      step, 4 rows x 4 units a thread, rt streamed from L2 (1 MiB a head
//      at hd = 256, read once a step by each block of the head) in 16-byte
//      loads, the gate gradients broadcast from shared memory.
// Shared memory: rows x (4hd + 4) + rows x hd floats, 164 KB at hd = 256.
// What is left: rt is re-read every step; a cluster holding r_h in shared
// memory, as the forward does, would remove that traffic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxRows = 32;   // rows a block
constexpr int kPairs = 16;     // (row, unit) pairs a thread: 32 * 256 / 512
constexpr int kMaxHd = 256;

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

// Rows a block: at most 32, and at most kPairs * kThreads pairs.
int block_rows(int batch, int hd) {
  int rows = batch < kMaxRows ? batch : kMaxRows;
  const int cap = kPairs * kThreads / hd;
  return rows < cap ? rows : cap;
}

__global__ void __launch_bounds__(kThreads, 1)
    slstm_bwd_kernel(const float* __restrict__ save,
                     const float* __restrict__ rt,
                     const float* __restrict__ dhs, float* __restrict__ dpre,
                     int batch, int heads, int seq, int hd, int rows,
                     int groups) {
  extern __shared__ float4 smem4[];
  const int rows4 = (rows + 3) / 4;        // row lanes of the product
  const int lds = 4 * hd + 4;              // floats a row of the gate gradients
  float* da_s = reinterpret_cast<float*>(smem4);   // (4 * rows4, lds)
  float* dh_s = da_s + 4 * rows4 * lds;            // (4 * rows4, hd)

  const int vhead = blockIdx.x / groups;  // client * heads + head
  const int group = blockIdx.x - vhead * groups;
  const int client = vhead / heads;
  const int head = vhead - client * heads;
  const int b0 = group * rows;
  const int here = min(rows, batch - b0);  // rows of this block
  const int tid = threadIdx.x;
  const float* rh = rt + (int64_t)vhead * 4 * hd * hd;  // (4hd, hd)

  // the (row, unit) pairs of this thread: p = tid + q * kThreads
  float dc[kPairs], dn[kPairs], dm[kPairs];
#pragma unroll
  for (int q = 0; q < kPairs; ++q) dc[q] = dn[q] = dm[q] = 0.0f;
  const int pairs = here * hd;

  // the product's tile: units 4 * il .. + 3 of rows 4 * rl .. + 3
  const int il_n = hd / 4;
  const int il = tid % il_n, rl = tid / il_n;
  const bool prod = rl < rows4;

  for (int t = seq - 1; t >= 0; --t) {
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      const int p = tid + q * kThreads;
      if (p < pairs) {
      const int row = p / hd, unit = p - row * hd;
      const int64_t bh = ((int64_t)client * batch + b0 + row) * heads + head;
      const float* sv = save + ((bh * seq + t) * 7) * hd + unit;
      const float az = sv[0], ai = sv[hd], af = sv[2 * hd], ao = sv[3 * hd];
      const float c1 = sv[4 * hd], n1 = sv[5 * hd], m1 = sv[6 * hd];
      float c0 = 0.0f, n0 = 0.0f, m0 = -1e30f;
      if (t > 0) {
        c0 = sv[4 * hd - 7 * hd];
        n0 = sv[5 * hd - 7 * hd];
        m0 = sv[6 * hd - 7 * hd];
      }
      // the forward's step, recomputed from the saved gate sums
      const float z = tanhf(az);
      const float log_i = ai;
      const float log_f = log_sigmoid(af);
      const float o = 1.0f / (1.0f + expf(-ao));
      const float i_g = expf(log_i - m1);
      const float f_g = expf(log_f + m0 - m1);
      const float an = fabsf(n1);
      const float den = fmaxf(an, 1.0f);

      float dh = dhs[(bh * seq + t) * hd + unit];
      if (t < seq - 1) dh += dh_s[row * hd + unit];
      // h = o * c / den
      const float d_o = dh * c1 / den;
      const float dct = dc[q] + dh * o / den;
      const float dden = -dh * o * c1 / (den * den);
      const float w = an > 1.0f ? 1.0f : an == 1.0f ? 0.5f : 0.0f;
      const float sgn = n1 > 0.0f ? 1.0f : n1 < 0.0f ? -1.0f : 0.0f;
      const float dnt = dn[q] + dden * w * sgn;
      // c = f c0 + i z; n = f n0 + i
      const float df = dct * c0 + dnt * n0;
      const float di = dct * z + dnt;
      const float dz = dct * i_g;
      // i = exp(log_i - m); f = exp(log_f + m0 - m)
      float dlog_i = di * i_g;
      float dlog_f = df * f_g;
      float dm0 = df * f_g;
      const float dmt = dm[q] - di * i_g - df * f_g;
      // m = max(log_f + m0, log_i), half each way at a tie
      const float lhs = log_f + m0;
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
      const float sig_neg = 1.0f / (1.0f + expf(af));  // 1 - sigmoid(a_f)
      const float g[4] = {dz * (1.0f - z * z), dlog_i, dlog_f * sig_neg,
                          d_o * o * (1.0f - o)};
      float* dp = dpre + (bh * seq + t) * 4 * hd + unit;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        dp[k * hd] = g[k];
        da_s[row * lds + k * hd + unit] = g[k];
      }
      dc[q] = dct * f_g;
      dn[q] = dnt * f_g;
      dm[q] = dm0;
      }
    }
    if (t == 0) break;
    __syncthreads();  // every gate gradient of step t is in da_s
    if (prod) {
      float acc[4][4] = {};
      const float* ar = da_s + 4 * rl * lds;
      const float* rp = rh + 4 * il;
#pragma unroll 2
      for (int k = 0; k < 4 * hd; k += 4) {
        float4 a[4], r[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a[j] = *reinterpret_cast<const float4*>(ar + j * lds + k);
          r[j] = __ldg(reinterpret_cast<const float4*>(rp + (int64_t)(k + j) * hd));
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // row j
          const float av[4] = {a[j].x, a[j].y, a[j].z, a[j].w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            acc[j][0] = fmaf(av[kk], r[kk].x, acc[j][0]);
            acc[j][1] = fmaf(av[kk], r[kk].y, acc[j][1]);
            acc[j][2] = fmaf(av[kk], r[kk].z, acc[j][2]);
            acc[j][3] = fmaf(av[kk], r[kk].w, acc[j][3]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(dh_s + (4 * rl + j) * hd + 4 * il) =
            make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    }
    __syncthreads();  // dh_s holds step t-1's recurrent gradient
  }
}

}  // namespace

// Plain C entry point for ctypes. save (clients * batch, heads, seq, 7,
// hd), rt (clients, heads, 4 * hd, hd), dhs (clients * batch, heads, seq,
// hd) and dpre (clients * batch, heads, seq, 4, hd), all contiguous f32 on
// the device of `stream`; hd a multiple of 4, at most 256; 16-byte
// aligned pointers. Returns cudaGetLastError() after the launch, or the
// CUDA error of the set-up.
extern "C" int slstm_cell_bwd_f32(const float* save, const float* rt,
                                  const float* dhs, float* dpre, int clients,
                                  int batch, int heads, int seq, int hd,
                                  void* stream) {
  if (hd < 4 || hd > kMaxHd || hd % 4 != 0 || batch < 1 || heads < 1 ||
      clients < 1 || seq < 1)
    return (int)cudaErrorInvalidValue;
  const int rows = block_rows(batch, hd);
  const int groups = (batch + rows - 1) / rows;
  const int64_t blocks = (int64_t)clients * heads * groups;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int rows4 = (rows + 3) / 4;
  const size_t smem = sizeof(float) * (size_t)4 * rows4 * ((4 * hd + 4) + hd);
  int err = (int)cudaFuncSetAttribute(
      slstm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != 0) return err;
  slstm_bwd_kernel<<<(unsigned)blocks, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      save, rt, dhs, dpre, batch, heads, seq, hd, rows, groups);
  return (int)cudaGetLastError();
}
