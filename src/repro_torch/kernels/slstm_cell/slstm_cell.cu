// Stabilized sLSTM recurrence (Beck et al.) over a whole sequence.
//
// Replaces the TPU kernel src/repro/kernels/slstm_cell/slstm_cell.py:73
// (slstm_cell_pallas, its pl.pallas_call and _kernel body), which pins
// the recurrent weights r_h in VMEM and steps the recurrence over a
// sequential chunk axis. Its chunk axis and zero padding are a VMEM
// tiling detail and are not carried over: here one block walks the
// whole sequence of one (b, h) pair.
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
// Design: one block per (b, h) with 4*hd threads (hd <= 256, so at most
// 1024). h_prev lives in shared memory. Thread j computes column j of
// rec (loads of r_h coalesced across j), adds pre[t, j] and stores the
// gate pre-activation in shared memory; after a barrier, threads j < hd
// do the gate math for column j with the state in registers and write
// h_t. No fast math: tanhf, expf, log1pf are the accurate library
// functions. The step loop is a noinline function: inlined into the
// kernel beside the state loads and stores, the same loop compiled to
// slower steps (chip_smoke.py phase 14 at (8, 4, 512, 256) on an
// "NVIDIA H100 80GB HBM3" at 700.00 W: 9.26 ms a launch inlined,
// 6.37-6.52 ms as a call).
//
// Bound: operations. A call does B*H*S*2*hd*4hd f32 FLOPs in the
// recurrent products (at B=64, H=4, S=64, hd=256: 8.6 GFLOP, 128 us at
// 67 TFLOP/s) against 88 MB of HBM traffic (26 us at 3.35 TB/s). This
// simple kernel re-reads r_h (1 MiB at hd=256) from L2 at every step in
// every (b, h) block, 17 GB in such a call, and runs well above that
// bound (PERF.md). Later designs: batch rows of one head share each
// step's r_h; r_h held resident across a thread-block cluster's
// distributed shared memory; tensor cores for the products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxHd = 256;  // 4*hd threads per block, at most 1024

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

// State (c, n, m, h), each (batch * n_heads, hd) f32: s0 is read when
// not null, else the zero state; s1 is written when not null.
struct State {
  const float* c0;
  const float* n0;
  const float* m0;
  const float* h0;
  float* c1;
  float* n1;
  float* m1;
  float* h1;
};

// The step loop, a compiled function of its own (noinline); c, n, m come
// in and go out through cnm.
template <typename T>
__device__ __noinline__ void run_steps(const T* __restrict__ pre,
                                       const T* __restrict__ r_h,
                                       T* __restrict__ o_bh, float* h_prev,
                                       float* gates, int seq, int hd,
                                       float* cnm) {
  const int j = threadIdx.x;
  const int four_hd = 4 * hd;
  float c = cnm[0], n = cnm[1], m = cnm[2];
  for (int t = 0; t < seq; ++t) {
    const float p = to_f32(pre[(int64_t)t * four_hd + j]);
    float acc = 0.0f;
    const T* col = r_h + j;
#pragma unroll 8
    for (int i = 0; i < hd; ++i)
      acc = fmaf(h_prev[i], to_f32(col[(int64_t)i * four_hd]), acc);
    gates[j] = p + acc;
    __syncthreads();  // gates complete; every read of h_prev done
    if (j < hd) {
      const float z = tanhf(gates[j]);
      const float log_i = gates[hd + j];
      const float log_f = log_sigmoid(gates[2 * hd + j]);
      const float o = 1.0f / (1.0f + expf(-gates[3 * hd + j]));
      const float m_new = fmaxf(log_f + m, log_i);
      const float i_g = expf(log_i - m_new);
      const float f_g = expf(log_f + m - m_new);
      c = f_g * c + i_g * z;
      n = f_g * n + i_g;
      m = m_new;
      const float h = o * c / fmaxf(fabsf(n), 1.0f);
      h_prev[j] = h;
      store(o_bh + (int64_t)t * hd + j, h);
    }
    __syncthreads();  // h_t visible before the next step's products
  }
  cnm[0] = c;
  cnm[1] = n;
  cnm[2] = m;
}

// __launch_bounds__ holds the kernel to 64 registers a thread, so that a
// block of 1024 threads (hd = 256) fits an SM's register file.
template <typename T>
__global__ void __launch_bounds__(4 * kMaxHd)
    slstm_kernel(const T* __restrict__ pre_x, const T* __restrict__ r,
                 T* __restrict__ out, int n_heads, int seq, int hd,
                 State st) {
  extern __shared__ float smem[];
  float* h_prev = smem;       // (hd,)
  float* gates = smem + hd;   // (4hd,) pre + rec, gate-major
  const int bh = blockIdx.x;  // b * n_heads + h
  const int head = bh % n_heads;
  const int j = threadIdx.x;  // column of rec, 0 .. 4hd-1
  const int four_hd = 4 * hd;
  float cnm[3] = {0.0f, 0.0f, -1e30f};
  if (j < hd) {
    h_prev[j] = 0.0f;
    if (st.c0 != nullptr) {
      const int64_t sj = (int64_t)bh * hd + j;
      cnm[0] = st.c0[sj];
      cnm[1] = st.n0[sj];
      cnm[2] = st.m0[sj];
      h_prev[j] = st.h0[sj];
    }
  }
  __syncthreads();
  run_steps<T>(pre_x + (int64_t)bh * seq * four_hd,
               r + (int64_t)head * hd * four_hd, out + (int64_t)bh * seq * hd,
               h_prev, gates, seq, hd, cnm);
  if (st.c1 != nullptr && j < hd) {
    const int64_t sj = (int64_t)bh * hd + j;
    st.c1[sj] = cnm[0];
    st.n1[sj] = cnm[1];
    st.m1[sj] = cnm[2];
    st.h1[sj] = h_prev[j];
  }
}

template <typename T>
int launch(const void* pre_x, const void* r, void* out, int batch,
           int n_heads, int seq, int hd, State st, void* stream) {
  if (hd < 1 || hd > kMaxHd || batch < 1 || n_heads < 1 || seq < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)5 * hd * sizeof(float);
  slstm_kernel<T><<<(unsigned)(batch * n_heads), 4 * hd, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pre_x), static_cast<const T*>(r),
      static_cast<T*>(out), n_heads, seq, hd, st);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes. pre_x is a contiguous
// (batch, n_heads, seq, 4, hd) array, r a contiguous (n_heads, hd, 4*hd)
// array and out a contiguous (batch, n_heads, seq, hd) array, all of the
// named dtype and on the device of `stream`; 1 <= hd <= 256. c0, n0, m0,
// h0 are the initial state and c1, n1, m1, h1 the final state, each a
// contiguous (batch, n_heads, hd) f32 array: c0 .. h0 all null (the zero
// state) or none, and likewise c1 .. h1 (not written). Returns
// cudaGetLastError() after the launch.
#define STATE_ARGS                                                        \
  const float *c0, const float *n0, const float *m0, const float *h0,    \
      float *c1, float *n1, float *m1, float *h1

extern "C" int slstm_cell_f32(const void* pre_x, const void* r, void* out,
                              STATE_ARGS, int batch, int n_heads, int seq,
                              int hd, void* stream) {
  return launch<float>(pre_x, r, out, batch, n_heads, seq, hd,
                       State{c0, n0, m0, h0, c1, n1, m1, h1}, stream);
}

extern "C" int slstm_cell_bf16(const void* pre_x, const void* r, void* out,
                               STATE_ARGS, int batch, int n_heads, int seq,
                               int hd, void* stream) {
  return launch<__nv_bfloat16>(pre_x, r, out, batch, n_heads, seq, hd,
                               State{c0, n0, m0, h0, c1, n1, m1, h1}, stream);
}
