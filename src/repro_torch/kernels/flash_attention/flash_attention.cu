// Flash attention: softmax(q k^T / sqrt(d)) v with an online softmax,
// grouped-query heads, causal and sliding-window masks, and queries
// end-aligned to the keys (query row r sits at key position
// r + sk - sq).
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py:82
// (flash_attention_pallas, its pl.pallas_call and _kernel body), which
// walks key tiles along a sequential grid axis with the running
// statistics (m, l, acc) in VMEM scratch. Here a loop over key tiles
// inside the block takes the place of that axis.
//
// Semantics kept from the TPU kernel: K/V head = q head / (hq / hkv),
// never repeated in memory; key rows past sk read as zero; m, l and acc
// are f32; a row whose visible keys so far are none keeps m = -inf, and
// exp is taken against safe_m = 0 there, with alpha = 0; the output is
// acc / max(l, 1e-30), so a row with no visible key at all (causal with
// sq > sk) is exactly 0. Scores are (q . k) * (1 / sqrt(d)) in f32.
//
// Design: one block per (b * hq + head, tile of kRows query rows), one
// warp per query row. Each key tile of kKeys = 32 rows of K and V is
// staged in shared memory as f32 (K rows padded to d + 1 floats, so that
// the 32 lanes, one key each, read different banks). Lane j computes the
// score of key j against the warp's query row (held in shared memory),
// the warp reduces max and sum with shuffles, and each lane accumulates
// the output columns lane, lane + 32, ... (d <= 256, so at most 8 a
// lane) from the shuffled probabilities. Key tiles that no row of the
// block can see (past the causal limit, before the window) are skipped;
// a skipped tile would leave m, l and acc exactly as they were. SIMT FMA
// throughout; mma.sync or wgmma tiles are later work.
//
// Bound: at the serving shapes (B=64, H=4, S=64, d=256, f32) HBM bytes:
// 67 MB of q, k, v and out (20 us at 3.35 TB/s) against 1.07 GFLOP of
// products (16 us at 67 TFLOP/s f32). This kernel re-reads K and V from
// L2 once per block of 8 query rows and its products run from shared
// memory, so it stays well above that bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;     // query rows a block, one warp each
constexpr int kKeys = 32;    // keys a tile, one per lane
constexpr int kMaxD = 256;
constexpr int kCols = kMaxD / 32;  // output columns a lane, at most
constexpr int kThreads = kRows * 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

size_t smem_bytes(int d) {
  return (size_t)(kKeys * (d + 1) + kKeys * d + kRows * d) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int hq,
                 int hkv, int sq, int sk, int d, int causal, int window,
                 float scale) {
  extern __shared__ float smem[];
  const int kstride = d + 1;
  float* k_s = smem;                   // (kKeys, d + 1)
  float* v_s = k_s + kKeys * kstride;  // (kKeys, d)
  float* q_s = v_s + kKeys * d;        // (kRows, d)

  const int bh = blockIdx.x;  // b * hq + head
  const int b = bh / hq;
  const int kvh = (bh % hq) / (hq / hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.y * kRows;
  const int row = row0 + warp;
  const bool live = row < sq;  // uniform across the warp
  const int off = sk - sq;     // query row r sits at key position r + off
  const int qi = row + off;

  const T* qp = q + ((int64_t)bh * sq + row0) * d;
  const T* kp = k + (int64_t)(b * hkv + kvh) * sk * d;
  const T* vp = v + (int64_t)(b * hkv + kvh) * sk * d;
  const int rows_here = min(kRows, sq - row0);
  for (int e = threadIdx.x; e < kRows * d; e += kThreads)
    q_s[e] = e < rows_here * d ? to_f32(qp[e]) : 0.0f;

  // the keys any row of this block can see: [k_lo, k_hi)
  const int qi_first = row0 + off;
  const int qi_last = row0 + rows_here - 1 + off;
  int k_hi = causal ? min(sk, qi_last + 1) : sk;
  int k_lo = window > 0 ? max(0, qi_first - window + 1) : 0;
  k_lo = (k_lo / kKeys) * kKeys;

  float m = -CUDART_INF_F, l = 0.0f;
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;

  for (int kb = k_lo; kb < k_hi; kb += kKeys) {
    __syncthreads();  // the previous tile is consumed, q_s is staged
    for (int e = threadIdx.x; e < kKeys * d; e += kThreads) {
      const int kk = e / d;
      const int c = e - kk * d;
      const int key = kb + kk;
      const bool in = key < sk;  // rows past sk read as zero
      k_s[kk * kstride + c] = in ? to_f32(kp[(int64_t)key * d + c]) : 0.0f;
      v_s[kk * d + c] = in ? to_f32(vp[(int64_t)key * d + c]) : 0.0f;
    }
    __syncthreads();
    if (!live) continue;

    const int key = kb + lane;
    const float* qr = q_s + warp * d;
    const float* kr = k_s + lane * kstride;
    float s = 0.0f;
    for (int c = 0; c < d; ++c) s = fmaf(qr[c], kr[c], s);
    s *= scale;
    bool vis = key < sk;
    if (causal) vis = vis && key <= qi;
    if (window > 0) vis = vis && key > qi - window;

    const float m_new = fmaxf(m, warp_max(vis ? s : -CUDART_INF_F));
    const float safe_m = isfinite(m_new) ? m_new : 0.0f;
    const float p = vis ? expf(s - safe_m) : 0.0f;
    const float alpha = isfinite(m) ? expf(m - safe_m) : 0.0f;
    l = alpha * l + warp_sum(p);
    m = m_new;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] *= alpha;
    for (int kk = 0; kk < kKeys; ++kk) {
      const float pk = __shfl_sync(kFull, p, kk);
      const float* vr = v_s + kk * d;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = lane + 32 * c;
        if (col < d) acc[c] = fmaf(pk, vr[col], acc[c]);
      }
    }
  }

  if (live) {
    const float denom = fmaxf(l, 1e-30f);
    T* o = out + ((int64_t)bh * sq + row) * d;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (col < d) store(o + col, acc[c] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int hq, int hkv, int sq, int sk, int d, int causal, int window,
           void* stream) {
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || sk < 0 ||
      d < 1 || d > kMaxD || window < 0)
    return (int)cudaErrorInvalidValue;
  const int q_tiles = (sq + kRows - 1) / kRows;
  if (q_tiles > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d);
  // above 48 KB (d > 165) a block's dynamic shared memory needs opting in
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.0f / sqrtf((float)d);
  flash_kernel<T><<<dim3((unsigned)(batch * hq), (unsigned)q_tiles),
                    kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, hkv, sq, sk, d,
      causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes. q is a contiguous (batch, hq, sq, d)
// array, k and v contiguous (batch, hkv, sk, d) arrays of q's dtype, out
// a contiguous (batch, hq, sq, d) array of q's dtype, all on the device
// of `stream`; hq % hkv == 0, 1 <= d <= 256, sq <= 524280. causal is 0
// or 1; window 0 means no window. Returns the first CUDA error of the
// attribute call and the launch.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, int batch,
                                   int hq, int hkv, int sq, int sk, int d,
                                   int causal, int window, void* stream) {
  return launch<float>(q, k, v, out, batch, hq, hkv, sq, sk, d, causal,
                       window, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int batch,
                                    int hq, int hkv, int sq, int sk, int d,
                                    int causal, int window, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, batch, hq, hkv, sq, sk, d,
                               causal, window, stream);
}
