// Backward of flash attention (flash_attention.cu), FlashAttention-2
// style: dq, dk and dv from dout, the forward's output and its row
// log-sum-exp, with the probabilities recomputed tile by tile.
//
// Replaces no TPU kernel: the reference differentiates the XLA form of
// its encoder's attention (jax.grad through the einsum softmax,
// src/repro/core/encoders.py:76-78) and has no Pallas backward. It was
// added so that the federated trainer's transformer encoders carry their
// gradients through kernels on the card.
//
// With s = (q . k) * scale (scale = 1 / sqrtf(d) in f32, as the forward
// multiplies), p = exp(s - lse) on the visible keys, D = rowsum(dout o out):
//   dv = p^T dout;  dp = dout v^T;  ds = p (dp - D);
//   dq = scale * ds k;  dk = scale * ds^T q.
// Two kernels, no atomics, deterministic:
//   dq_kernel:   a block a (batch, head, 64 query rows): D for its rows
//                (written for dkv_kernel), then a loop over 64-key tiles;
//   dkv_kernel:  a block a (batch, head, 64 keys): a loop over 64-row
//                query tiles, dk and dv in registers.
// Scope: f32, as many K/V heads as query heads, no window; causal masks
// with queries end-aligned to the keys as the forward's. The head dim is a
// multiple of 4 (16-byte loads), at most 256.
//
// Bound: at the transformer encoder's training shape (C*B = 1024, H = 4,
// S = 64, d = 256) the five products are 2 * 5 * S^2 * d a (batch, head):
// 43 GFLOP, 0.64 ms at 67 TFLOP/s of f32 SIMT; the call reads q, k, v,
// out, dout and lse and writes dq, dk, dv: 2.1 GB, 0.64 ms at 3.35 TB/s.
//
// Design: SIMT f32 FMAs, register-blocked so that each 16-byte
// shared-memory load feeds 8 FMAs or more (a thread with 1 x 4 entries of
// a 32 x 32 tile would feed 3.2, and shared memory, not the FMAs, would
// set the pace). A 64 x 64 score tile (s and dp together) gives each of the
// 256 threads 4 query rows x 4 keys; the d axis is staged in 32-column
// chunks, transposed ([column][row], rows padded to 68) so that one
// float4 holds a thread's 4 rows or 4 keys: 4 loads feed 32 FMAs. The
// output products take one float4 of ds (or p) and d/64 float4s of the
// operand's row per step: 4 rows (or keys) x d/16 columns a thread in
// registers, 16 FMAs a load at d = 256. Both kernels form s and dp (7
// products of S^2 d in all, against the 5 the bound counts). Shared
// memory at d = 256: dq_kernel 119 KB (K's full tile, four chunks, ds),
// dkv_kernel 203 KB (q's and dout's full tiles, four chunks, p, ds); one
// block an SM.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // query rows and keys a tile
constexpr int kChunk = 32;     // columns of d a staged chunk
constexpr int kThreads = 256;
constexpr int kMaxD = 256;
constexpr int kLdt = kTile + 4;  // row stride of chunks and score tiles

template <int KD>
struct Smem {
  static constexpr int ld = KD + 4;  // row stride of a full operand tile
  static constexpr int full = kTile * ld;
  static constexpr int chunk = kChunk * kLdt;
  static constexpr int score = kTile * kLdt;
  // dq_kernel: one full tile (k), four chunks, one score tile
  static constexpr size_t dq_bytes =
      sizeof(float) * ((size_t)full + 4 * chunk + score + 2 * kTile);
  // dkv_kernel: two full tiles (q, dout), four chunks, two score tiles
  static constexpr size_t dkv_bytes =
      sizeof(float) * ((size_t)2 * full + 4 * chunk + 2 * score + 2 * kTile);
};

// Rows [0, 64) of a row-major (rows, d) array (`valid` of them real) into
// a full tile of stride ld, zeros past `valid`. d is a multiple of 4.
__device__ __forceinline__ void load_full(float* dst, int ld, const float* src,
                                          int valid, int d) {
  const int chunks = d / 4;
  for (int e = threadIdx.x; e < kTile * chunks; e += kThreads) {
    const int r = e / chunks, c = 4 * (e - r * chunks);
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < valid)
      v = __ldg(reinterpret_cast<const float4*>(src + (int64_t)r * d + c));
    *reinterpret_cast<float4*>(dst + r * ld + c) = v;
  }
}

// Columns [x0, x0 + 32) of rows [0, 64) of a row-major (rows, d) array,
// transposed into a chunk: dst[x * kLdt + r]; zeros past `valid` rows or
// past d.
__device__ __forceinline__ void load_chunk(float* dst, const float* src,
                                           int valid, int d, int x0) {
  for (int e = threadIdx.x; e < kTile * (kChunk / 4); e += kThreads) {
    const int r = e % kTile, x = 4 * (e / kTile);
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < valid && x0 + x < d)
      v = __ldg(reinterpret_cast<const float4*>(src + (int64_t)r * d + x0 +
                                                x));
    dst[(x + 0) * kLdt + r] = v.x;
    dst[(x + 1) * kLdt + r] = v.y;
    dst[(x + 2) * kLdt + r] = v.z;
    dst[(x + 3) * kLdt + r] = v.w;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float get(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// s[i][j] += sum over the chunk's 32 columns of a[row 4tq+i] b[key 4tk+j],
// and t likewise for c and e: four chunks [x][row] of one stage.
__device__ __forceinline__ void chunk_scores(float (&s)[4][4],
                                             float (&t)[4][4], const float* a,
                                             const float* b, const float* c,
                                             const float* e, int tq, int tk) {
#pragma unroll 4
  for (int x = 0; x < kChunk; ++x) {
    const float4 av = ld4(a + x * kLdt + 4 * tq);
    const float4 bv = ld4(b + x * kLdt + 4 * tk);
    const float4 cv = ld4(c + x * kLdt + 4 * tq);
    const float4 ev = ld4(e + x * kLdt + 4 * tk);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(get(av, i), get(bv, j), s[i][j]);
        t[i][j] = fmaf(get(cv, i), get(ev, j), t[i][j]);
      }
  }
}

// s and dp over all of d for this thread's 4 x 4 entries: query rows
// q (64 of them, `qv` real, global row stride d) against keys k and v
// (`kv` real), staged chunk by chunk into qt, dot, kt, vt.
__device__ __forceinline__ void tile_scores(float (&s)[4][4],
                                            float (&dp)[4][4], const float* q,
                                            const float* dout,
                                            const float* k, const float* v,
                                            int qv, int kv, int d, float* qt,
                                            float* dot, float* kt, float* vt,
                                            int tq, int tk) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
  for (int x0 = 0; x0 < d; x0 += kChunk) {
    __syncthreads();  // the previous chunk's readers are done
    load_chunk(qt, q, qv, d, x0);
    load_chunk(dot, dout, qv, d, x0);
    load_chunk(kt, k, kv, d, x0);
    load_chunk(vt, v, kv, d, x0);
    __syncthreads();
    chunk_scores(s, dp, qt, kt, dot, vt, tq, tk);
  }
}

// p = exp(s * scale - lse) where the key is visible, else 0, and
// ds = p (dp - D), in place: row 4tq+i is query position q0 + 4tq + i
// among the keys (causal: visible while key <= position), key k0 + 4tk + j.
__device__ __forceinline__ void probs(float (&s)[4][4], float (&dp)[4][4],
                                      const float* lse_s, const float* dd_s,
                                      int tq, int tk, int qpos0, int qv,
                                      int k0, int sk, int causal,
                                      float scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * tq + i;
    const float lse = lse_s[r], dd = dd_s[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + 4 * tk + j;
      const bool vis = r < qv && key < sk && (!causal || key <= qpos0 + r) &&
                       lse != -CUDART_INF_F;
      const float p = vis ? expf(s[i][j] * scale - lse) : 0.0f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - dd);
    }
  }
}

// acc[i][u] (row 4tr+i, columns 4tc + 64u .. + 3) += sum over the tile's
// 64 entries n of w[n][4tr+i] * m[n][columns]: w a score tile read as
// [n][row] (stride kLdt), m a full tile (stride ld).
template <int KD>
__device__ __forceinline__ void tile_product(float4 (&acc)[4][KD / 64],
                                             const float* w, const float* m,
                                             int tr, int tc, int d) {
  constexpr int U = KD / 64;  // float4 columns a thread, 64 apart
  constexpr int ld = Smem<KD>::ld;
#pragma unroll 4
  for (int n = 0; n < kTile; ++n) {
    const float4 wv = ld4(w + n * kLdt + 4 * tr);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = 4 * tc + 64 * u;
      if (c < d) {
        const float4 mv = ld4(m + n * ld + c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float wi = get(wv, i);
          acc[i][u].x = fmaf(wi, mv.x, acc[i][u].x);
          acc[i][u].y = fmaf(wi, mv.y, acc[i][u].y);
          acc[i][u].z = fmaf(wi, mv.z, acc[i][u].z);
          acc[i][u].w = fmaf(wi, mv.w, acc[i][u].w);
        }
      }
    }
  }
}

template <int KD>
__device__ __forceinline__ void store_tile(float* dst,
                                           const float4 (&acc)[4][KD / 64],
                                           float scale, int tr, int tc,
                                           int valid, int d) {
  constexpr int U = KD / 64;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * tr + i;
    if (r >= valid) continue;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = 4 * tc + 64 * u;
      if (c < d)
        *reinterpret_cast<float4*>(dst + (int64_t)r * d + c) =
            make_float4(acc[i][u].x * scale, acc[i][u].y * scale,
                        acc[i][u].z * scale, acc[i][u].w * scale);
    }
  }
}

template <int KD>
__device__ __forceinline__ void zero_acc(float4 (&acc)[4][KD / 64]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < KD / 64; ++u)
      acc[i][u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

template <int KD>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ out,
              const float* __restrict__ dout, const float* __restrict__ lse,
              float* __restrict__ dd_out, float* __restrict__ dq, int sq,
              int sk, int d, int causal, float scale) {
  using S = Smem<KD>;
  extern __shared__ __align__(16) float smem[];
  float* kf = smem;                 // (64, ld): the key tile, row-major
  float* qt = kf + S::full;         // chunks (32, kLdt), transposed
  float* dot = qt + S::chunk;
  float* kt = dot + S::chunk;
  float* vt = kt + S::chunk;
  float* dst = vt + S::chunk;       // (64 keys, kLdt queries): ds^T
  float* lse_s = dst + S::score;
  float* dd_s = lse_s + kTile;

  const int64_t bh = blockIdx.x;
  const int m0 = blockIdx.y * kTile;
  const int qv = min(kTile, sq - m0);
  const int64_t qoff = (bh * sq + m0) * d;
  const float* kp = k + bh * sk * d;
  const float* vp = v + bh * sk * d;
  const int tid = threadIdx.x;
  // D = rowsum(dout o out): 4 lanes a row, summed by shuffles
  {
    const int row = tid / 4, lane4 = tid % 4;
    float acc = 0.0f;
    if (row < qv)
      for (int c = lane4; c < d; c += 4)
        acc = fmaf(dout[qoff + (int64_t)row * d + c],
                   out[qoff + (int64_t)row * d + c], acc);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (lane4 == 0) {
      dd_s[row] = acc;
      lse_s[row] = row < qv ? lse[bh * sq + m0 + row] : -CUDART_INF_F;
      if (row < qv) dd_out[bh * sq + m0 + row] = acc;
    }
  }
  const int tq = tid / 16, tk = tid % 16;  // score tile: 4 rows x 4 keys
  const int off = sk - sq;  // query position p sits at key position p + off
  const int k_hi = causal ? min(sk, m0 + qv - 1 + off + 1) : sk;

  float4 acc[4][KD / 64];
  zero_acc<KD>(acc);
  for (int k0 = 0; k0 < k_hi; k0 += kTile) {
    const int kv = min(kTile, sk - k0);
    float s[4][4], dp[4][4];
    tile_scores(s, dp, q + qoff, dout + qoff, kp + (int64_t)k0 * d,
                vp + (int64_t)k0 * d, qv, kv, d, qt, dot, kt, vt, tq, tk);
    load_full(kf, S::ld, kp + (int64_t)k0 * d, kv, d);
    probs(s, dp, lse_s, dd_s, tq, tk, m0 + off, qv, k0, sk, causal, scale);
#pragma unroll
    for (int j = 0; j < 4; ++j)  // ds^T: key 4tk+j, query rows 4tq..4tq+3
      *reinterpret_cast<float4*>(dst + (4 * tk + j) * kLdt + 4 * tq) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    __syncthreads();  // ds^T and the key tile are in place
    tile_product<KD>(acc, dst, kf, tq, tk, d);  // dq[row] += ds[row, n] k[n]
  }
  store_tile<KD>(dq + qoff, acc, scale, tq, tk, qv, d);
}

template <int KD>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ dd,
               float* __restrict__ dk, float* __restrict__ dv, int sq, int sk,
               int d, int causal, float scale) {
  using S = Smem<KD>;
  extern __shared__ __align__(16) float smem[];
  float* qf = smem;                 // (64, ld): the query tile, row-major
  float* dof = qf + S::full;        // (64, ld): dout's
  float* qt = dof + S::full;        // chunks (32, kLdt), transposed
  float* dot = qt + S::chunk;
  float* kt = dot + S::chunk;
  float* vt = kt + S::chunk;
  float* p_s = vt + S::chunk;       // (64 queries, kLdt keys): p
  float* ds_s = p_s + S::score;     // ds
  float* lse_s = ds_s + S::score;
  float* dd_s = lse_s + kTile;

  const int64_t bh = blockIdx.x;
  const int n0 = blockIdx.y * kTile;
  const int kv = min(kTile, sk - n0);
  const int64_t koff = (bh * sk + n0) * d;
  const int tid = threadIdx.x;
  const int tq = tid / 16, tk = tid % 16;
  const int off = sk - sq;
  // causal: the query tiles whose last position reaches key n0
  const int m_lo = causal ? max(0, n0 - off) / kTile * kTile : 0;

  float4 acc_k[4][KD / 64], acc_v[4][KD / 64];
  zero_acc<KD>(acc_k);
  zero_acc<KD>(acc_v);
  for (int m0 = m_lo; m0 < sq; m0 += kTile) {
    const int qv = min(kTile, sq - m0);
    const int64_t qoff = (bh * sq + m0) * d;
    float s[4][4], dp[4][4];
    __syncthreads();  // the previous tile's products are done
    if (tid < kTile) {
      lse_s[tid] = tid < qv ? lse[bh * sq + m0 + tid] : -CUDART_INF_F;
      dd_s[tid] = tid < qv ? dd[bh * sq + m0 + tid] : 0.0f;
    }
    load_full(qf, S::ld, q + qoff, qv, d);
    load_full(dof, S::ld, dout + qoff, qv, d);
    tile_scores(s, dp, q + qoff, dout + qoff, k + koff, v + koff, qv, kv, d,
                qt, dot, kt, vt, tq, tk);
    probs(s, dp, lse_s, dd_s, tq, tk, m0 + off, qv, n0, sk, causal, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // query row 4tq+i, keys 4tk..4tk+3
      *reinterpret_cast<float4*>(p_s + (4 * tq + i) * kLdt + 4 * tk) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
      *reinterpret_cast<float4*>(ds_s + (4 * tq + i) * kLdt + 4 * tk) =
          make_float4(dp[i][0], dp[i][1], dp[i][2], dp[i][3]);
    }
    __syncthreads();  // p, ds and the full tiles are in place
    // dv[key] += p[n, key] dout[n]; dk[key] += ds[n, key] q[n]
    tile_product<KD>(acc_v, p_s, dof, tq, tk, d);
    tile_product<KD>(acc_k, ds_s, qf, tq, tk, d);
  }
  store_tile<KD>(dv + koff, acc_v, 1.0f, tq, tk, kv, d);
  store_tile<KD>(dk + koff, acc_k, scale, tq, tk, kv, d);
}

template <int KD>
int launch_kd(const float* q, const float* k, const float* v,
              const float* out, const float* dout, const float* lse,
              float* dd, float* dq, float* dk, float* dv, int bh, int sq,
              int sk, int d, int causal, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)d);
  int err = (int)cudaFuncSetAttribute(
      dq_kernel<KD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Smem<KD>::dq_bytes);
  if (err != 0) return err;
  err = (int)cudaFuncSetAttribute(
      dkv_kernel<KD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Smem<KD>::dkv_bytes);
  if (err != 0) return err;
  dq_kernel<KD><<<dim3((unsigned)bh, (unsigned)((sq + kTile - 1) / kTile)),
                  kThreads, Smem<KD>::dq_bytes, stream>>>(
      q, k, v, out, dout, lse, dd, dq, sq, sk, d, causal, scale);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  dkv_kernel<KD><<<dim3((unsigned)bh, (unsigned)((sk + kTile - 1) / kTile)),
                   kThreads, Smem<KD>::dkv_bytes, stream>>>(
      q, k, v, dout, lse, dd, dk, dv, sq, sk, d, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. q, out, dout, dq (bh, sq, d); k, v, dk,
// dv (bh, sk, d); lse and the scratch dd (bh, sq); all contiguous f32 on
// the device of `stream`, 16-byte aligned; bh = batch * heads (one K/V
// head a query head); 4 <= d <= 256, d % 4 == 0; sq, sk >= 1, ceil(sq /
// 64) and ceil(sk / 64) at most 65535. Launches dq_kernel, then
// dkv_kernel (which reads the dd the first wrote). Returns the first CUDA
// error of the set-up and the two launches.
extern "C" int flash_attention_bwd_f32(const float* q, const float* k,
                                       const float* v, const float* out,
                                       const float* dout, const float* lse,
                                       float* dd, float* dq, float* dk,
                                       float* dv, int bh, int sq, int sk,
                                       int d, int causal, void* stream) {
  if (bh < 1 || sq < 1 || sk < 1 || d < 4 || d > kMaxD || d % 4 != 0 ||
      (sq + kTile - 1) / kTile > 65535 || (sk + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return launch_kd<64>(q, k, v, out, dout, lse, dd, dq, dk, dv, bh, sq, sk,
                         d, causal, s);
  if (d <= 128)
    return launch_kd<128>(q, k, v, out, dout, lse, dd, dq, dk, dv, bh, sq, sk,
                          d, causal, s);
  return launch_kd<256>(q, k, v, out, dout, lse, dd, dq, dk, dv, bh, sq, sk,
                        d, causal, s);
}
