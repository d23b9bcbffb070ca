// Backward of flash attention (flash_attention.cu): dq, dk and dv from
// dout, the forward's output and its row log-sum-exp, with the
// probabilities recomputed.
//
// Replaces no TPU kernel: the reference differentiates the XLA form of
// its attentions (jax.grad through the einsum softmax of
// src/repro/core/encoders.py:76-78 and of the language models'
// gqa_sdpa / chunked_gqa_sdpa, src/repro/models/attention.py:58, 82) and
// has no Pallas backward. It carries the gradients of the federated
// trainer's transformer encoders and of every language model's attention
// through kernels on the card.
//
// With s = (q . k) * scale (scale = 1 / sqrtf(d) in f32, as the forward
// multiplies), s_c = cap * tanh(s / cap) under a logit cap (s without),
// p = exp(s_c - lse) on the visible keys, D = rowsum(dout o out):
//   dv = p^T dout;  dp = dout v^T;  ds = p (dp - D) (1 - (s_c / cap)^2);
//   dq = scale * ds k;  dk = scale * ds^T q
// (the last factor of ds only under a cap); dk and dv summed over the
// query heads of a K/V head.
// Scope: f32; every form the forward takes: grouped K/V heads (Hq a
// multiple of Hkv), causal and sliding-window masks with queries
// end-aligned to the keys (Sq != Sk), the logit cap (an instance of its
// own, as the forward's). The head dim is a multiple of 4 (16-byte
// loads), at most 256 (d = 80 runs the KD = 128 instance). No atomics,
// deterministic.
//
// Bound: at the transformer encoder's training shape (C*B = 1024, H = 4,
// S = 64, d = 256) the call reads q, k, v, out, dout and lse and writes
// dq, dk, dv: 2.15 GB, 0.641 ms at 3.35 TB/s. The five products are
// 2 * 5 * S^2 * d a (batch, head), 42.9 GFLOP; run as 3xTF32 on the tensor
// cores, the fused kernel's engine, that is 129 GFLOP of TF32, 0.260 ms
// at 495 TFLOP/s. So bytes bound it. (The two SIMT kernels' f32 products
// would take 0.64 ms at 67 TFLOP/s.)
//
// Two paths, chosen by shape and group alone (kernels_a_call in
// flash_attention_bwd.py mirrors the choice):
//
// 1. Sq <= 64 and Sk <= 64 with one K/V head a query head (the encoder's
//    S = 64): fused_kernel, one block a (batch, head), one launch a call.
//    The (batch, head) is a single 64 x 64 score tile, so one block forms
//    s and dp once and
//    derives dq, dk and dv from them, each written once:
//    - phase 1: s = q k^T and dp = dout v^T over d in 16-column chunks of
//      q, k, dout and v, staged by 16-byte cp.async into a double-buffered
//      ring (rows padded to 20 floats, so that the fragment loads
//      g * 20 + t are free of bank conflicts). 8 warps: warp w takes
//      query rows 16 (w & 3) .. + 15 and keys 32 (w >> 2) .. + 31 of both
//      products, as mma.sync.m16n8k8 TF32 in the forward's 3xTF32 split
//      (x = big + small, big = rna(x), small = rna(x - big); each product
//      small*big + big*small + big*big). Each k-step's products go into a
//      zeroed fragment added to the sum in f32 (mma_3xtf32_rn): mma.sync
//      truncates what it adds into its sum, and over d = 256 with |s|,
//      |dp| near 16 the drift, carried by p and ds = p (dp - D) into every
//      output, was most of the kernel's error: 4.1e-5 against an f64
//      backward with the sums in the tensor cores, 4.3e-6 so (the plain
//      f32 backward's own 6.5e-6), for 3% more time. Phase 2's sums (over
//      64 keys) stay in the tensor cores: adding there moved the error
//      little. D = rowsum(dout o out) is formed while the first chunk lands.
//    - p = exp(s * scale - lse) and ds = p (dp - D) on the accumulator
//      fragments, masked as the plain backward masks; p^T, ds^T and ds go
//      to shared memory (rows padded to 68 floats: the A-fragment loads
//      g * 68 + t are conflict-free). A transposed fragment is read from
//      the transposed copy: tf32 has no ldmatrix.trans, and the forward's
//      register permutation carries the S fragment into an A fragment only
//      untransposed.
//    - phase 2: dv = p^T dout, dk = ds^T q and dq = ds k over d in
//      32-column chunks of dout, q and k (re-read; the block read them in
//      phase 1, so L2 serves them), staged the same way with rows padded
//      to 40 floats (B-fragment loads t * 40 + g conflict-free). Warp w
//      takes rows 16 (w & 3) .. + 15 and columns 16 (w >> 2) .. + 15 of
//      the chunk in all three products, in 3xTF32 again; each chunk of
//      dq, dk, dv is stored from the accumulators once.
//    That is the bound's 5 products, one pass over the inputs from HBM,
//    one launch. Shared memory 114,176 B: two blocks an SM.
// 2. Otherwise (longer sequences, or grouped K/V heads at any length):
//    the two SIMT kernels of the first design:
//    dq_kernel, a block a (batch, query head, 64 query rows), forms D for
//    its rows (written for dkv_kernel), then loops over the 64-key tiles
//    its rows can see (causal: none past the last row's position; window:
//    none wholly before the first row's band);
//    dkv_kernel, a block a (batch, K/V head, 64 keys), loops over the
//    64-row query tiles of each of the K/V head's G query heads in turn,
//    skipping tiles wholly outside the band, with dk and dv in registers.
//    Partial tiles are masked as the plain backward masks. Each kernel
//    forms s and dp itself (7 products of S^2 d in all, over the visible
//    tiles). SIMT f32 FMAs, register-blocked: a
//    64 x 64 score tile gives each of 256 threads 4 query rows x 4 keys;
//    the d axis is staged in 32-column chunks transposed, so that 4
//    float4 loads feed 32 FMAs; the output products take 4 rows (or keys)
//    x d/16 columns a thread, 16 FMAs a load at d = 256. Shared memory
//    at d = 256: dq_kernel 119 KB, dkv_kernel 203 KB; one block an SM.
//
// Measured (tools/torch_bwd_ablation.py and chip_smoke.py phase 22, one
// "NVIDIA H100 80GB HBM3" at 700.00 W; PERF.md has the runs): the fused
// kernel 1.37 ms a call at (1024, 4, 64, 256) (1.31-1.34 with phase 1's
// sums in the tensor cores), 2.1x its 0.641 ms bound, against 5.30-5.35
// ms of the two-kernel design timed in turns in the same runs and
// 2.38-2.40 ms of SDPA's memory-efficient backward; 0.104 ms against
// 0.346 at one client's (64, 4, 64, 256). With one TF32 product in place
// of three it takes 1.21 ms, with no product at all 1.21: staging and the
// HBM pass, not the tensor cores, set its pace. ptxas: 128 registers, no
// spills (two blocks an SM). At the language models' training shapes
// (chip_smoke.py phase 29, the same card), the two SIMT kernels: hymba's
// (2, 25 / 5, 2048, 2048, 64) with its window of 1024 3.57 ms a call
// against 4.76 ms of SDPA's memory-efficient backward on K/V repeated to
// the query heads; qwen2-vl's causal (2, 12 / 2, 1152, 1152, 128) 4.38
// ms against 0.96: dkv_kernel's 72 blocks (one a K/V head and 64 keys,
// walking 6 heads' query tiles) leave most of the 132 SMs idle.
// ptxas: dkv_kernel 127 / 169 / 237 registers at KD = 64 / 128 / 256,
// dq_kernel 115-173, no spills.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "tf32_mma.cuh"

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

// Whether query row r (at key position pos) sees `key`: in range, the
// causal mask (key <= pos), the window (key > pos - window), a finite lse.
__device__ __forceinline__ bool visible(int r, int valid, int key, int sk,
                                        int pos, int causal, int window,
                                        float lse) {
  return r < valid && key < sk && (!causal || key <= pos) &&
         (window <= 0 || key > pos - window) && lse != -CUDART_INF_F;
}

// p from a raw product x = q . k: s = x * scale, capped under CAP to
// s_c = cap * tanh(s / cap), p = exp(s_c - lse) where visible, else 0;
// ds = p (dp - D), times ds_c / ds = 1 - (s_c / cap)^2 under CAP.
template <bool CAP>
__device__ __forceinline__ void grad_score(float& x, float& dp, bool vis,
                                           float lse, float dd, float scale,
                                           float cap) {
  float sc = x * scale;
  if constexpr (CAP) sc = cap * tanhf(sc / cap);
  const float p = vis ? expf(sc - lse) : 0.0f;
  float ds = p * (dp - dd);
  if constexpr (CAP) ds *= 1.0f - (sc / cap) * (sc / cap);
  x = p;
  dp = ds;
}

// p and ds (grad_score) in place: row 4tq+i is query position
// qpos0 + 4tq + i among the keys, key k0 + 4tk + j.
template <bool CAP>
__device__ __forceinline__ void probs(float (&s)[4][4], float (&dp)[4][4],
                                      const float* lse_s, const float* dd_s,
                                      int tq, int tk, int qpos0, int qv,
                                      int k0, int sk, int causal, int window,
                                      float scale, float cap) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * tq + i;
    const float lse = lse_s[r], dd = dd_s[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + 4 * tk + j;
      const bool vis = visible(r, qv, key, sk, qpos0 + r, causal, window, lse);
      grad_score<CAP>(s[i][j], dp[i][j], vis, lse, dd, scale, cap);
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

// Grid: (batch * Hq, query tiles); the block's K/V head is its query
// head's group, bh / group.
template <int KD, bool CAP>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ out,
              const float* __restrict__ dout, const float* __restrict__ lse,
              float* __restrict__ dd_out, float* __restrict__ dq, int sq,
              int sk, int d, int group, int causal, int window, float scale,
              float cap) {
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

  const int64_t bh = blockIdx.x, bkv = bh / group;
  const int m0 = blockIdx.y * kTile;
  const int qv = min(kTile, sq - m0);
  const int64_t qoff = (bh * sq + m0) * d;
  const float* kp = k + bkv * sk * d;
  const float* vp = v + bkv * sk * d;
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
  // the key tiles any of the block's rows sees: [k_lo, k_hi)
  const int k_hi = causal ? min(sk, m0 + qv - 1 + off + 1) : sk;
  const int k_lo = window > 0 ? max(0, m0 + off - window + 1) / kTile * kTile
                              : 0;

  float4 acc[4][KD / 64];
  zero_acc<KD>(acc);
  for (int k0 = k_lo; k0 < k_hi; k0 += kTile) {
    const int kv = min(kTile, sk - k0);
    float s[4][4], dp[4][4];
    tile_scores(s, dp, q + qoff, dout + qoff, kp + (int64_t)k0 * d,
                vp + (int64_t)k0 * d, qv, kv, d, qt, dot, kt, vt, tq, tk);
    load_full(kf, S::ld, kp + (int64_t)k0 * d, kv, d);
    probs<CAP>(s, dp, lse_s, dd_s, tq, tk, m0 + off, qv, k0, sk, causal,
               window, scale, cap);
#pragma unroll
    for (int j = 0; j < 4; ++j)  // ds^T: key 4tk+j, query rows 4tq..4tq+3
      *reinterpret_cast<float4*>(dst + (4 * tk + j) * kLdt + 4 * tq) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    __syncthreads();  // ds^T and the key tile are in place
    tile_product<KD>(acc, dst, kf, tq, tk, d);  // dq[row] += ds[row, n] k[n]
  }
  store_tile<KD>(dq + qoff, acc, scale, tq, tk, qv, d);
}

// Grid: (batch * Hkv, key tiles); the block walks the query tiles of
// each of its K/V head's `group` query heads in turn, with dk and dv
// summed in registers (no atomics: the same bits on every run).
template <int KD, bool CAP>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ dd,
               float* __restrict__ dk, float* __restrict__ dv, int sq, int sk,
               int d, int group, int causal, int window, float scale,
               float cap) {
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

  const int64_t bkv = blockIdx.x;
  const int n0 = blockIdx.y * kTile;
  const int kv = min(kTile, sk - n0);
  const int64_t koff = (bkv * sk + n0) * d;
  const int tid = threadIdx.x;
  const int tq = tid / 16, tk = tid % 16;
  const int off = sk - sq;
  // the query tiles that see a key of [n0, n0 + kv): from the first whose
  // last position reaches n0 (causal) to the last whose positions p have
  // n0 + kv - 1 > p + off - window (window)
  const int m_lo = causal ? max(0, n0 - off) / kTile * kTile : 0;
  const int m_hi = window > 0 ? min(sq, n0 + kv - 1 - off + window) : sq;

  float4 acc_k[4][KD / 64], acc_v[4][KD / 64];
  zero_acc<KD>(acc_k);
  zero_acc<KD>(acc_v);
  const int tiles = m_hi > m_lo ? (m_hi - m_lo + kTile - 1) / kTile : 0;
  // step t: query head bkv * group + t / tiles, its query tile t % tiles
  for (int t = 0; t < group * tiles; ++t) {
    const int64_t bh = bkv * group + t / tiles;
    const int m0 = m_lo + (t % tiles) * kTile;
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
    probs<CAP>(s, dp, lse_s, dd_s, tq, tk, m0 + off, qv, n0, sk, causal,
               window, scale, cap);
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

// bhq = batch * Hq query heads, bhkv = batch * Hkv K/V heads.
template <int KD, bool CAP>
int launch_kd(const float* q, const float* k, const float* v,
              const float* out, const float* dout, const float* lse,
              float* dd, float* dq, float* dk, float* dv, int bhq, int bhkv,
              int sq, int sk, int d, int causal, int window, float cap,
              cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)d);
  const int group = bhq / bhkv;
  int err = (int)cudaFuncSetAttribute(
      dq_kernel<KD, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Smem<KD>::dq_bytes);
  if (err != 0) return err;
  err = (int)cudaFuncSetAttribute(
      dkv_kernel<KD, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Smem<KD>::dkv_bytes);
  if (err != 0) return err;
  dq_kernel<KD, CAP>
      <<<dim3((unsigned)bhq, (unsigned)((sq + kTile - 1) / kTile)), kThreads,
         Smem<KD>::dq_bytes, stream>>>(q, k, v, out, dout, lse, dd, dq, sq,
                                       sk, d, group, causal, window, scale,
                                       cap);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  dkv_kernel<KD, CAP>
      <<<dim3((unsigned)bhkv, (unsigned)((sk + kTile - 1) / kTile)), kThreads,
         Smem<KD>::dkv_bytes, stream>>>(q, k, v, dout, lse, dd, dk, dv, sq, sk,
                                        d, group, causal, window, scale, cap);
  return (int)cudaGetLastError();
}

template <bool CAP>
int launch_pair(const float* q, const float* k, const float* v,
                const float* out, const float* dout, const float* lse,
                float* dd, float* dq, float* dk, float* dv, int bhq,
                int bhkv, int sq, int sk, int d, int causal, int window,
                float cap, cudaStream_t stream) {
  if (d <= 64)
    return launch_kd<64, CAP>(q, k, v, out, dout, lse, dd, dq, dk, dv, bhq,
                              bhkv, sq, sk, d, causal, window, cap, stream);
  if (d <= 128)
    return launch_kd<128, CAP>(q, k, v, out, dout, lse, dd, dq, dk, dv, bhq,
                               bhkv, sq, sk, d, causal, window, cap, stream);
  return launch_kd<256, CAP>(q, k, v, out, dout, lse, dd, dq, dk, dv, bhq,
                             bhkv, sq, sk, d, causal, window, cap, stream);
}


// ----------------------------------------------- fused: Sq, Sk <= 64 --
// (the products' helpers are in tf32_mma.cuh, the copies' in cp_async.cuh)

constexpr int kFusedThreads = 256;  // 8 warps
constexpr int kChA = 16;            // columns of d a phase-1 chunk
constexpr int kLdA = kChA + 4;      // its row stride: g * 20 + t spreads banks
constexpr int kChB = 32;            // columns of d a phase-2 chunk
constexpr int kLdB = kChB + 8;      // its row stride: t * 40 + g spreads banks
constexpr int kLdS = kTile + 4;     // the score tiles': g * 68 + t

struct Fused {
  static constexpr int a_tile = kTile * kLdA;
  static constexpr int a_stage = 4 * a_tile;  // q, k, dout, v chunks
  static constexpr int b_tile = kTile * kLdB;
  static constexpr int b_stage = 3 * b_tile;  // dout, q, k chunks
  static constexpr int ring = 2 * (a_stage > b_stage ? a_stage : b_stage);
  static constexpr int score = kTile * kLdS;
  static constexpr size_t bytes =
      sizeof(float) * ((size_t)ring + 3 * score + 2 * kTile);
};

// Columns [x0, x0 + CH) of rows [0, 64) of a row-major (rows, d) array
// into a (64, ld) chunk by cp.async; zeros past `valid` rows or past d.
template <int CH>
__device__ __forceinline__ void stage_chunk(float* dst, int ld,
                                            const float* src, int valid,
                                            int d, int x0) {
  constexpr int kPieces = CH / 4;
  for (int e = threadIdx.x; e < kTile * kPieces; e += kFusedThreads) {
    const int r = e / kPieces, c = 4 * (e % kPieces);
    const bool in = r < valid && x0 + c < d;
    cp_async16(dst + r * ld + c, in ? src + (int64_t)r * d + x0 + c : src,
               in ? 16 : 0);
  }
}

// Grid: one block a (batch, head); sq, sk <= 64; one K/V head a query
// head. CAP: the logit cap's instance (grad_score).
template <bool CAP>
__global__ void __launch_bounds__(kFusedThreads, 2)
    fused_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ out,
                 const float* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ dq,
                 float* __restrict__ dk, float* __restrict__ dv, int sq,
                 int sk, int d, int causal, int window, float scale,
                 float cap) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* pt = ring + Fused::ring;   // p^T (keys, queries)
  float* dst = pt + Fused::score;   // ds^T (keys, queries)
  float* dss = dst + Fused::score;  // ds (queries, keys)
  float* lse_s = dss + Fused::score;
  float* dd_s = lse_s + kTile;

  const int64_t bh = blockIdx.x;
  const int64_t qoff = bh * sq * d, koff = bh * sk * d;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp & 3, half = warp >> 2;

  auto stage_a = [&](int c) {
    float* st = ring + (c & 1) * Fused::a_stage;
    const int x0 = c * kChA;
    stage_chunk<kChA>(st, kLdA, q + qoff, sq, d, x0);
    stage_chunk<kChA>(st + Fused::a_tile, kLdA, k + koff, sk, d, x0);
    stage_chunk<kChA>(st + 2 * Fused::a_tile, kLdA, dout + qoff, sq, d, x0);
    stage_chunk<kChA>(st + 3 * Fused::a_tile, kLdA, v + koff, sk, d, x0);
  };
  auto stage_b = [&](int c) {
    float* st = ring + (c & 1) * Fused::b_stage;
    const int x0 = c * kChB;
    stage_chunk<kChB>(st, kLdB, dout + qoff, sq, d, x0);
    stage_chunk<kChB>(st + Fused::b_tile, kLdB, q + qoff, sq, d, x0);
    stage_chunk<kChB>(st + 2 * Fused::b_tile, kLdB, k + koff, sk, d, x0);
  };
  stage_a(0);
  cp_async_commit();

  // D = rowsum(dout o out) while the first chunk lands: 4 lanes a row,
  // 16-byte loads, summed by shuffles; lse of the row (-inf past sq)
  {
    const int row = tid >> 2, l4 = tid & 3;
    float acc = 0.0f;
    if (row < sq) {
      const float* o = out + qoff + (int64_t)row * d;
      const float* g4 = dout + qoff + (int64_t)row * d;
      for (int c = 4 * l4; c < d; c += 16) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(o + c));
        const float4 b = __ldg(reinterpret_cast<const float4*>(g4 + c));
        acc = fmaf(a.x, b.x, acc);
        acc = fmaf(a.y, b.y, acc);
        acc = fmaf(a.z, b.z, acc);
        acc = fmaf(a.w, b.w, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (l4 == 0) {
      dd_s[row] = acc;
      lse_s[row] = row < sq ? lse[bh * sq + row] : -CUDART_INF_F;
    }
  }

  // phase 1: s and dp for rows 16 rg .. + 15, keys 32 half .. + 31
  float s[4][4], dp[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.0f;
  const int na = (d + kChA - 1) / kChA;
  for (int c = 0; c < na; ++c) {
    if (c + 1 < na) stage_a(c + 1);
    cp_async_commit();
    cp_async_wait<1>();  // chunk c has landed
    __syncthreads();
    const float* qs = ring + (c & 1) * Fused::a_stage;
    const float* ks = qs + Fused::a_tile;
    const float* os = ks + Fused::a_tile;
    const float* vs = os + Fused::a_tile;
#pragma unroll
    for (int kk = 0; kk < kChA; kk += 8) {
      uint32_t qb[4], qsm[4], ob[4], osm[4];
      load_a(qb, qsm, qs, kLdA, 16 * rg, kk, g, t);
      load_a(ob, osm, os, kLdA, 16 * rg, kk, g, t);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int key = 32 * half + 8 * nt + g;
        uint32_t bb[2], bs[2];
        load_b_nk(bb, bs, ks, kLdA, key, kk, t);
        mma_3xtf32_rn(s[nt], qb, qsm, bb, bs);
        load_b_nk(bb, bs, vs, kLdA, key, kk, t);
        mma_3xtf32_rn(dp[nt], ob, osm, bb, bs);
      }
    }
    __syncthreads();  // every warp is done with this slot
  }
  stage_b(0);  // the ring is free: phase 2's first chunk lands meanwhile
  cp_async_commit();

  // p and ds on the fragments: element e of s[nt] is row
  // 16 rg + g + 8 (e >> 1), key 32 half + 8 nt + 2t + (e & 1)
  const int off = sk - sq;  // query position p sits at key position p + off
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * rg + g + 8 * (e >> 1);
      const int key = 32 * half + 8 * nt + 2 * t + (e & 1);
      const float l = lse_s[r];
      const bool vis = visible(r, sq, key, sk, r + off, causal, window, l);
      grad_score<CAP>(s[nt][e], dp[nt][e], vis, l, dd_s[r], scale, cap);
      pt[key * kLdS + r] = s[nt][e];
      dst[key * kLdS + r] = dp[nt][e];
      dss[r * kLdS + key] = dp[nt][e];
    }

  // phase 2: rows 16 rg .. + 15 of dv, dk (keys) and dq (queries),
  // columns 16 half .. + 15 of each 32-column chunk
  const int nb = (d + kChB - 1) / kChB;
  for (int c = 0; c < nb; ++c) {
    if (c + 1 < nb) stage_b(c + 1);
    cp_async_commit();
    cp_async_wait<1>();  // chunk c has landed (and the score tiles are in)
    __syncthreads();
    const float* os = ring + (c & 1) * Fused::b_stage;
    const float* qs = os + Fused::b_tile;
    const float* ks = qs + Fused::b_tile;
    float acc[3][2][4];  // dv, dk, dq
#pragma unroll
    for (int m = 0; m < 3; ++m)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][nt][e] = 0.0f;
#pragma unroll 2
    for (int kb = 0; kb < kTile; kb += 8) {
      uint32_t pb[4], ps[4], tb[4], ts[4], sb[4], ss[4];
      load_a(pb, ps, pt, kLdS, 16 * rg, kb, g, t);
      load_a(tb, ts, dst, kLdS, 16 * rg, kb, g, t);
      load_a(sb, ss, dss, kLdS, 16 * rg, kb, g, t);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int n = 16 * half + 8 * nt + g;
        uint32_t bb[2], bs[2];
        load_b_kn(bb, bs, os, kLdB, kb, n, t);
        mma_3xtf32(acc[0][nt], pb, ps, bb, bs);  // dv += p^T dout
        load_b_kn(bb, bs, qs, kLdB, kb, n, t);
        mma_3xtf32(acc[1][nt], tb, ts, bb, bs);  // dk += ds^T q
        load_b_kn(bb, bs, ks, kLdB, kb, n, t);
        mma_3xtf32(acc[2][nt], sb, ss, bb, bs);  // dq += ds k
      }
    }
    // each chunk of dv, dk, dq stored once, from the accumulators
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      float* base = m == 0 ? dv + koff : m == 1 ? dk + koff : dq + qoff;
      const int valid = m == 2 ? sq : sk;
      const float f = m == 0 ? 1.0f : scale;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = c * kChB + 16 * half + 8 * nt + 2 * t;
        if (col >= d) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * rg + g + 8 * h;
          if (r < valid)
            *reinterpret_cast<float2*>(base + (int64_t)r * d + col) =
                make_float2(acc[m][nt][2 * h] * f, acc[m][nt][2 * h + 1] * f);
        }
      }
    }
    __syncthreads();  // every warp is done with this slot
  }
}

template <bool CAP>
int launch_fused(const float* q, const float* k, const float* v,
                 const float* out, const float* dout, const float* lse,
                 float* dq, float* dk, float* dv, int bh, int sq, int sk,
                 int d, int causal, int window, float cap,
                 cudaStream_t stream) {
  const int err = (int)cudaFuncSetAttribute(
      fused_kernel<CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Fused::bytes);
  if (err != 0) return err;
  fused_kernel<CAP><<<(unsigned)bh, kFusedThreads, Fused::bytes, stream>>>(
      q, k, v, out, dout, lse, dq, dk, dv, sq, sk, d, causal, window,
      1.0f / sqrtf((float)d), cap);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. q, out, dout, dq (batch, hq, sq, d); k,
// v, dk, dv (batch, hkv, sk, d); lse (batch, hq, sq); all contiguous f32
// on the device of `stream`, 16-byte aligned; hq a multiple of hkv;
// 4 <= d <= 256, d % 4 == 0; sq, sk >= 1, ceil(sq / 64) and ceil(sk / 64)
// at most 65535; window 0 (none) or the forward's; softcap 0 (none) or
// the forward's cap. Where sq <= 64, sk <= 64 and hq == hkv, launches
// fused_kernel (dd is not read and may be null); else the scratch dd
// (batch, hq, sq) receives D: dq_kernel, then dkv_kernel (which reads
// it). Returns the first CUDA error of the set-up and the launches.
extern "C" int flash_attention_bwd_f32(const float* q, const float* k,
                                       const float* v, const float* out,
                                       const float* dout, const float* lse,
                                       float* dd, float* dq, float* dk,
                                       float* dv, int batch, int hq, int hkv,
                                       int sq, int sk, int d, int causal,
                                       int window, float softcap,
                                       void* stream) {
  if (batch < 1 || hkv < 1 || hq < hkv || hq % hkv != 0 || sq < 1 ||
      sk < 1 || d < 4 || d > kMaxD || d % 4 != 0 || window < 0 ||
      !(softcap >= 0.0f) || (int64_t)batch * hq > 0x7fffffff ||
      (sq + kTile - 1) / kTile > 65535 || (sk + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bhq = batch * hq, bhkv = batch * hkv;
  const bool cap = softcap > 0.0f;
  if (sq <= kTile && sk <= kTile && hq == hkv)
    return cap ? launch_fused<true>(q, k, v, out, dout, lse, dq, dk, dv, bhq,
                                    sq, sk, d, causal, window, softcap, s)
               : launch_fused<false>(q, k, v, out, dout, lse, dq, dk, dv, bhq,
                                     sq, sk, d, causal, window, 0.0f, s);
  if (dd == nullptr) return (int)cudaErrorInvalidValue;
  return cap ? launch_pair<true>(q, k, v, out, dout, lse, dd, dq, dk, dv, bhq,
                                 bhkv, sq, sk, d, causal, window, softcap, s)
             : launch_pair<false>(q, k, v, out, dout, lse, dd, dq, dk, dv, bhq,
                                  bhkv, sq, sk, d, causal, window, 0.0f, s);
}
