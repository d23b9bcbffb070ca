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
// sq > sk) is exactly 0. Scores are (q . k) * (1 / sqrt(d)) in f32, and
// with softcap > 0 (the reference's attn_logit_softcap,
// src/repro/models/attention.py:69) softcap * tanh(s / softcap) before
// the online max; softcap 0 leaves them as they are. Key
// tiles that no row of the block can see (past the causal limit, before
// the window) are skipped: they would leave m, l and acc as they were.
//
// Bound: at the transformer encoder's shape (B=64, H=4, S=64, d=256,
// f32, non-causal) the call must read q, k, v and write out once: 67.1
// MB, 20.03 us at 3.35 TB/s. Its products are 1.07 GFLOP (3.2 GFLOP of
// tensor-core work in the 3xTF32 split below), a few us on the tensor
// cores. So bytes bound it.
//
// Design, against what held the first (SIMT, warp-per-row) design back:
//
// 1. K/V re-staged per 8 query rows. A block now owns kBlockM = 64 query
//    rows of one K/V group, and with GQA those rows run over every query
//    head of the group (head-major: row r is head kvh * group + r / sq,
//    position r % sq; such rows are contiguous in q and out). Grid:
//    (B * Hkv, ceil(group * sq / 64)). At the main shape one block holds
//    all 64 rows of a (b, h) and reads its K and V once: 67 MB in all.
// 2. Scalar staging. K/V tiles of 32 keys go through 16-byte cp.async
//    into a double-buffered ring in dynamic shared memory (the next
//    tile's copy overlaps this tile's products); the ragged key tail is
//    zero-filled by the copy (src-size 0). A head dim that is not a
//    multiple of 16 bytes, or a pointer not 16-byte aligned, takes a
//    scalar staging path in the same kernel. Columns d..KD-1 of the
//    padded tiles are zeroed once. The output goes back through shared
//    memory (Q's place) and out as whole rows in 16-byte stores.
// 3. SIMT FMAs. The products run on tensor cores, 16 query rows a warp.
//    f32: mma.sync.m16n8k8 TF32 in a 3xTF32 split, x = big + small with
//    big = rna(x) and small = rna(x - big), rna = cvt.rna.tf32.f32 (done
//    with two integer operations, which issue faster than the conversion
//    instruction), each product accumulated as small*big + big*small +
//    big*big in f32 (plain TF32 would miss the f32 tolerance: ref.TOL,
//    tests/test_torch_flash_attention.py). bf16: mma.sync.m16n8k16 with
//    f32 accumulation, operands through ldmatrix (.trans for V). The
//    online softmax runs on the accumulator fragments (row max by quad
//    shuffles; l summed per thread, reduced across the quad at the end).
//    P reaches PV's A operand in registers, with no shuffle and no shared
//    memory: in f32 the PV sum over a tile's keys is taken in a permuted
//    order (A column t <-> key 2t, t + 4 <-> key 2t+1), so that the S
//    accumulator fragment is the A fragment and V's B fragment reads the
//    same keys; in bf16 the S fragments pack pairwise into A as in the
//    standard layout. f32 Q and K fragments are read as float4 with the
//    same kind of permutation over each 16 dims.
// 4. Low occupancy. Shared memory a block, at template width KD (d
//    rounded up to 32, 64, 128 or 256), 32-key tiles, two stages: f32
//    KD=256: Q 64 x 272 + K 2 x 32 x 272 + V 2 x 32 x 260 floats =
//    205,824 B, one block an SM, so the f32 block has 8 warps: two a row
//    group, each taking 16 keys of every tile with its own (m, l, acc),
//    merged through the ring at the end; 256 blocks over 132 SMs = 1.94
//    waves at the main shape. bf16 KD=256: 101,376 B, 4 warps, two
//    blocks an SM, 0.97 waves. Rows are padded so that the fragment
//    loads are free of bank conflicts.
//
// What is left: at the main shape the f32 call stays far above its bound
// even with its products removed (tools/torch_flash_ablation.py; PERF.md
// has the times), so the staging and store pipeline of one block an SM,
// not the tensor cores, holds it back.
//
// K and V are read through element strides (KvStrides: batch, K/V head,
// key row; the head dim contiguous), so a decode step reads its cache's
// (batch, length, hkv, d) slots where they lie, with no transposed copy;
// the arithmetic does not depend on the strides.
//
// ptxas (sm_90a, -O3), as chip_smoke.py's build phase prints it from the
// -Xptxas -v report kernels/_build.py keeps: f32 KD=256 255 registers
// (8 warps at 255 just fit an SM's 65,536), KD=128 128 (two blocks an
// SM), 64 108, 32 80; bf16 KD=256 244 (2 blocks x 4 warps fit), 128 128,
// 64 80, 32 62; the capped instances f32 255, 128, 108, 78 and bf16 242,
// 127, 88, 64; no stack frame and no spills in any instance.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;  // query rows a block: 4 row groups of 16
constexpr int kRowGroups = kBlockM / 16;
constexpr int kStages = 2;
constexpr int kMaxD = 256;
constexpr unsigned kFull = 0xffffffffu;

typedef __nv_bfloat16 bf16;

// Element strides of K and V (one set for both): batch, K/V head, key
// row; the head dim is contiguous. A contiguous (batch, hkv, sk, d)
// array has (hkv * sk * d, sk * d, d); a decode cache read in place,
// (batch, length, hkv, d), has (length * hkv * d, d, hkv * d).
struct KvStrides {
  int64_t batch, head, row;
};

// Keys a tile, and the warps that share a row group, each taking
// keys / split keys of every tile with its own (m, l, acc), merged once
// at the end. f32: 32 keys, 2 warps a row group (8 warps a block; the
// block's shared memory admits one block an SM); bf16: 32 keys, 1 warp
// (4 warps, two blocks an SM).
template <typename T>
struct Tiling;
template <>
struct Tiling<float> {
  static constexpr int keys = 32, split = 2;
};
template <>
struct Tiling<bf16> {
  static constexpr int keys = 32, split = 1;
};
template <typename T>
constexpr int kKeys = Tiling<T>::keys;
template <typename T>
constexpr int kSplit = Tiling<T>::split;
template <typename T>
constexpr int kThreads = kRowGroups * kSplit<T> * 32;

// Row strides (elements) of the shared-memory tiles.
// f32: Q and K rows 16 mod 32 words (float4 fragment loads), V rows
// 4 mod 32 words (scalar loads of keys 2t and 2t+1 across a quad).
// bf16: rows 16 mod 128 bytes (ldmatrix, 8 rows of 16 bytes).
template <typename T, int KD>
struct Layout {
  static constexpr bool f32 = sizeof(T) == 4;
  static constexpr int ldq = KD + (f32 ? 16 : 8);
  static constexpr int ldv = KD + (f32 ? 4 : 8);
  static constexpr int q_elems = kBlockM * ldq;
  static constexpr int k_elems = kKeys<T> * ldq;  // one stage
  static constexpr int v_elems = kKeys<T> * ldv;
  static constexpr size_t bytes =
      sizeof(T) * (size_t)(q_elems + kStages * (k_elems + v_elems));
};

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16(0.0f); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// cvt.rna.tf32.f32 (round to nearest, ties away from zero, to TF32's 10
// mantissa bits) of a finite x, with two integer operations, which issue
// faster than the conversion instruction (tools/torch_flash_ablation.py
// times both forms).
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, each a TF32 value in a .b32 register: big = rna(x),
// small = rna(x - big) (x - big is exact in f32).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = rna_tf32(x);
  small = rna_tf32(x - __uint_as_float(big));
}

// The products carry no side effect: not volatile, so that the compiler
// may interleave independent accumulators.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32: the two small cross terms first, then big * big.
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* a_big,
                                           const uint32_t* a_small,
                                           const uint32_t* b_big,
                                           const uint32_t* b_small) {
  mma_tf32(c, a_small, b_big[0], b_big[1]);
  mma_tf32(c, a_big, b_small[0], b_small[1]);
  mma_tf32(c, a_big, b_big[0], b_big[1]);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Copy `rows` rows of d elements (global row stride src_ld) into shared
// rows of stride ld; rows at or past `valid` are written as zeros.
// Columns d..KD-1 are not touched (zeroed once by the kernel).
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src,
                                           int64_t src_ld, int rows,
                                           int valid, int d, bool vec) {
  if (vec) {
    constexpr int kVec = 16 / (int)sizeof(T);
    const int chunks = d / kVec;
    for (int e = threadIdx.x; e < rows * chunks; e += kThreads<T>) {
      const int r = e / chunks;
      const int c = (e - r * chunks) * kVec;
      const bool in = r < valid;
      cp_async16(dst + r * ld + c, in ? src + r * src_ld + c : src,
                 in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * d; e += kThreads<T>) {
      const int r = e / d;
      const int c = e - r * d;
      dst[r * ld + c] = r < valid ? src[r * src_ld + c] : zero<T>();
    }
  }
}

// S = Q K^T for the warp's 16 rows and its NK keys of the tile: s[nt] is
// the m16n8 accumulator fragment of keys nt*8 .. nt*8+7.
template <int KD, int NK>
__device__ __forceinline__ void tile_scores(float (*s)[4], const float* qs,
                                            const float* ks, int lane) {
  using L = Layout<float, KD>;
  const int g = lane >> 2, t = lane & 3;
  const float* qa = qs + g * L::ldq + 4 * t;
  const float* qb = qa + 8 * L::ldq;
#pragma unroll 2
  for (int kc = 0; kc < KD; kc += 16) {
    // dims kc+4t .. kc+4t+3: the first k8 step takes 4t, 4t+1 as its
    // columns t, t+4, the second 4t+2, 4t+3 (Q and K alike)
    const float4 xa = *reinterpret_cast<const float4*>(qa + kc);
    const float4 xb = *reinterpret_cast<const float4*>(qb + kc);
    uint32_t a0b[4], a0s[4], a1b[4], a1s[4];
    split_tf32(xa.x, a0b[0], a0s[0]);
    split_tf32(xb.x, a0b[1], a0s[1]);
    split_tf32(xa.y, a0b[2], a0s[2]);
    split_tf32(xb.y, a0b[3], a0s[3]);
    split_tf32(xa.z, a1b[0], a1s[0]);
    split_tf32(xb.z, a1b[1], a1s[1]);
    split_tf32(xa.w, a1b[2], a1s[2]);
    split_tf32(xb.w, a1b[3], a1s[3]);
#pragma unroll
    for (int nt = 0; nt < NK / 8; ++nt) {
      const float4 y = *reinterpret_cast<const float4*>(
          ks + (nt * 8 + g) * L::ldq + kc + 4 * t);
      uint32_t b0b[2], b0s[2], b1b[2], b1s[2];
      split_tf32(y.x, b0b[0], b0s[0]);
      split_tf32(y.y, b0b[1], b0s[1]);
      split_tf32(y.z, b1b[0], b1s[0]);
      split_tf32(y.w, b1b[1], b1s[1]);
      mma_3xtf32(s[nt], a0b, a0s, b0b, b0s);
      mma_3xtf32(s[nt], a1b, a1s, b1b, b1s);
    }
  }
}

template <int KD, int NK>
__device__ __forceinline__ void tile_scores(float (*s)[4], const bf16* qs,
                                            const bf16* ks, int lane) {
  using L = Layout<bf16, KD>;
  const bf16* qp = qs + (lane & 15) * L::ldq + 8 * (lane >> 4);
  const bf16* kp =
      ks + ((lane & 7) + 8 * (lane >> 4)) * L::ldq + 8 * ((lane >> 3) & 1);
#pragma unroll 4
  for (int kc = 0; kc < KD; kc += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, qp + kc);
#pragma unroll
    for (int nt = 0; nt < NK / 8; nt += 2) {
      uint32_t b[4];  // b0, b1 of key tiles nt and nt + 1
      ldmatrix_x4(b, kp + nt * 8 * L::ldq + kc);
      mma_bf16(s[nt], a, b[0], b[1]);
      mma_bf16(s[nt + 1], a, b[2], b[3]);
    }
  }
}

// O += P V for the warp's 16 rows over its NK keys; p holds P in the S
// fragment layout.
template <int KD, int NK>
__device__ __forceinline__ void tile_pv(float (*o)[4], float (*p)[4],
                                        const float* vs, int lane) {
  using L = Layout<float, KD>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NK / 8; ++j) {
    // A column t <-> key 8j + 2t, column t + 4 <-> key 8j + 2t + 1
    uint32_t ab[4], as[4];
    split_tf32(p[j][0], ab[0], as[0]);
    split_tf32(p[j][2], ab[1], as[1]);
    split_tf32(p[j][1], ab[2], as[2]);
    split_tf32(p[j][3], ab[3], as[3]);
    const float* v0 = vs + (8 * j + 2 * t) * L::ldv + g;
#pragma unroll
    for (int nt = 0; nt < KD / 8; ++nt) {
      uint32_t bb[2], bs[2];
      split_tf32(v0[nt * 8], bb[0], bs[0]);
      split_tf32(v0[L::ldv + nt * 8], bb[1], bs[1]);
      mma_3xtf32(o[nt], ab, as, bb, bs);
    }
  }
}

template <int KD, int NK>
__device__ __forceinline__ void tile_pv(float (*o)[4], float (*p)[4],
                                        const bf16* vs, int lane) {
  using L = Layout<bf16, KD>;
  const bf16* vp =
      vs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * L::ldv + 8 * (lane >> 4);
#pragma unroll
  for (int i = 0; i < NK / 16; ++i) {
    const uint32_t a[4] = {pack_bf16(p[2 * i][0], p[2 * i][1]),
                           pack_bf16(p[2 * i][2], p[2 * i][3]),
                           pack_bf16(p[2 * i + 1][0], p[2 * i + 1][1]),
                           pack_bf16(p[2 * i + 1][2], p[2 * i + 1][3])};
#pragma unroll
    for (int nt = 0; nt < KD / 8; nt += 2) {
      uint32_t b[4];  // b0, b1 of output column tiles nt and nt + 1
      ldmatrix_x4_trans(b, vp + 16 * i * L::ldv + nt * 8);
      mma_bf16(o[nt], a, b[0], b[1]);
      mma_bf16(o[nt + 1], a, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// kCap: scores pass through softcap * tanh(s / softcap). A separate
// instance: inlined into the unrolled mask loop, the cap's tanhf takes
// registers (the f32 KD = 128 instance needs 156 with it and 128 without:
// one block an SM against two).
template <typename T, int KD, bool kCap>
__global__ void __launch_bounds__(kThreads<T>)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int hq,
                 int hkv, int sq, int sk, int d, int causal, int window,
                 float scale, float softcap, int vec, KvStrides kvs) {
  using L = Layout<T, KD>;
  constexpr int NK = kKeys<T> / kSplit<T>;  // keys of a tile a warp takes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + L::q_elems;            // kStages x (kKeys<T>, ldq)
  T* vs = ks + kStages * L::k_elems;  // kStages x (kKeys<T>, ldv)

  const int group = hq / hkv;
  const int bkv = blockIdx.x;  // b * hkv + kv head
  const int b = bkv / hkv;
  const int kvh = bkv - b * hkv;
  const int rows = group * sq;  // the group's query rows, head-major
  const int m0 = blockIdx.y * kBlockM;
  const int valid = min(kBlockM, rows - m0);
  // the block's first row in q and out: head kvh * group + m0 / sq
  const int64_t row0 = ((int64_t)b * hq + (int64_t)kvh * group) * sq + m0;
  const T* qp = q + row0 * d;
  const int64_t kv_off = b * kvs.batch + kvh * kvs.head;
  const T* kp = k + kv_off;
  const T* vp = v + kv_off;
  const int off = sk - sq;  // query position p sits at key position p + off

  // the keys any row of the block can see: [k_lo, k_hi)
  const int r_last = m0 + valid - 1;
  int p_first = m0 % sq, p_last = r_last % sq;
  if (m0 / sq != r_last / sq) {  // the block spans two heads' rows
    p_first = 0;
    p_last = sq - 1;
  }
  const int k_hi = causal ? min(sk, p_last + off + 1) : sk;
  int k_lo = window > 0 ? max(0, p_first + off - window + 1) : 0;
  k_lo = (k_lo / kKeys<T>) * kKeys<T>;

  // columns d .. KD-1 of every tile row read as zero
  const int pad = KD - d;
  if (pad > 0) {
    constexpr int kRowsAll = kBlockM + 2 * kStages * kKeys<T>;
    for (int e = threadIdx.x; e < kRowsAll * pad; e += kThreads<T>) {
      const int r = e / pad;
      const int c = d + (e - r * pad);
      T* row = r < kBlockM ? qs + r * L::ldq
               : r < kBlockM + kStages * kKeys<T>
                   ? ks + (r - kBlockM) * L::ldq
                   : vs + (r - kBlockM - kStages * kKeys<T>) * L::ldv;
      row[c] = zero<T>();
    }
  }

  auto stage_kv = [&](int slot, int kb) {
    const int in = min(kKeys<T>, sk - kb);
    stage_rows<T>(ks + slot * L::k_elems, L::ldq, kp + kb * kvs.row,
                  kvs.row, kKeys<T>, in, d, vec);
    stage_rows<T>(vs + slot * L::v_elems, L::ldv, vp + kb * kvs.row,
                  kvs.row, kKeys<T>, in, d, vec);
  };
  stage_rows<T>(qs, L::ldq, qp, d, kBlockM, valid, d, vec);
  if (k_lo < k_hi) stage_kv(0, k_lo);
  cp_async_commit();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rg = warp % kRowGroups;  // rows rg*16 .. rg*16+15
  const int kh = warp / kRowGroups;  // keys kh*NK .. kh*NK+NK-1 of a tile
  const int g = lane >> 2, t = lane & 3;
  // this thread's two rows, rg*16 + g and + 8, at key positions qi
  int qi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) qi[h] = (m0 + rg * 16 + g + 8 * h) % sq + off;

  float o[KD / 8][4];
#pragma unroll
  for (int nt = 0; nt < KD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.0f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.0f, 0.0f};  // this thread's share of the row sums

  int slot = 0;
  for (int kb = k_lo; kb < k_hi; kb += kKeys<T>) {
    if (kb + kKeys<T> < k_hi) stage_kv(slot ^ 1, kb + kKeys<T>);
    cp_async_commit();
    cp_async_wait<1>();  // Q and this tile have landed
    __syncthreads();

    float s[NK / 8][4];
#pragma unroll
    for (int nt = 0; nt < NK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
    tile_scores<KD, NK>(s, qs + rg * 16 * L::ldq,
                        ks + slot * L::k_elems + kh * NK * L::ldq, lane);

    // scale, mask, and the online softmax on the fragments: element e
    // of s[nt] is row g + 8 * (e >> 1), key k0 + nt*8 + 2t + (e & 1)
    const int k0 = kb + kh * NK;
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < NK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t + (e & 1);
        const int h = e >> 1;
        bool vis = key < sk;
        if (causal) vis = vis && key <= qi[h];
        if (window > 0) vis = vis && key > qi[h] - window;
        if constexpr (kCap) {
          const float x = s[nt][e] * scale;
          s[nt][e] = vis ? softcap * tanhf(x / softcap) : -CUDART_INF_F;
        } else {
          s[nt][e] = vis ? s[nt][e] * scale : -CUDART_INF_F;
        }
        mx[h] = fmaxf(mx[h], s[nt][e]);
      }
    float alpha[2], safe_m[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      safe_m[h] = isfinite(m_new) ? m_new : 0.0f;
      alpha[h] = isfinite(m[h]) ? expf(m[h] - safe_m[h]) : 0.0f;
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int nt = 0; nt < NK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a masked score is -inf, and exp(-inf) is exactly 0
        const float p = expf(s[nt][e] - safe_m[e >> 1]);
        s[nt][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int nt = 0; nt < KD / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] *= alpha[e >> 1];
    tile_pv<KD, NK>(o, s, vs + slot * L::v_elems + kh * NK * L::ldv, lane);
    __syncthreads();  // every warp is done with this slot
    slot ^= 1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
  }
  if constexpr (kSplit<T> == 2) {
    // merge the two key halves' (m, l, acc) of each row through the
    // ring, which no warp reads any more: the second half's warps write
    // theirs, lane-minor so that the accesses are conflict-free
    constexpr int kLanes = kRowGroups * 32;
    static_assert((KD / 2 + 4) * kLanes <= kStages * (L::k_elems + L::v_elems),
                  "the merge's exchange must fit in the K/V ring");
    float* xo = reinterpret_cast<float*>(ks);  // (KD/2, kLanes)
    float* xml = xo + (KD / 2) * kLanes;        // (4, kLanes): m, l
    const int i = rg * 32 + lane;
    __syncthreads();
    if (kh == 1) {
#pragma unroll
      for (int nt = 0; nt < KD / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) xo[(nt * 4 + e) * kLanes + i] = o[nt][e];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        xml[h * kLanes + i] = m[h];
        xml[(2 + h) * kLanes + i] = l[h];
      }
    }
    __syncthreads();
    if (kh == 0) {
      float fa[2], fb[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mb = xml[h * kLanes + i];
        const float mm = fmaxf(m[h], mb);
        const float safe = isfinite(mm) ? mm : 0.0f;
        fa[h] = isfinite(m[h]) ? expf(m[h] - safe) : 0.0f;
        fb[h] = isfinite(mb) ? expf(mb - safe) : 0.0f;
        l[h] = fa[h] * l[h] + fb[h] * xml[(2 + h) * kLanes + i];
        m[h] = mm;  // l is now relative to the merged max
      }
#pragma unroll
      for (int nt = 0; nt < KD / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[nt][e] = fa[e >> 1] * o[nt][e] +
                     fb[e >> 1] * xo[(nt * 4 + e) * kLanes + i];
    }
  }

  // the row's log-sum-exp of the scaled scores, for the backward
  // (flash_attention_bwd.cu): -inf where the row sees no key
  if (lse != nullptr && kh == 0 && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rg * 16 + g + 8 * h;
      if (r < valid)
        lse[row0 + r] = isfinite(m[h]) ? m[h] + logf(l[h]) : -CUDART_INF_F;
    }
  }

  // epilogue: acc / max(l, 1e-30) into the Q tile's place as a
  // (kBlockM, ldq) tile of T, then whole rows out with 16-byte stores
  T* os = qs;
  __syncthreads();  // no warp reads Q, and every copy into it has landed
  if (kh == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rg * 16 + g + 8 * h;
      const float denom = fmaxf(l[h], 1e-30f);
#pragma unroll
      for (int nt = 0; nt < KD / 8; ++nt)
        store2(os + r * L::ldq + nt * 8 + 2 * t, o[nt][2 * h] / denom,
               o[nt][2 * h + 1] / denom);
    }
  }
  __syncthreads();
  T* orow0 = out + row0 * d;
  if (vec) {
    constexpr int kVec = 16 / (int)sizeof(T);
    const int chunks = d / kVec;
    for (int e = threadIdx.x; e < valid * chunks; e += kThreads<T>) {
      const int r = e / chunks;
      const int c = (e - r * chunks) * kVec;
      *reinterpret_cast<uint4*>(orow0 + (int64_t)r * d + c) =
          *reinterpret_cast<const uint4*>(os + r * L::ldq + c);
    }
  } else {
    for (int e = threadIdx.x; e < valid * d; e += kThreads<T>) {
      const int r = e / d;
      const int c = e - r * d;
      orow0[(int64_t)r * d + c] = os[r * L::ldq + c];
    }
  }
}

template <typename T, int KD, bool kCap>
int launch_kd(const void* q, const void* k, const void* v, void* out,
              float* lse, int batch, int hq, int hkv, int sq, int sk, int d,
              int causal, int window, float softcap, int vec, KvStrides kvs,
              cudaStream_t stream) {
  using L = Layout<T, KD>;
  // above 48 KB a block's dynamic shared memory needs opting in (on the
  // current device, so at every launch)
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<T, KD, kCap>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::bytes);
  if (attr != cudaSuccess) return (int)attr;
  const int m_tiles = ((hq / hkv) * sq + kBlockM - 1) / kBlockM;
  const float scale = 1.0f / sqrtf((float)d);
  flash_kernel<T, KD, kCap><<<dim3((unsigned)(batch * hkv), (unsigned)m_tiles),
                              kThreads<T>, L::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, hq, hkv, sq, sk, d,
      causal, window, scale, softcap, vec, kvs);
  return (int)cudaGetLastError();
}

template <typename T, bool kCap>
int launch_cap(const void* q, const void* k, const void* v, void* out,
               float* lse, int batch, int hq, int hkv, int sq, int sk, int d,
               int causal, int window, float softcap, int vec, KvStrides kvs,
               cudaStream_t s) {
  if (d <= 32)
    return launch_kd<T, 32, kCap>(q, k, v, out, lse, batch, hq, hkv, sq, sk,
                                  d, causal, window, softcap, vec, kvs, s);
  if (d <= 64)
    return launch_kd<T, 64, kCap>(q, k, v, out, lse, batch, hq, hkv, sq, sk,
                                  d, causal, window, softcap, vec, kvs, s);
  if (d <= 128)
    return launch_kd<T, 128, kCap>(q, k, v, out, lse, batch, hq, hkv, sq, sk,
                                   d, causal, window, softcap, vec, kvs, s);
  return launch_kd<T, 256, kCap>(q, k, v, out, lse, batch, hq, hkv, sq, sk,
                                 d, causal, window, softcap, vec, kvs, s);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int batch, int hq, int hkv, int sq, int sk, int d,
           int causal, int window, float softcap, KvStrides kvs,
           void* stream) {
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || sk < 0 ||
      d < 1 || d > kMaxD || window < 0 || !(softcap >= 0.0f) ||
      kvs.batch < 0 || kvs.head < 0 || kvs.row < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t m_tiles =
      ((int64_t)(hq / hkv) * sq + kBlockM - 1) / kBlockM;
  if (m_tiles > 65535 || (int64_t)batch * hkv > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  constexpr int kVec = 16 / (int)sizeof(T);
  const int vec = d % kVec == 0 &&
                  (kvs.batch | kvs.head | kvs.row) % kVec == 0 &&
                  (reinterpret_cast<uintptr_t>(q) |
                   reinterpret_cast<uintptr_t>(k) |
                   reinterpret_cast<uintptr_t>(v) |
                   reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (softcap > 0.0f)
    return launch_cap<T, true>(q, k, v, out, lse, batch, hq, hkv, sq, sk, d,
                               causal, window, softcap, vec, kvs, s);
  return launch_cap<T, false>(q, k, v, out, lse, batch, hq, hkv, sq, sk, d,
                              causal, window, softcap, vec, kvs, s);
}

KvStrides contiguous_kv(int hkv, int sk, int d) {
  return KvStrides{(int64_t)hkv * sk * d, (int64_t)sk * d, (int64_t)d};
}

}  // namespace

// Plain C entry points for ctypes, one a dtype (the contiguous form, the
// interface tools/torch_forward_baseline.py and torch_flash_ablation.py
// call every version of this source through). q is a contiguous
// (batch, hq, sq, d) array, k and v contiguous (batch, hkv, sk, d) arrays
// of q's dtype, out a contiguous (batch, hq, sq, d) array of q's dtype,
// all on the device of `stream`; hq % hkv == 0, 1 <= d <= 256, (hq / hkv)
// * sq <= 65535 * 64 and batch * hkv < 2^31 (the grid). lse is null or a
// contiguous (batch, hq, sq) f32 array that receives the row log-sum-exp
// of the scaled scores (-inf for a row with no visible key); out is the
// same bit for bit either way. causal is 0 or 1; window 0 means no
// window; softcap 0 means no logit cap, else scores are capped to
// softcap * tanh(s / softcap). Returns the first CUDA error of the
// attribute call and the launch.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, float* lse,
                                   int batch, int hq, int hkv, int sq, int sk,
                                   int d, int causal, int window,
                                   float softcap, void* stream) {
  return launch<float>(q, k, v, out, lse, batch, hq, hkv, sq, sk, d, causal,
                       window, softcap, contiguous_kv(hkv, sk, d), stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, float* lse,
                                    int batch, int hq, int hkv, int sq,
                                    int sk, int d, int causal, int window,
                                    float softcap, void* stream) {
  return launch<bf16>(q, k, v, out, lse, batch, hq, hkv, sq, sk, d, causal,
                      window, softcap, contiguous_kv(hkv, sk, d), stream);
}

// The same with K and V at any element strides (kv_batch, kv_head,
// kv_row; each >= 0, the head dim contiguous), read where they lie: the
// launcher passes a decode cache's (batch, length, hkv, d) slots so,
// with no transposed copy. The arithmetic is that of the entries above.
extern "C" int flash_attention_kv_f32(const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      int batch, int hq, int hkv, int sq,
                                      int sk, int d, int causal, int window,
                                      float softcap, long long kv_batch,
                                      long long kv_head, long long kv_row,
                                      void* stream) {
  return launch<float>(q, k, v, out, lse, batch, hq, hkv, sq, sk, d, causal,
                       window, softcap, KvStrides{kv_batch, kv_head, kv_row},
                       stream);
}

extern "C" int flash_attention_kv_bf16(const void* q, const void* k,
                                       const void* v, void* out, float* lse,
                                       int batch, int hq, int hkv, int sq,
                                       int sk, int d, int causal, int window,
                                       float softcap, long long kv_batch,
                                       long long kv_head, long long kv_row,
                                       void* stream) {
  return launch<bf16>(q, k, v, out, lse, batch, hq, hkv, sq, sk, d, causal,
                      window, softcap, KvStrides{kv_batch, kv_head, kv_row},
                      stream);
}
