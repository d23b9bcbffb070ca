// 3xTF32 products on the tensor cores (mma.sync.m16n8k8), shared by the
// two training backward kernels (flash_attention/flash_attention_bwd.cu,
// slstm_cell/slstm_cell_bwd.cu). The helpers are those of
// flash_attention/flash_attention.cu, which keeps its own copies because
// tools/torch_flash_ablation.py edits that source's text.
//
// An f32 product a b is run as three TF32 products: x = big + small with
// big = rna(x) and small = rna(x - big) (rna = cvt.rna.tf32.f32, done
// with two integer operations), accumulated as small*big + big*small +
// big*big in f32; the error is that of an f32 product, where one TF32
// product keeps about three decimal digits.
//
// Fragment layouts of m16n8k8 (g = lane / 4, t = lane % 4): A (16 x 8,
// row-major) a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 =
// A[g+8][t+4]; B (8 x 8) b0 = B[t][g], b1 = B[t+4][g]; C c0 = C[g][2t],
// c1 = C[g][2t+1], c2 = C[g+8][2t], c3 = C[g+8][2t+1].
#pragma once
#include <stdint.h>

namespace {

// cvt.rna.tf32.f32 of a finite x with two integer operations.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, each a TF32 value: big = rna(x), small = rna(x - big).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = rna_tf32(x);
  small = rna_tf32(x - __uint_as_float(big));
}

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

// c += a b in 3xTF32 with the running sum kept out of the tensor cores:
// the step's three products go into a zeroed fragment, which is then
// added to c in f32 with round-to-nearest. mma.sync adds its products
// into c truncated, near an ulp of c each, and the drift is one-sided:
// over a long sum of large values (the flash backward's s and dp over d
// = 256) that is the error's main part (tools/torch_bwd_ablation.py).
__device__ __forceinline__ void mma_3xtf32_rn(float* c, const uint32_t* a_big,
                                              const uint32_t* a_small,
                                              const uint32_t* b_big,
                                              const uint32_t* b_small) {
  float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_3xtf32(z, a_big, a_small, b_big, b_small);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += z[e];
}

// The A fragment of rows r0 + g, r0 + g + 8 and columns c0 + t, c0 + t + 4
// of a row-major tile of stride ld, split.
__device__ __forceinline__ void load_a(uint32_t (&big)[4], uint32_t (&small)[4],
                                       const float* tile, int ld, int r0,
                                       int c0, int g, int t) {
  const float* p = tile + (r0 + g) * ld + c0 + t;
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[8 * ld], big[1], small[1]);
  split_tf32(p[4], big[2], small[2]);
  split_tf32(p[8 * ld + 4], big[3], small[3]);
}

// The B fragment of k rows k0 + t, k0 + t + 4 and column n of a
// row-major (k, n) tile of stride ld, split.
__device__ __forceinline__ void load_b_kn(uint32_t (&big)[2],
                                          uint32_t (&small)[2],
                                          const float* tile, int ld, int k0,
                                          int n, int t) {
  const float* p = tile + (k0 + t) * ld + n;
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[4 * ld], big[1], small[1]);
}

// The B fragment of k columns k0 + t, k0 + t + 4 of row n of a
// row-major (n, k) tile of stride ld (B = tile^T), split.
__device__ __forceinline__ void load_b_nk(uint32_t (&big)[2],
                                          uint32_t (&small)[2],
                                          const float* tile, int ld, int n,
                                          int k0, int t) {
  const float* p = tile + n * ld + k0 + t;
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[4], big[1], small[1]);
}

}  // namespace
