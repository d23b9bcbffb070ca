// Thread-block cluster, mbarrier and st.async helpers of the sLSTM BPTT
// kernel (slstm_cell/slstm_cell_bwd.cu): those of slstm_cell/slstm_cell.cu,
// which keeps its own copies because tools/torch_slstm_ablation.py edits
// that source's text. Addresses are 32-bit shared-window addresses
// (smem_addr of cp_async.cuh), mapped into a peer CTA with map_rank.
#pragma once
#include <stdint.h>

namespace {

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}
// `addr` of this CTA's shared memory as the same offset in CTA `rank`'s.
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
// A phase that has not completed after about 2^35 cycles (17 s) can only
// be a fault: trap, so that the launch fails instead of holding the card.
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
// The same for 8 bytes at an 8-byte aligned address.
__device__ __forceinline__ void st_async2(uint32_t addr, float a, float b,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];"
      ::"r"(addr), "f"(a), "f"(b), "r"(bar) : "memory");
}

}  // namespace
