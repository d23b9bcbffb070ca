// Shared-memory addresses and 16-byte cp.async copies, shared by the two
// training backward kernels (flash_attention/flash_attention_bwd.cu,
// slstm_cell/slstm_cell_bwd.cu). The forward kernels keep their own
// copies because tools/torch_{flash,slstm}_ablation.py edit those
// sources' text.
#pragma once
#include <stdint.h>

namespace {

// The shared-window address of a generic pointer into shared memory.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace
