// cp.async (sm_80 and later): copies from device memory to shared memory that do not pass
// through registers, in commit groups that a thread waits for: 16 bytes through L2, or 4, 8
// or 16 through L1.  Both addresses must be aligned to the copy's size.

#pragma once

#include <cuda_runtime.h>

namespace roc {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(gmem));
}

// BYTES = 4, 8 or 16 through L1 (cp.async.ca; .cg takes 16 bytes only): for rows of a
// read-only input that are aligned to less than 16 bytes.
template <int BYTES>
__device__ __forceinline__ void cp_async_ca(void* smem, const void* gmem) {
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "cp.async copies 4, 8 or 16 bytes");
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(a), "l"(gmem), "n"(BYTES));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's commit groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace roc
