// Asynchronous copies from device to shared memory (cp.async), shared by
// the FP32 contraction (contract.cuh) and the grid kernel's staging
// (tf32x3.cuh).

#pragma once

#include <cuda_runtime.h>

namespace tabcorr {

// Start copying 16 bytes (both addresses 16-byte aligned), past L1.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem));
}

// Close the group of the copies this thread has started since the last
// commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::);
}

// Wait until at most N of this thread's groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

}  // namespace tabcorr
