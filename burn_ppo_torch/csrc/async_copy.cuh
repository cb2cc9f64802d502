// cp.async helpers of the staged reverse scans K3 (gae.cu) and K5
// (gae_multiplayer.cu): a copy of 16 bytes (``.cg``, around L1) or of 4
// bytes (``.ca``) from global into shared memory, one commit group, and a
// wait until at most N groups are still in flight.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <bool VEC>
__device__ __forceinline__ void copy_unit(float* dst, const void* src) {
  if constexpr (VEC) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

inline bool aligned16(const void* p) { return reinterpret_cast<unsigned long>(p) % 16 == 0; }

}  // namespace
