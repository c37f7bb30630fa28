// Asynchronous copies from global to shared memory (cp.async), and the
// alignment test that chooses between their 16- and 4-byte forms: shared
// by gram_panel.cu and panel_solve.cu.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace gpvae {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// `bytes` of the 16 (or 4) at src into shared memory at dst; the rest of
// the 16 (or 4) zero-filled
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16-byte copies of a row start at every 4th float from `base`
inline bool aligned16(const void* base, long long mat, int ld, int col) {
  return (reinterpret_cast<uintptr_t>(base) % 16 == 0) && mat % 4 == 0 &&
         ld % 4 == 0 && col % 4 == 0;
}

}  // namespace gpvae
