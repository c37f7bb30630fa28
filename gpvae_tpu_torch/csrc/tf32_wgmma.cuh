// The 3xTF32 arithmetic on Hopper's tensor cores, shared by the kernels
// that multiply float32 operands with wgmma (gram_panel.cu, chol_bwd.cu):
// the rounded TF32 split of an operand, and warpgroup products of k-major
// TF32 tiles read from shared memory in the 128-byte swizzle.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "cp_async.cuh"

namespace gpvae {

// x to TF32 (10 mantissa bits), to nearest, ties away from zero, as
// cvt.rna.tf32.f32 does, in two integer operations (the conversion
// instruction issues at a fraction of their rate)
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + e, hi and lo TF32, |e| <= 2^-22 |x|, rounded both times
// (a truncated split biases sums of squares: a panel's diagonal)
__device__ __forceinline__ void split2(float x, float& hi, float& lo) {
  hi = __uint_as_float(tf32_rna(x));
  lo = __uint_as_float(tf32_rna(x - hi));
}

// The descriptor of a k-major operand in shared memory in the 128-byte
// swizzle: rows of 128 bytes (32 TF32), the 16-byte chunk j of row r
// stored at chunk j ^ (r % 8); 8-row atoms of 1024 bytes, 1024-byte
// aligned, one after another.  A k offset within the row is added to the
// start address.
__device__ __forceinline__ uint64_t smem_desc_sw128(const float* p) {
  return (uint64_t)((smem_addr(p) & 0x3ffff) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// shared-memory writes of this thread made visible to the async proxy
// (wgmma reads through it)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keeps the compiler from moving accesses of r across an async window
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// d (+)= a b, a 64 x 8 and b 128 x 8 in shared memory (descriptors),
// k-major TF32; d is 64 floats a thread; scale_d = 0: d = a b
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (+)= a b, a 64 x 8 and b 64 x 8 in shared memory (descriptors),
// k-major TF32; d is 32 floats a thread; scale_d = 0: d = a b
__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[32], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

}  // namespace gpvae
