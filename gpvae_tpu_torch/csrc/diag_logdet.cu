// logdet K = 2 sum_i log L[i, i] for a batch of Cholesky factors, one
// thread block per matrix.
//
// Replaces the TPU kernel gpvae_tpu/ops/pallas_big.py _diag_kernel (B13),
// which reads the T/128 diagonal tiles of each [T, T] factor and
// mask-reduces them to the diagonal, together with the log-sum that XLA
// ran after it (gpvae_tpu/ops/logdet.py).  A block reads only the T
// diagonal elements of its matrix.
//
// What bounds it on Hopper: one DRAM round trip.  The diagonal's stride
// is T + 1 floats, so every element is a 32-byte sector of its own: 4 MB
// at T = 1024 over the stacked training bank (n = 128), about 1.25 us at
// 3.35 TB/s, which is less than a launch.  So the design puts every load
// of a matrix in flight at once: each of the 256 threads loads its
// elements (rows threadIdx.x, threadIdx.x + 256, ...) into registers,
// kBatch at a time, before the first logf; then a warp-shuffle sum and an
// 8-warp sum through shared memory.  At n = 128 the grid is one wave of
// the card's 132 SMs, and the matrix's T / 256 loads a thread are one
// round trip for T <= 256 * kBatch.
//
// The factors may be a strided view: matrix (a, b) of an [n1, n2, T, T]
// view starts at l + a*s1 + b*s2, its rows ld apart (the posterior and
// prior halves of the stacked bank are such views).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// diagonal elements a thread holds in registers at once
constexpr int kBatch = 8;

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  return s;
}

__global__ void __launch_bounds__(kThreads)
diag_logdet_kernel(const float* __restrict__ l, long long s1, long long s2,
                   int n2, int ld, int t, float* __restrict__ out) {
  __shared__ float warp_sums[kWarps];
  const int m = blockIdx.x;
  const float* lm = l + (long long)(m / n2) * s1 + (long long)(m % n2) * s2;
  const long long step = (long long)ld + 1;
  float s = 0.0f;
  for (int base = 0; base < t; base += kThreads * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = base + k * kThreads + (int)threadIdx.x;
      v[k] = i < t ? __ldg(lm + i * step) : 1.0f;  // log 1 = 0
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) s += logf(v[k]);
  }
  s = warp_sum(s);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = warp_sum(lane < kWarps ? warp_sums[lane] : 0.0f);
    if (lane == 0) out[m] = 2.0f * s;
  }
}

}  // namespace

extern "C" {

// l: float32 on the device, matrix (a, b) for a < n1, b < n2 at
// l + a*s1 + b*s2 (elements), rows at stride ld; out: [n1 * n2] float32.
// Launches on `stream` and returns the cudaError_t of the launch.
int gpvae_diag_logdet_f32(const void* l, long long s1, long long s2, int n1,
                          int n2, int ld, int t, void* out, void* stream) {
  const long long n = (long long)n1 * n2;
  if (n <= 0) return 0;
  if (t < 1 || ld < t || n > (1LL << 30)) return (int)cudaErrorInvalidValue;
  diag_logdet_kernel<<<(unsigned)n, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)l, s1, s2, n2, ld, t, (float*)out);
  return (int)cudaGetLastError();
}

const char* gpvae_cuda_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
