// logdet K = 2 sum_i log L[i, i] for a batch of Cholesky factors, one warp
// per matrix.
//
// Replaces the TPU kernel gpvae_tpu/ops/pallas_big.py _diag_kernel (B13),
// which reads the T/128 diagonal tiles of each [T, T] factor and
// mask-reduces them to the diagonal, together with the log-sum that XLA
// ran after it (gpvae_tpu/ops/logdet.py).  A warp reads only the T
// diagonal elements, lane i taking rows i, i + 32, ..., and reduces with
// shuffles.
//
// What bounds it on Hopper: bytes, T floats a matrix, each in its own
// 32-byte sector (the diagonal's stride is T + 1): 4 MB at T = 1024,
// n = 128, about a microsecond at 3.35 TB/s, so the launch dominates.
//
// The factors may be a strided view: matrix (a, b) of an [n1, n2, T, T]
// view starts at l + a*s1 + b*s2, its rows ld apart (the posterior and
// prior halves of the stacked bank are such views).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
diag_logdet_kernel(const float* __restrict__ l, long long s1, long long s2,
                   int n2, int ld, int t, int n, float* __restrict__ out) {
  const int m = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (m >= n) return;
  const float* lm = l + (long long)(m / n2) * s1 + (long long)(m % n2) * s2;
  float s = 0.0f;
  for (int i = lane; i < t; i += 32) s += logf(lm[(size_t)i * (ld + 1)]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
  }
  if (lane == 0) out[m] = 2.0f * s;
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
  const int blocks = (int)((n + kWarps - 1) / kWarps);
  diag_logdet_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)l, s1, s2, n2, ld, t, (int)n, (float*)out);
  return (int)cudaGetLastError();
}

const char* gpvae_cuda_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
