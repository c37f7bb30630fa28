// Fused gram construction + Cholesky for a bank of small matrices.
//
// Replaces the TPU kernel gpvae_tpu/ops/pallas_chol.py
// _make_gram_chol_kernel (gram body _gram_lane, factor body
// _chol_lane_body).  For each of N matrices it builds the masked gram
//
//   K = M ((1 - noise) var k(t_i - t_j; ls) + noise I) M + (I - diag m)
//
// (kernels.gram_bank semantics, M = diag m: masked rows and columns become
// identity)
// from the matrix's time vector, factors K = L L^T, and writes lower L with
// zeros above the diagonal.  The gram never exists in device memory: in
// are times/mask [N, T] and ls/var [N], out is L [N, T, T].
//
// What bounds it on Hopper: the column recurrence is serial, T steps with
// a block-wide barrier each, and a matrix holds only a few thousand flops
// (T^3/6, about 15k at T = 45).  So the kernel is latency-bound, never
// bandwidth- or flop-bound.  The design keeps the whole matrix in shared
// memory (T <= 64: 16.6 KB with the bank-conflict pad), one thread block
// per matrix, and spends exactly one __syncthreads() per column: step j
// reads only column j and writes only the columns to its right, so the
// reads and writes of a step never touch the same element.
//
// Numerics follow _chol_lane_body: d = rsqrt(max(a_jj, 1e-20)),
// L[:, j] = a[:, j] * d.  The update a_ik -= c_i c_k may be contracted to
// an fma here, where the TPU rounds the product first.

#include <cuda_runtime.h>

#include "gram.cuh"

namespace {

constexpr int kMaxT = 64;
constexpr int kPitch = kMaxT + 1;  // row pitch of the shared matrix
constexpr int kThreads = 256;
constexpr float kDiagEps = 1e-20f;

__global__ void __launch_bounds__(kThreads)
gram_chol_kernel(const float* __restrict__ times,
                 const float* __restrict__ mask,
                 const float* __restrict__ ls,
                 const float* __restrict__ var,
                 float* __restrict__ out, int t, int code, float noise,
                 float one_minus_noise) {
  __shared__ float a[kMaxT * kPitch];
  __shared__ float tt[kMaxT];
  __shared__ float mk[kMaxT];
  __shared__ float dinv[kMaxT];

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < t) {
    tt[tid] = times[(size_t)n * t + tid];
    mk[tid] = mask[(size_t)n * t + tid];
  }
  const float l = ls[n];
  const float v = var[n];
  __syncthreads();

  // Gram, lower triangle only (the recurrence never reads above it).
  for (int idx = tid; idx < t * t; idx += kThreads) {
    const int i = idx / t;
    const int k = idx - i * t;
    if (k > i) continue;
    a[i * kPitch + k] = gpvae::gram_value(code, tt[i], tt[k], mk[i], mk[k],
                                          l, v, noise, one_minus_noise,
                                          i == k);
  }

  // Column recurrence.  Step j reads column j (final since step j - 1)
  // and updates the trailing lower triangle, columns j+1 .. t-1.
  for (int j = 0; j < t; ++j) {
    __syncthreads();
    const float d = rsqrtf(fmaxf(a[j * kPitch + j], kDiagEps));
    if (tid == 0) dinv[j] = d;
    const int r = t - 1 - j;  // side of the trailing block
    for (int idx = tid; idx < r * r; idx += kThreads) {
      const int ii = idx / r;
      const int kk = idx - ii * r;
      if (kk > ii) continue;
      const int i = j + 1 + ii;
      const int k = j + 1 + kk;
      const float ci = a[i * kPitch + j] * d;
      const float ck = a[k * kPitch + j] * d;
      a[i * kPitch + k] -= ci * ck;
    }
  }
  __syncthreads();

  // Column j of `a` still holds the values step j scaled, so
  // L[i, j] = a[i, j] * dinv[j].  Rows are written whole (coalesced),
  // zeros above the diagonal included: the output is allocated empty.
  float* o = out + (size_t)n * t * t;
  for (int idx = tid; idx < t * t; idx += kThreads) {
    const int i = idx / t;
    const int k = idx - i * t;
    o[idx] = (k <= i) ? a[i * kPitch + k] * dinv[k] : 0.0f;
  }
}

}  // namespace

extern "C" {

// times, mask: [n, t]; ls, var: [n]; out: [n, t, t]; all float32,
// contiguous, on the device.  Launches on `stream` and returns the
// cudaError_t of the launch (0 on success).
int gpvae_gram_chol_f32(const void* times, const void* mask, const void* ls,
                        const void* var, void* out, int n, int t, int code,
                        float noise, float one_minus_noise, void* stream) {
  if (n <= 0) return 0;
  if (t < 1 || t > kMaxT || !gpvae::valid_kernel_code(code)) {
    return (int)cudaErrorInvalidValue;
  }
  gram_chol_kernel<<<n, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)times, (const float*)mask, (const float*)ls,
      (const float*)var, (float*)out, t, code, noise, one_minus_noise);
  return (int)cudaGetLastError();
}

const char* gpvae_cuda_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
