// Batched inverse of small lower-triangular matrices, X = L^{-1}.
//
// Replaces the TPU kernel gpvae_tpu/ops/pallas_tri.py _tri_inv_kernel
// (forward substitution with the batch in the 128-wide lane axis).  Here
// one thread block takes one matrix: L goes into shared memory, and
// thread c owns column c of X,
//
//   X[j, c] = (delta_jc - sum_{i < j} L[j, i] X[i, c]) / L[j, j],
//
// for j = c .. t-1; X[j, c] = 0 above the diagonal.  Columns are
// independent, so after the load no barrier is needed.  Any side
// 1 <= t <= 64 is taken as it is: the TPU's padding to 8 rows and 128
// lanes (pallas_tri.py:240-252) has no counterpart here.
//
// What bounds it on Hopper: the substitution is serial in j, t steps of a
// dot product of growing length, t^3/6 multiply-adds per matrix (15k at
// t = 45; the uniform loop below spends t^3/2 to keep the warp in step).
// It is latency-bound.  All threads of a warp read the same L[j, i] (a
// shared-memory broadcast) and neighbouring columns of X (distinct banks),
// and the output rows are written coalesced.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxT = 64;
constexpr int kPitch = kMaxT + 1;

__global__ void __launch_bounds__(kMaxT)
tri_inv_kernel(const float* __restrict__ l, float* __restrict__ out, int t) {
  __shared__ float ls[kMaxT * kPitch];
  __shared__ float xs[kMaxT * kPitch];

  const int n = blockIdx.x;
  const int c = threadIdx.x;  // the column this thread owns
  const float* lm = l + (size_t)n * t * t;
  // load L row by row: thread c reads element (j, c), coalesced
  for (int j = 0; j < t; ++j) {
    if (c < t) ls[j * kPitch + c] = lm[(size_t)j * t + c];
  }
  __syncthreads();

  if (c < t) {
    // Every thread walks the same (j, i) sequence, so each L[j, i] read
    // is a broadcast; X[i, c] = 0 for i < c makes the full sum exact, as
    // in the TPU kernel.
    for (int j = 0; j < t; ++j) {
      float acc = 0.0f;
      for (int i = 0; i < j; ++i) {
        acc = fmaf(ls[j * kPitch + i], xs[i * kPitch + c], acc);
      }
      const float delta = (j == c) ? 1.0f : 0.0f;
      xs[j * kPitch + c] = (j < c) ? 0.0f : (delta - acc) / ls[j * kPitch + j];
    }
    float* o = out + (size_t)n * t * t;
    for (int j = 0; j < t; ++j) o[(size_t)j * t + c] = xs[j * kPitch + c];
  }
}

}  // namespace

extern "C" {

// l, out: [n, t, t] float32, contiguous, on the device.  Only the lower
// triangle of l is read.  Launches on `stream` and returns the
// cudaError_t of the launch (0 on success).
int gpvae_tri_inv_f32(const void* l, void* out, int n, int t, void* stream) {
  if (n <= 0) return 0;
  if (t < 1 || t > kMaxT) return (int)cudaErrorInvalidValue;
  tri_inv_kernel<<<n, kMaxT, 0, (cudaStream_t)stream>>>(
      (const float*)l, (float*)out, t);
  return (int)cudaGetLastError();
}

const char* gpvae_cuda_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
