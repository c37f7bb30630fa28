// Batched inverse of small lower-triangular matrices, X = L^{-1}, t <= 64.
//
// Replaces the TPU kernel gpvae_tpu/ops/pallas_tri.py _tri_inv_kernel
// (B2: forward substitution with the batch in the 128-wide lane axis).
// Any side 1 <= t <= 64 is taken as it is: the TPU's padding to 8 rows
// and 128 lanes (pallas_tri.py:240-252) has no counterpart here.
//
// What bounds it on Hopper: a matrix holds t^3/6 multiply-adds (15k at t
// = 45) against t^2 floats (0.00029 ms for the bytes of N = 80 matrices of
// 45 at 3.35 TB/s), so one thread block per matrix is bound by the latency
// of its serial chain.  A column substituted by one thread is a chain of
// t^2/2 dependent fmas with two shared loads each; here the inverse is
// chol_tile.cuh's, the one chol_block.cu computes beside its factor:
//   1. L's lower triangle goes into shared memory column-major by
//      fill_lower (4 x 8 chunks, every row's loads in flight at once), and
//      d_j = 1 / L[j][j] by IEEE division (as the TPU kernel divides) into
//      the slot under each column;
//   2. invert: the diagonal tiles of 16, one warp each, lane c
//      substituting column c from registers; then recursive doubling,
//      X_21 = -X_22 (L_21 X_11), over every thread in 4 x 4 register tiles,
//      two barriers a level (two levels at t = 64);
//   3. store_inverse writes X whole, zeros above the diagonal, a row a
//      warp.
// A block takes one matrix: at syn_data's N = 80 that is 80 blocks, each
// as short as its chain allows.  kThreads = 256: eight warps issue the
// fill's and the store's loads and stores, four take t = 64's diagonal
// tiles at once, and a doubling level has at most 64 register tiles;
// on an H100, at both main-path shapes (N = 80, t = 45, and the T = 1024
// flat route's base call, N = 1,024, t = 64), 256 threads ran faster
// than 128, and 128 faster than 64.

#include <cuda_runtime.h>

#include "chol_tile.cuh"

namespace {

namespace ct = gpvae::chol_tile;

constexpr int kMaxT = 64;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
tri_inv_kernel(const float* __restrict__ l, float* __restrict__ out, int t) {
  extern __shared__ __align__(16) float smem[];
  const int p = ct::pitch(t);
  float* s = smem;                // L, column-major; its upper half scratch
  float* x = s + ct::floats(t);   // X, row-major
  const float* lm = l + (size_t)blockIdx.x * t * t;
  ct::fill_lower<kThreads>(s, p, t, [&](int i, int k) {
    return lm[i * t + k];
  });
  for (int j = threadIdx.x; j < t; j += kThreads) {
    s[j * p + p - 1] = 1.0f / lm[j * t + j];
  }
  __syncthreads();
  ct::invert<kThreads>(s, x, p, t);
  ct::store_inverse<kThreads>(x, p, t, out + (size_t)blockIdx.x * t * t);
}

}  // namespace

extern "C" {

// l, out: [n, t, t] float32, contiguous, on the device.  Only the lower
// triangle of l is read.  Launches on `stream` and returns the
// cudaError_t of the launch (0 on success).
int gpvae_tri_inv_f32(const void* l, void* out, int n, int t, void* stream) {
  if (n <= 0) return 0;
  if (t < 1 || t > kMaxT) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)ct::floats(t) * sizeof(float);
  tri_inv_kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)l, (float*)out, t);
  return (int)cudaGetLastError();
}

const char* gpvae_cuda_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
