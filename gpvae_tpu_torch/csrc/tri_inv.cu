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
// of its serial chain.  X is computed by a column sweep, the order of a
// forward substitution against the identity:
//   1. L's lower triangle goes into shared memory column-major by
//      chol_tile.cuh's fill_lower (4 x 8 chunks, every row's loads in
//      flight at once), and d_j = 1 / L[j][j] by IEEE division (as the TPU
//      kernel divides) into the slot under each column;
//   2. sweep: four lanes of a warp (a quad) own a column c of X, lane g
//      holding rows m = 4 r + g in registers.  At step j the lane holding
//      row j scales it by d_j and hands x_j = X[j][c] to its quad by one
//      shuffle, and every lane subtracts L[m][j] x_j from its rows below
//      j, one fma each.  The chain is one shuffle and one fma a step; the
//      updates of a step are independent;
//   3. store_inverse writes X whole, zeros above the diagonal, a row a
//      warp.
// Each entry X[m][c] is d_m (delta_mc - sum_{j<m} L[m][j] X[j][c]) with
// the terms subtracted one by one in j order: the summation order of the
// library's substitution (the CPU's float32 solve_triangular(L, I) to the
// bit, tests/test_torch_chol_order.py).  chol_tile.cuh's invert (the
// diagonal tiles, then recursive doubling X_21 = -X_22 (L_21 X_11)), which
// this kernel used before, missed float64 by 25x the library's float32
// error on FITC's factor of B = I + V0 V0^T (cond(L) ~ 1e3; 1.0e-4 rel.
// Frobenius on an H100); chol_block.cu keeps it for its inverse mode.
// A block takes one matrix; kThreads = 4 kMaxT, one quad a column.

#include <cuda_runtime.h>

#include "chol_tile.cuh"

namespace {

namespace ct = gpvae::chol_tile;

constexpr int kMaxT = 64;
constexpr int kLanes = 4;               // lanes a column of X
constexpr int kRows = kMaxT / kLanes;   // rows of the column a lane holds
constexpr int kThreads = kMaxT * kLanes;

// X = L^{-1} of the factor in s (column-major, d_j = 1/L[j][j] in the slot
// s[j * p + p - 1]) into x, row-major: x[m * p + c] = X[m][c] for c <= m <
// t.  Every thread of the block runs every step (t is the block's), so the
// shuffles see whole warps; a quad whose column lies past t computes
// nothing that is stored.
__device__ void sweep(const float* s, float* x, int p, int t) {
  const int c = threadIdx.x / kLanes;
  const int g = threadIdx.x % kLanes;
  const int quad = (threadIdx.x & 31) & ~(kLanes - 1);  // its first lane
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = kLanes * r + g == c ? 1.0f : 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxT; ++j) {
    if (j < t) {
      const float* col = s + j * p;
      const float xj = __shfl_sync(ct::kFull, acc[j / kLanes] * col[p - 1],
                                   quad + j % kLanes);
      if (g == j % kLanes) acc[j / kLanes] = xj;
#pragma unroll
      for (int r = j / kLanes; r < kRows; ++r) {
        const int m = kLanes * r + g;
        if (m > j && m < t) acc[r] = fmaf(-col[m], xj, acc[r]);
      }
    }
  }
  if (c < t) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int m = kLanes * r + g;
      if (m >= c && m < t) x[m * p + c] = acc[r];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
tri_inv_kernel(const float* __restrict__ l, float* __restrict__ out, int t) {
  extern __shared__ __align__(16) float smem[];
  const int p = ct::pitch(t);
  float* s = smem;                // L, column-major
  float* x = s + ct::floats(t);   // X, row-major
  const float* lm = l + (size_t)blockIdx.x * t * t;
  ct::fill_lower<kThreads>(s, p, t, [&](int i, int k) {
    return lm[i * t + k];
  });
  for (int j = threadIdx.x; j < t; j += kThreads) {
    s[j * p + p - 1] = 1.0f / lm[j * t + j];
  }
  __syncthreads();
  sweep(s, x, p, t);
  __syncthreads();
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
