// Cholesky factor, and on request its inverse, of a batch of SPD blocks
// of side t <= 128, one thread block per matrix.
//
// Replaces the TPU kernels that factor the diagonal blocks of the large-T
// covariance path (gpvae_tpu/ops/pallas_chol.py, pallas_big.py):
//   _chol_inv_kernel (B3), _make_gram_chol_inv_kernel (B4) and _chol_kernel
//   (B5), the 64-wide lane factorizations; _schur64_kernel (B6),
//   _make_gram_schur_kernel (B7) and _inv21_kernel (B8), the glue that
//   joins two 64-wide halves into a 128-wide block; _assemble128_l_kernel
//   (B21) and _slice11_jit (B22), which assemble and copy the halves; and
//   _init0_parts_kernel (B11) and _diag_parts_kernel (B12), which write the
//   finished diagonal block into the big factor.
// On the TPU a 128-wide block is split in two because the lane kernels
// hold at most 64 rows; here the whole block sits in shared memory, so
// there are no halves to join, copy or assemble.
//
// Input, one of two modes:
//   (a) gram: the block is built from times/mask [n, t] (row stride
//       vec_stride) and ls/var [n], gram.cuh semantics;
//   (b) a pre-built block read at a row stride, e.g. the diagonal block of
//       the panel that gram_panel.cu left inside the big factor.  Only the
//       lower triangle is read.
// Output: L (zeros above the diagonal) written at a row stride, which may
// be the very place mode (b) read from; optionally X = L^{-1} into a
// contiguous [n, t, t] buffer.
//
// What bounds it on Hopper: the column recurrence is serial, t steps with
// a barrier each, and a block holds t^3/3 = 0.7 MFLOP at t = 128, so it is
// latency-bound; a batch of 128 blocks fills one wave of the 132 SMs.  The
// block (128 x 129 floats = 66 KB, and as much again for X) lives in
// dynamic shared memory; 512 threads update the trailing triangle, each
// owning a column k and every fourth row, so a warp reads one broadcast
// L[i, j] and 32 consecutive a[i, k] per step.  The inverse is a forward
// substitution with one thread per column and four partial sums.
//
// Numerics follow _chol_lane_body and _chol_inv_body_flat:
// d_j = rsqrt(a_jj), L[:, j] = a[:, j] d_j, and row j of X is
// (e_j - L[j, :j] X[:j]) d_j.  The TPU kernels floor a_jj at 1e-20; this
// one does not, so a block that is not positive definite in float32 gets
// NaN (a negative pivot) or inf/NaN (a zero one) from that column on, as
// the library factorization the JAX package takes off the TPU gives NaN,
// where the floor would give finite garbage.

#include <cuda_runtime.h>

#include "gram.cuh"

namespace {

constexpr int kMaxT = 128;
constexpr int kPitch = kMaxT + 1;  // row pitch of the shared matrices
constexpr int kThreads = 512;
constexpr int kGroups = kThreads / kMaxT;  // rows a column's threads split
// dinv, times and mask, then the block, then X
constexpr int kSmallFloats = 3 * kMaxT;
constexpr size_t kMaxSmem =
    (kSmallFloats + 2 * (size_t)kMaxT * kPitch) * sizeof(float);

struct Params {
  // mode (b)
  const float* src;
  long long src_mat;  // elements between matrices
  int src_row;        // elements between rows
  // mode (a)
  const float* times;
  const float* mask;
  const float* ls;
  const float* var;
  int vec_stride;
  int code;
  float noise;
  float one_minus_noise;
  // outputs
  float* l;
  long long l_mat;
  int l_row;
  float* inv;  // [n, t, t] contiguous, or null
  int t;
};

template <bool kGram>
__global__ void __launch_bounds__(kThreads) chol_block_kernel(Params p) {
  extern __shared__ float smem[];
  float* dinv = smem;
  float* tt = smem + kMaxT;
  float* mk = smem + 2 * kMaxT;
  float* a = smem + kSmallFloats;   // [t][kPitch]
  float* x = a + p.t * kPitch;      // [t][kPitch], only with p.inv

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int t = p.t;

  // -- load the lower triangle -------------------------------------------
  if (kGram) {
    const size_t base = (size_t)n * p.vec_stride;
    for (int i = tid; i < t; i += kThreads) {
      tt[i] = p.times[base + i];
      mk[i] = p.mask[base + i];
    }
    __syncthreads();
    const float lsn = p.ls[n];
    const float varn = p.var[n];
    for (int idx = tid; idx < t * t; idx += kThreads) {
      const int i = idx / t;
      const int k = idx - i * t;
      if (k > i) continue;
      a[i * kPitch + k] = gpvae::gram_value(p.code, tt[i], tt[k], mk[i],
                                            mk[k], lsn, varn, p.noise,
                                            p.one_minus_noise, i == k);
    }
  } else {
    const float* s = p.src + (size_t)n * p.src_mat;
    for (int idx = tid; idx < t * t; idx += kThreads) {
      const int i = idx / t;
      const int k = idx - i * t;
      if (k <= i) a[i * kPitch + k] = s[(size_t)i * p.src_row + k];
    }
  }

  // -- column recurrence ---------------------------------------------------
  // Step j reads column j (final since step j - 1) and updates the trailing
  // lower triangle, columns j+1 .. t-1, so one barrier a step suffices.
  const int k = tid % kMaxT;
  const int g = tid / kMaxT;
  for (int j = 0; j < t; ++j) {
    __syncthreads();
    const float d = rsqrtf(a[j * kPitch + j]);
    if (tid == 0) dinv[j] = d;
    if (k > j && k < t) {
      const float ck = a[k * kPitch + j] * d;
      for (int i = j + 1 + g; i < t; i += kGroups) {
        if (k <= i) a[i * kPitch + k] -= (a[i * kPitch + j] * d) * ck;
      }
    }
  }
  __syncthreads();

  // -- L out: column k scaled by dinv[k], zeros above the diagonal --------
  float* lo = p.l + (size_t)n * p.l_mat;
  for (int idx = tid; idx < t * t; idx += kThreads) {
    const int i = idx / t;
    const int c = idx - i * t;
    const float v = (c <= i) ? a[i * kPitch + c] * dinv[c] : 0.0f;
    a[i * kPitch + c] = v;  // each element read and written by one thread
    lo[(size_t)i * p.l_row + c] = v;
  }
  if (p.inv == nullptr) return;
  __syncthreads();

  // -- X = L^{-1}: thread c owns column c ----------------------------------
  // X[j, c] = (delta_jc - sum_{i<j} L[j, i] X[i, c]) d_j.  X[i, c] = 0 for
  // i < c, so the sum starts at the warp's first column: every lane walks
  // the same i, and each L[j, i] read is a broadcast.
  if (tid < t) {
    const int c = tid;
    const int c0 = tid & ~31;
    for (int j = 0; j < t; ++j) {
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
      const float* lj = a + j * kPitch;
      int i = c0;
      for (; i + 3 < j; i += 4) {
        s0 = fmaf(lj[i], x[i * kPitch + c], s0);
        s1 = fmaf(lj[i + 1], x[(i + 1) * kPitch + c], s1);
        s2 = fmaf(lj[i + 2], x[(i + 2) * kPitch + c], s2);
        s3 = fmaf(lj[i + 3], x[(i + 3) * kPitch + c], s3);
      }
      for (; i < j; ++i) s0 = fmaf(lj[i], x[i * kPitch + c], s0);
      const float delta = (j == c) ? 1.0f : 0.0f;
      x[j * kPitch + c] =
          (j < c) ? 0.0f : (delta - ((s0 + s1) + (s2 + s3))) * dinv[j];
    }
  }
  __syncthreads();
  float* xo = p.inv + (size_t)n * t * t;
  for (int idx = tid; idx < t * t; idx += kThreads) {
    const int i = idx / t;
    const int c = idx - i * t;
    xo[idx] = x[i * kPitch + c];
  }
}

template <bool kGram>
int launch(const Params& p, int n, void* stream) {
  if (n <= 0) return 0;
  if (p.t < 1 || p.t > kMaxT) return (int)cudaErrorInvalidValue;
  // above 48 KB a block may use dynamic shared memory only after this
  const cudaError_t e = cudaFuncSetAttribute(
      chol_block_kernel<kGram>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kMaxSmem);
  if (e != cudaSuccess) return (int)e;
  const size_t smem =
      (kSmallFloats + (p.inv ? 2 : 1) * (size_t)p.t * kPitch) * sizeof(float);
  chol_block_kernel<kGram><<<n, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Mode (b).  src: matrix m's element (i, k) at src[m*src_mat + i*src_row
// + k]; l likewise with l_mat/l_row (l may equal src); inv: [n, t, t]
// contiguous or null.  All float32 on the device.  Launches on `stream`
// and returns the cudaError_t of the launch (0 on success).
int gpvae_chol_block_f32(const void* src, long long src_mat, int src_row,
                         void* l, long long l_mat, int l_row, void* inv,
                         int n, int t, void* stream) {
  Params p = {};
  p.src = (const float*)src;
  p.src_mat = src_mat;
  p.src_row = src_row;
  p.l = (float*)l;
  p.l_mat = l_mat;
  p.l_row = l_row;
  p.inv = (float*)inv;
  p.t = t;
  return launch<false>(p, n, stream);
}

// Mode (a).  times, mask: matrix m's vector at times[m*vec_stride], t
// entries; ls, var: [n]; outputs as above.
int gpvae_gram_chol_block_f32(const void* times, const void* mask,
                              const void* ls, const void* var,
                              int vec_stride, int code, float noise,
                              float one_minus_noise, void* l, long long l_mat,
                              int l_row, void* inv, int n, int t,
                              void* stream) {
  if (!gpvae::valid_kernel_code(code)) return (int)cudaErrorInvalidValue;
  Params p = {};
  p.times = (const float*)times;
  p.mask = (const float*)mask;
  p.ls = (const float*)ls;
  p.var = (const float*)var;
  p.vec_stride = vec_stride;
  p.code = code;
  p.noise = noise;
  p.one_minus_noise = one_minus_noise;
  p.l = (float*)l;
  p.l_mat = l_mat;
  p.l_row = l_row;
  p.inv = (float*)inv;
  p.t = t;
  return launch<true>(p, n, stream);
}

const char* gpvae_cuda_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
