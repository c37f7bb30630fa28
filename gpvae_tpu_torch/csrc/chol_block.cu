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
// What bounds it on Hopper: a block holds t^3/3 = 0.7 MFLOP at t = 128,
// so it is bound by the latency of its serial chain; a batch of 128 blocks
// fills one wave of the 132 SMs.  The factorization and the inverse are
// chol_tile.cuh's: panels of 16 columns, each a warp-register diagonal
// tile, the rows below solved one a thread and a register-tiled
// trailing update, three barriers a panel; then X's diagonal tiles one a
// warp and the blocks below by recursive doubling over all 512 threads,
// two barriers a level.  The block (128 columns of pitch 132: 66 KB) and
// X (as much again) live in dynamic shared memory.
//
// Numerics: d_j = rsqrt(a_jj), L[:, j] = a[:, j] d_j, X's diagonal tiles
// by substitution with the same d_j.  The TPU kernels floor a_jj at 1e-20;
// this one does not, so a block that is not positive definite in float32
// gets NaN (a negative pivot) or inf/NaN (a zero one) from that column on,
// as the library factorization the JAX package takes off the TPU gives
// NaN, where the floor would give finite garbage.

#include <cuda_runtime.h>

#include "chol_tile.cuh"
#include "gram.cuh"

namespace {

namespace ct = gpvae::chol_tile;

constexpr int kMaxT = 128;
constexpr int kThreads = 512;
constexpr size_t kMaxSmem = 2 * (size_t)ct::floats(kMaxT) * sizeof(float);

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

template <bool kGram, bool kInverse>
__global__ void __launch_bounds__(kThreads) chol_block_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int n = blockIdx.x;
  const int t = p.t;
  const int pitch = ct::pitch(t);
  float* s = smem;                   // L, column-major
  float* x = s + ct::floats(t);      // X, row-major (kInverse)

  if (kGram) {
    const float* tt = p.times + (size_t)n * p.vec_stride;
    const float* mk = p.mask + (size_t)n * p.vec_stride;
    const float l = p.ls[n];
    const float v = p.var[n];
    ct::fill_lower<kThreads>(s, pitch, t, [&](int i, int k) {
      return gpvae::gram_value(p.code, tt[i], tt[k], mk[i], mk[k], l, v,
                               p.noise, p.one_minus_noise, i == k);
    });
  } else {
    const float* a = p.src + (size_t)n * p.src_mat;
    ct::fill_lower<kThreads>(s, pitch, t, [&](int i, int k) {
      return a[(size_t)i * p.src_row + k];
    });
  }
  ct::factor<false, kThreads>(s, pitch, t);
  ct::store_lower<kThreads>(s, pitch, t, p.l + (size_t)n * p.l_mat,
                            p.l_row);
  if (kInverse) {
    ct::invert<kThreads>(s, x, pitch, t);
    ct::store_inverse<kThreads>(x, pitch, t, p.inv + (size_t)n * t * t);
  }
}

template <bool kGram, bool kInverse>
int launch_as(const Params& p, int n, void* stream) {
  auto kernel = chol_block_kernel<kGram, kInverse>;
  // above 48 KB a block may use dynamic shared memory only after this
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (kInverse ? 2 : 1) * (size_t)ct::floats(p.t) *
                      sizeof(float);
  kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool kGram>
int launch(const Params& p, int n, void* stream) {
  if (n <= 0) return 0;
  if (p.t < 1 || p.t > kMaxT) return (int)cudaErrorInvalidValue;
  return p.inv ? launch_as<kGram, true>(p, n, stream)
               : launch_as<kGram, false>(p, n, stream);
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
