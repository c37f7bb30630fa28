// Fused gram construction + Cholesky for a bank of small matrices.
//
// Replaces the TPU kernel gpvae_tpu/ops/pallas_chol.py
// _make_gram_chol_kernel (gram body _gram_lane, factor body
// _chol_lane_body).  For each of the N = B * Z matrices of the bank it
// builds the masked gram
//
//   K = M ((1 - noise) var k(t_i - t_j; ls) + noise I) M + (I - diag m)
//
// (kernels.gram_bank semantics, M = diag m: masked rows and columns become
// identity) from the time vector of its sequence, factors K = L L^T, and
// writes lower L with zeros above the diagonal.  The gram never exists in
// device memory.
//
// The bank is read as gram_chol_fused receives it, so the call is this one
// launch: matrix n is latent z = n % Z of sequence b = n / Z; times [B, T]
// and the mask [B, T] (bool bytes, float32, or none) at their row strides,
// ls [Z] or [B, Z] and var (a scalar, [Z], or a value) at their strides.
// A flat bank (times, mask [N, T], ls, var [N]) is the case Z = 1.
//
// What bounds it on Hopper: a matrix holds about 15k flops (T = 45), so
// one thread block per matrix is bound by latency.  The factorization is
// chol_tile.cuh's panel-blocked recurrence (a warp-register diagonal tile,
// three barriers a panel) on the whole matrix in shared memory (T <= 64:
// 17 KB), with the TPU kernel's pivot floor.

#include <cuda_runtime.h>

#include "chol_tile.cuh"
#include "gram.cuh"

namespace {

namespace ct = gpvae::chol_tile;

constexpr int kMaxT = 64;
constexpr int kThreads = 128;

enum MaskKind : int { kNoMask = 0, kBoolMask = 1, kFloatMask = 2 };

struct Params {
  const float* times;
  long long times_row;  // elements between sequences
  const void* mask;     // kMaskKind: bytes or float32; null: all observed
  long long mask_row;
  int mask_kind;
  const float* ls;
  long long ls_b, ls_z;  // element (b, z) at ls[b * ls_b + z * ls_z]
  const float* var;      // likewise, or null: var_value
  long long var_b, var_z;
  float var_value;
  float* out;  // [N, T, T]
  int z;
  int t;
  int code;
  float noise;
  float one_minus_noise;
};

__device__ __forceinline__ float mask_at(const Params& p, long long i) {
  if (p.mask_kind == kBoolMask) {
    return static_cast<const unsigned char*>(p.mask)[i] ? 1.0f : 0.0f;
  }
  if (p.mask_kind == kFloatMask) return static_cast<const float*>(p.mask)[i];
  return 1.0f;
}

__global__ void __launch_bounds__(kThreads) gram_chol_kernel(Params p) {
  __shared__ __align__(16) float s[ct::floats(kMaxT)];
  const int n = blockIdx.x;
  const int b = n / p.z;
  const int zi = n - b * p.z;
  const int t = p.t;
  const int pitch = ct::pitch(t);
  const float* tt = p.times + b * p.times_row;
  const long long mrow = b * p.mask_row;
  const float l = p.ls[b * p.ls_b + zi * p.ls_z];
  const float v = p.var ? p.var[b * p.var_b + zi * p.var_z] : p.var_value;
  ct::fill_lower<kThreads>(s, pitch, t, [&](int i, int k) {
    return gpvae::gram_value(p.code, tt[i], tt[k], mask_at(p, mrow + i),
                             mask_at(p, mrow + k), l, v, p.noise,
                             p.one_minus_noise, i == k);
  });
  ct::factor<true, kThreads>(s, pitch, t);
  ct::store_lower<kThreads>(s, pitch, t, p.out + (size_t)n * t * t, t);
}

}  // namespace

extern "C" {

// The bank as described above; out: [n, t, t] float32, n = B * z.
// Launches on `stream` and returns the
// cudaError_t of the launch (0 on success).
int gpvae_gram_chol_f32(const void* times, long long times_row,
                        const void* mask, long long mask_row, int mask_kind,
                        const void* ls, long long ls_b, long long ls_z,
                        const void* var, long long var_b, long long var_z,
                        float var_value, void* out, int n, int z, int t,
                        int code, float noise, float one_minus_noise,
                        void* stream) {
  if (n <= 0) return 0;
  if (t < 1 || t > kMaxT || z < 1 || n % z != 0 ||
      !gpvae::valid_kernel_code(code) || mask_kind < kNoMask ||
      mask_kind > kFloatMask || (mask_kind != kNoMask) != (mask != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.times = (const float*)times;
  p.times_row = times_row;
  p.mask = mask;
  p.mask_row = mask_row;
  p.mask_kind = mask_kind;
  p.ls = (const float*)ls;
  p.ls_b = ls_b;
  p.ls_z = ls_z;
  p.var = (const float*)var;
  p.var_b = var_b;
  p.var_z = var_z;
  p.var_value = var_value;
  p.out = (float*)out;
  p.z = z;
  p.t = t;
  p.code = code;
  p.noise = noise;
  p.one_minus_noise = one_minus_noise;
  gram_chol_kernel<<<n, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

const char* gpvae_cuda_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
