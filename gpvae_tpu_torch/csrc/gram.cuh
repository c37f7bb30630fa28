// One element of the masked gram bank, shared by every kernel that builds
// K from the time vectors instead of reading it from device memory
// (gram_chol.cu, chol_block.cu, gram_panel.cu).
//
//   K[i, k] = ((1 - noise) var k(t_i - t_k; ls) + noise [i == k]) m_i m_k
//             + (1 - m_i) [i == k]
//
// which is kernels.gram_bank of the Python package: masked rows and
// columns become identity.  `diag` says whether (i, k) lies on the main
// diagonal of the whole matrix, not of a tile.
#pragma once

#include <cuda_runtime.h>

namespace gpvae {

// kernel codes, in the order of gpvae_tpu_torch.kernels.KERNEL_CODES
enum KernelCode : int {
  kRbf = 0,
  kMatern12 = 1,
  kMatern32 = 2,
  kMatern52 = 3,
  kCauchy = 4,
  kCosine = 5,
};

inline bool valid_kernel_code(int code) {
  return code >= kRbf && code <= kCosine;
}

// k(t_i - t_k; ls) from the float32 times and lengthscale, computed in
// float64 and rounded once.  In float32 the exponent's rounding is
// amplified by its size (up to ~20 on a prior of lengthscale 9 over
// 0 .. 60) and expf adds up to 2 ulp; an ill-conditioned prior gram
// carries that into the lengthscale gradient through the KL, where it
// cost 2.3x the CPU's float32 gram on an H100.  The float64 work is a
// few dozen instructions an element, in the kernels' epilogues.
__device__ __forceinline__ float kernel_value(int code, float ti, float tk,
                                              float ls) {
  const double dt = static_cast<double>(ti) - static_cast<double>(tk);
  const double l = ls;
  switch (code) {
    case kRbf: {
      const double z = dt / l;
      return static_cast<float>(exp(-0.5 * z * z));
    }
    case kMatern12:
      return static_cast<float>(exp(-fabs(dt) / l));
    case kMatern32: {
      const double z = sqrt(3.0) * fabs(dt) / l;
      return static_cast<float>((1.0 + z) * exp(-z));
    }
    case kMatern52: {
      const double z = sqrt(5.0) * fabs(dt) / l;
      return static_cast<float>((1.0 + z + z * z / 3.0) * exp(-z));
    }
    case kCauchy: {
      const double z = dt / l;
      return static_cast<float>(1.0 / (1.0 + z * z));
    }
    default:  // kCosine
      return static_cast<float>(cos(dt / l));
  }
}

__device__ __forceinline__ float gram_value(int code, float ti, float tk,
                                            float mi, float mk, float ls,
                                            float var, float noise,
                                            float one_minus_noise,
                                            bool diag) {
  const float eye = diag ? 1.0f : 0.0f;
  float g = var * kernel_value(code, ti, tk, ls);
  g = one_minus_noise * g + noise * eye;
  return g * (mi * mk) + (1.0f - mi) * eye;
}

}  // namespace gpvae
