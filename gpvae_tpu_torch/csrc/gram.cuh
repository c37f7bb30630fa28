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

__device__ __forceinline__ float kernel_value(int code, float dt, float ls) {
  switch (code) {
    case kRbf: {
      const float z = dt / ls;
      return expf(-0.5f * z * z);
    }
    case kMatern12:
      return expf(-fabsf(dt) / ls);
    case kMatern32: {
      const float z = sqrtf(3.0f) * fabsf(dt) / ls;
      return (1.0f + z) * expf(-z);
    }
    case kMatern52: {
      const float z = sqrtf(5.0f) * fabsf(dt) / ls;
      return (1.0f + z + z * z / 3.0f) * expf(-z);
    }
    case kCauchy: {
      const float z = dt / ls;
      return 1.0f / (1.0f + z * z);
    }
    default:  // kCosine
      return cosf(dt / ls);
  }
}

__device__ __forceinline__ float gram_value(int code, float ti, float tk,
                                            float mi, float mk, float ls,
                                            float var, float noise,
                                            float one_minus_noise,
                                            bool diag) {
  const float eye = diag ? 1.0f : 0.0f;
  float g = var * kernel_value(code, ti - tk, ls);
  g = one_minus_noise * g + noise * eye;
  return g * (mi * mk) + (1.0f - mi) * eye;
}

}  // namespace gpvae
