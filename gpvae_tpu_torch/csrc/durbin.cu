// The Durbin (Levinson) recursion of symmetric positive definite Toeplitz
// matrices, one thread block a matrix, in float64.
//
// Replaces no Pallas kernel: the JAX package runs the recursion under XLA,
// as a lax.scan of T - 1 steps (gpvae_tpu/toeplitz.py:88 _durbin_scan) or
// as a blocked Schur/Durbin whose float32 error needed compensated
// arithmetic (:386 _durbin_schur_blocked).  As eager PyTorch ops each of
// the T - 1 sequential steps costs several launches, thousands a call at
// T = 1024; here the whole chain runs inside one block.
//
// Input: rho [n, T - 1], each matrix's first row over its first entry
// (normalized autocovariances).  Output per matrix: sum_k log E_k (the
// logdet of the normalized matrix), the Yule-Walker solution y [T - 1]
// (a = (1, y) is the Gohberg-Semencul vector) and the final normalized
// prediction error E_{T-1}.
//
// The split Schur-Levinson form (toeplitz.py:386-417): the Szego pair
//     a' = a + alpha Z b,   b' = Z b + alpha a      (Z: shift down by one)
// and its rho-images s, t, which follow the same recursion, start from
// s = t = (1, rho), a = b = e_0.  Step k reads only s[k] and t[k-1]:
//     alpha_k = -s[k] / t[k-1],
// so a step needs no reduction, only a broadcast and a one-lag shift.
// Each thread keeps P consecutive lags of s, t, a, b in registers; the
// shift takes the previous thread's last t and b by a warp shuffle, or at
// a warp's first lane from a shared slot.  The owners of s[k+1] and t[k]
// write them to shared memory after their update, and every thread forms
// alpha itself: one __syncthreads a step, the slots double-buffered by the
// step's parity.  The prediction errors are summed in log space,
// log E_k = sum_{j<=k} log1p(-alpha_j^2), as the JAX package's blocked
// path does; alpha is clamped 8 ulps inside (-1, 1) (_clamp_alpha).
//
// What bounds it on Hopper: the chain of T - 1 dependent steps, each a
// barrier, a shared-memory broadcast, a float64 division and a few FMAs;
// not bytes (8 T a matrix) and not operations (4 T^2 FMAs a matrix).
// durbin_chain_kernel runs the same T - 1 barriers and broadcasts with no
// arithmetic: its time is the chain's floor on the card.
//
// Lags per thread P in {1, 2, 4, 8, 16}, threads a block <= 256: T <= 4096.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxLagsPerThread = 16;
constexpr int kMaxWarps = kMaxThreads / 32;

struct Slots {
  double s_k;     // s[k] of the next step
  double t_km1;   // t[k-1] of the next step
  double edge_t[kMaxWarps];  // each warp's last lane's last t and b
  double edge_b[kMaxWarps];
};

template <int P>
__global__ void __launch_bounds__(kMaxThreads)
durbin_kernel(const double* __restrict__ rho, int t1,
              double* __restrict__ sum_log_e, double* __restrict__ y,
              double* __restrict__ e_out) {
  __shared__ Slots slots[2];
  const int t = t1 + 1;
  const long long row = blockIdx.x;
  const double* r = rho + row * t1;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int base = threadIdx.x * P;
  const double lim = 1.0 - 8.0 * 2.220446049250313e-16;

  double s[P], tt[P], a[P], b[P];
#pragma unroll
  for (int m = 0; m < P; ++m) {
    const int j = base + m;
    const double v = j == 0 ? 1.0 : (j < t ? r[j - 1] : 0.0);
    s[m] = v;
    tt[m] = v;
    a[m] = j == 0 ? 1.0 : 0.0;
    b[m] = a[m];
  }
  // the slots step 1 reads: s[1] and t[0]
#pragma unroll
  for (int m = 0; m < P; ++m) {
    if (base + m == 1) slots[1].s_k = s[m];
    if (base + m == 0) slots[1].t_km1 = tt[m];
  }
  if (lane == 31) {
    slots[1].edge_t[warp] = tt[P - 1];
    slots[1].edge_b[warp] = b[P - 1];
  }

  double log_e = 0.0, acc = 0.0;
  for (int k = 1; k < t; ++k) {
    __syncthreads();
    const Slots& in = slots[k & 1];
    double alpha = -in.s_k / in.t_km1;
    // a NaN stays NaN, as in the plain version's clamp
    alpha = alpha > lim ? lim : (alpha < -lim ? -lim : alpha);
    // the previous thread's last lags, before this step's update
    double t_prev = __shfl_up_sync(0xffffffffu, tt[P - 1], 1);
    double b_prev = __shfl_up_sync(0xffffffffu, b[P - 1], 1);
    if (lane == 0) {
      t_prev = warp > 0 ? in.edge_t[warp - 1] : 0.0;
      b_prev = warp > 0 ? in.edge_b[warp - 1] : 0.0;
    }
    // from the last lag down: lag m - 1 is still the old value at m
#pragma unroll
    for (int m = P - 1; m >= 0; --m) {
      const double tz = m > 0 ? tt[m - 1] : t_prev;
      const double bz = m > 0 ? b[m - 1] : b_prev;
      const double s0 = s[m], a0 = a[m];
      s[m] = fma(alpha, tz, s0);
      tt[m] = fma(alpha, s0, tz);
      a[m] = fma(alpha, bz, a0);
      b[m] = fma(alpha, a0, bz);
    }
    log_e += log1p(-alpha * alpha);
    acc += log_e;
    Slots& out = slots[(k + 1) & 1];
#pragma unroll
    for (int m = 0; m < P; ++m) {
      if (base + m == k + 1) out.s_k = s[m];
      if (base + m == k) out.t_km1 = tt[m];
    }
    if (lane == 31) {
      out.edge_t[warp] = tt[P - 1];
      out.edge_b[warp] = b[P - 1];
    }
  }
#pragma unroll
  for (int m = 0; m < P; ++m) {
    const int j = base + m;
    if (j >= 1 && j < t) y[row * t1 + j - 1] = a[m];
  }
  if (threadIdx.x == 0) {
    sum_log_e[row] = acc;
    e_out[row] = exp(log_e);
  }
}

// The chain alone: the same T - 1 barriers and double-buffered broadcasts,
// each step's value the previous one's, no arithmetic.
__global__ void __launch_bounds__(kMaxThreads)
durbin_chain_kernel(int t1, double* __restrict__ out) {
  __shared__ double slot[2];
  if (threadIdx.x == 0) slot[1] = 1.0;
  double v = 0.0;
  for (int k = 1; k <= t1; ++k) {
    __syncthreads();
    v = slot[k & 1];
    if (threadIdx.x == (k % blockDim.x)) slot[(k + 1) & 1] = v;
  }
  if (threadIdx.x == 0) out[blockIdx.x] = v;
}

template <int P>
int launch(const double* rho, int n, int t1, double* sum_log_e, double* y,
           double* e, cudaStream_t stream) {
  const int t = t1 + 1;
  const int threads = ((t + P - 1) / P + 31) / 32 * 32;
  durbin_kernel<P><<<(unsigned)n, threads, 0, stream>>>(rho, t1, sum_log_e,
                                                         y, e);
  return (int)cudaGetLastError();
}

int lags_per_thread(int t) {
  int p = 1;
  while (p < kMaxLagsPerThread && p * kMaxThreads < t) p *= 2;
  return p;
}

}  // namespace

extern "C" {

// rho: [n, t1] float64 on the device, contiguous; sum_log_e, e: [n];
// y: [n, t1].  Launches on `stream` and returns the cudaError_t of the
// launch (cudaErrorInvalidValue for t1 + 1 > 4096).
int gpvae_durbin_f64(const void* rho, int n, int t1, void* sum_log_e,
                     void* y, void* e, void* stream) {
  if (n <= 0) return 0;
  if (t1 < 0 || t1 + 1 > kMaxThreads * kMaxLagsPerThread || n > (1 << 30))
    return (int)cudaErrorInvalidValue;
  const double* r = (const double*)rho;
  double* s = (double*)sum_log_e;
  double* yy = (double*)y;
  double* ee = (double*)e;
  cudaStream_t st = (cudaStream_t)stream;
  switch (lags_per_thread(t1 + 1)) {
    case 1: return launch<1>(r, n, t1, s, yy, ee, st);
    case 2: return launch<2>(r, n, t1, s, yy, ee, st);
    case 4: return launch<4>(r, n, t1, s, yy, ee, st);
    case 8: return launch<8>(r, n, t1, s, yy, ee, st);
    default: return launch<16>(r, n, t1, s, yy, ee, st);
  }
}

// The chain floor of gpvae_durbin_f64 at the same n, t1 and block size:
// out [n] float64.
int gpvae_durbin_chain_f64(int n, int t1, void* out, void* stream) {
  if (n <= 0) return 0;
  if (t1 < 0 || t1 + 1 > kMaxThreads * kMaxLagsPerThread || n > (1 << 30))
    return (int)cudaErrorInvalidValue;
  const int p = lags_per_thread(t1 + 1);
  const int threads = ((t1 + 1 + p - 1) / p + 31) / 32 * 32;
  durbin_chain_kernel<<<(unsigned)n, threads, 0, (cudaStream_t)stream>>>(
      t1, (double*)out);
  return (int)cudaGetLastError();
}

const char* gpvae_cuda_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
