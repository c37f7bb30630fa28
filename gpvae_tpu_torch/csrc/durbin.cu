// The Durbin (Levinson) recursion of symmetric positive definite Toeplitz
// matrices and its reverse, one thread block a matrix, in float64.
//
// Replaces no Pallas kernel: the JAX package runs the recursion under XLA,
// as a lax.scan of T - 1 steps (gpvae_tpu/toeplitz.py:88 _durbin_scan) or
// as a blocked Schur/Durbin whose float32 error needed compensated
// arithmetic (:386 _durbin_schur_blocked), and differentiates it by
// autodiff.  As eager PyTorch ops each of the T - 1 sequential steps costs
// several launches, thousands a call at T = 1024; here the whole chain
// runs inside one block, forward and reverse.
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
// s = t = (1, rho), a = b = e_0; step k reads s[k] and t[k-1]:
//     alpha_k = -s[k] / t[k-1].
// Before step k, a and b are zero from lag k up and s, t are rounding
// noise below lag k (s) and k - 1 (t), which nothing reads: each lag
// holds one pair (X, Z), (a, b) below lag k and (s, t) from lag k up, and
// a step updates it as X' = X + alpha W, Z' = W + alpha X with W the pair
// one lag down (lag k turns from (s, t) to (a, b) with X = a[k] = 0).  So
// a step is two FMAs a lag, half the split form's four.
//
// What bounds the forward on Hopper: the chain of T - 1 dependent steps,
// each a barrier, a shared-memory broadcast and one float64 division;
// not bytes (8 T a matrix) and at T <= 1024 not operations (2 T^2 FMAs a
// matrix, on one SM's 64 float64 lanes: 32 cycles a step at T = 1024, 128
// at T = 4096).  So the division leaves the lag threads: one more warp
// holds no lags, and its first thread, the leader, keeps alpha_k, s[k] and
// t[k-1] in registers and forms alpha_{k+1} = -s'[k+1] / t'[k] right after
// the barrier, from t'[k] = t[k-1] + alpha_k s[k] and the two lags s[k+1]
// and t[k] that their owners published before it; every lag thread reads
// alpha_k, updates its lags and writes its last Z for the next thread's
// shift to a shared array (no shuffle), and the one or two warps that hold
// lags k + 2 and k + 1 write each thread's s and t at those offsets to
// per-thread slots (no predicated store a lag).  The log1p terms leave the loop: every alpha is kept in shared
// memory and after the last step all threads sum (T - k) log1p(-alpha_k^2)
// and log1p(-alpha_k^2) in parallel, then one block reduction.
// durbin_chain_kernel runs the same T - 1 barriers and broadcasts with no
// arithmetic: its time is the chain's floor on the card.
//
// With `steps`/`last` given (a gradient is needed) the forward also keeps
// each step's alpha, numerator s[k], denominator t[k-1] and top lag
// t[T-1] (steps [n, 4, T - 1]), and the last step's inputs (X, W) at
// every lag (last [n, 2, T]).
//
// The reverse (durbin_bwd_kernel) runs the steps backwards from the
// cotangents of sum_log_e (S_bar), y (a_bar at lags >= 1) and e (e_bar).
// Reverse step k rebuilds the inputs of step k from its outputs by the
// inverse step, (X, W) = ((X' - alpha Z') , (Z' - alpha X')) / (1 -
// alpha^2) (the last step's from `last`), then
//     abar_k = sum_m (Xbar'[m] W[m] + Zbar'[m] X[m]) + tbar[k] s[k]
//              - 2 alpha_k / (1 - alpha_k^2) ((T - k) S_bar + e_bar e),
//     Xbar = Xbar' + alpha Zbar',  Wbar = Zbar' + alpha Xbar',
//     Zbar[m] = Wbar[m + 1],
// and where alpha_k was not clamped, g = abar_k / t[k-1] gives sbar[k] -=
// g and tbar[k-1] -= g alpha_k (s[k] = -alpha_k t[k-1]).  tbar at lag k -
// 1 is the one cotangent outside the pairs ("extra"): every thread keeps
// it.  Flops a step: 14 a lag (the inverse step's 2 FMAs and 2 products,
// 2 FMAs of the sum, 2 of the cotangents), 14 T^2 a matrix, 3.5 times the
// function's least, the reverse of classical Durbin (4 T^2: each FMA of
// its 2 T^2 forward turns into two); the chain a step: a warp reduction
// of the partial sums, one barrier, the sum of the warps' parts.  The
// inverse divides by 1 - alpha^2 at every step, yet on one pair a lag
// (no noise lags to amplify) it stays within 2.3e-12 of float64 autograd
// at the model's noise 1e-3, the near-singular T = 4096 rows included
// (durbin_probe.py accuracy).
// durbin_bwd_chain_kernel runs the same reductions and barriers alone.
//
// Lags per thread P in {1, 2, 4, 8, 16}, threads a block <= 256:
// T <= 4096.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxLagsPerThread = 16;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxT = kMaxThreads * kMaxLagsPerThread;
constexpr unsigned kFull = 0xffffffffu;
constexpr double kLim = 1.0 - 8.0 * 2.220446049250313e-16;

__device__ __forceinline__ double clamp_alpha(double raw) {
  // a NaN stays NaN, as in the plain version's clamp
  return raw > kLim ? kLim : (raw < -kLim ? -kLim : raw);
}

// v[i] for a runtime i in [0, P) (0 elsewhere), by selects: a register
// array indexed at run time would live in local memory
template <int P>
__device__ __forceinline__ double pick(const double (&v)[P], int i) {
  double out = 0.0;
#pragma unroll
  for (int m = 0; m < P; ++m) out = m == i ? v[m] : out;
  return out;
}

// the sum of the warps' parts part[0 .. warps), loaded together and added
// as a fixed tree: the same value on every thread
template <int W = kMaxWarps>
__device__ __forceinline__ double sum_parts(const double* part, int warps) {
  constexpr int kPow = W <= 8 ? 8 : 16;
  double p[kPow];
#pragma unroll
  for (int w = 0; w < kPow; ++w) p[w] = w < warps ? part[w] : 0.0;
#pragma unroll
  for (int h = kPow / 2; h > 0; h /= 2) {
#pragma unroll
    for (int w = 0; w < h; ++w) p[w] += p[w + h];
  }
  return p[0];
}

// the sum of v over the block, in the same order on every thread; `part`
// holds one slot a warp
__device__ __forceinline__ double block_sum(double v, double* part) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(kFull, v, o);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  return sum_parts<kMaxWarps + 1>(part, warps);
}

template <int P, bool SAVE>
__global__ void __launch_bounds__(kMaxThreads + 32)
durbin_kernel(const double* __restrict__ rho, int t1,
              double* __restrict__ sum_log_e, double* __restrict__ y,
              double* __restrict__ e_out, double* __restrict__ steps,
              double* __restrict__ last) {
  __shared__ double alpha_s[kMaxT];      // alpha_k of every step k
  // each lag thread's s at lag (k + 1) % P and t at k % P before step k
  // (the leader reads the owners' of k + 1 and k)
  __shared__ double pub_s[2][kMaxThreads], pub_t[2][kMaxThreads];
  __shared__ double last_z[2][kMaxThreads];  // each lag thread's last Z
  __shared__ double part[kMaxWarps + 1];
  const int t = t1 + 1;
  const long long row = blockIdx.x;
  const double* r = rho + row * t1;
  const int lag_threads = blockDim.x - 32;  // the last warp leads
  const bool leader = threadIdx.x == lag_threads;
  const int base = threadIdx.x * P;
  double* st = SAVE ? steps + row * 4 * t1 : nullptr;
  double* lst = SAVE ? last + row * 2 * t : nullptr;

  // before step 1: (a, b) = (1, 1) at lag 0, (s, t) = (rho, rho) above
  double x[P], z[P];
#pragma unroll
  for (int m = 0; m < P; ++m) {
    const int j = base + m;
    const double v = j == 0 ? 1.0 : (j < t ? r[j - 1] : 0.0);
    x[m] = v;
    z[m] = v;
    if (threadIdx.x < lag_threads && m == 2 % P) pub_s[1][threadIdx.x] = v;
    if (threadIdx.x < lag_threads && m == 1 % P) pub_t[1][threadIdx.x] = v;
  }
  // the leader's own alpha_k, s[k] and t[k-1]
  double al_lead = 0.0, num = 0.0, den = 1.0;
  if (leader && t1 > 0) {
    num = r[0];
    al_lead = clamp_alpha(-num);
    alpha_s[1] = al_lead;
    if (SAVE) {
      st[t1] = num;
      st[2 * t1] = den;
    }
  }
  if (threadIdx.x < lag_threads) last_z[1][threadIdx.x] = z[P - 1];

  for (int k = 1; k < t; ++k) {
    __syncthreads();
    if (threadIdx.x >= lag_threads) {
      // alpha_{k+1} = -s'[k+1] / t'[k] from s[k+1], t[k] and its own
      // alpha_k, s[k], t[k-1]
      if (leader && k + 1 < t) {
        const double nn = fma(al_lead, pub_t[k & 1][k / P],
                              pub_s[k & 1][(k + 1) / P]);
        den = fma(al_lead, num, den);
        num = nn;
        al_lead = clamp_alpha(-num / den);
        alpha_s[k + 1] = al_lead;
        if (SAVE) {
          st[t1 + k] = num;
          st[2 * t1 + k] = den;
        }
      }
      continue;
    }
    // the previous thread's last Z before this step
    const double zprev = threadIdx.x > 0 ? last_z[k & 1][threadIdx.x - 1]
                                         : 0.0;
    const double al = alpha_s[k];
    if (SAVE) {
      const int top = t - 1 - base;  // t[T-1], if this thread holds it
      if (top >= 0 && top < P) st[3 * t1 + k - 1] = pick(z, top);
      if (k == t1) {  // the last step's inputs
#pragma unroll
        for (int m = 0; m < P; ++m) {
          const int j = base + m;
          if (j < t) {
            lst[j] = j == k ? 0.0 : x[m];
            lst[t + j] = m > 0 ? z[m - 1] : zprev;
          }
        }
      }
    }
    // from the last lag down: lag m - 1 is still the old value at m
#pragma unroll
    for (int m = P - 1; m >= 0; --m) {
      const double w = m > 0 ? z[m - 1] : zprev;
      const double x0 = base + m == k ? 0.0 : x[m];
      x[m] = fma(al, w, x0);
      z[m] = fma(al, x0, w);
    }
    // what the leader reads at step k + 1: s[k+2] and t[k+1]
    // only the warps that hold lags k + 1 and k + 2; (k + 2) % P is the
    // same on every thread: selects on a uniform index
    const int warp = threadIdx.x / 32;
    if (warp == (k + 1) / (32 * P) || warp == (k + 2) / (32 * P)) {
      pub_s[(k + 1) & 1][threadIdx.x] = pick(x, (k + 2) % P);
      pub_t[(k + 1) & 1][threadIdx.x] = pick(z, (k + 1) % P);
    }
    last_z[(k + 1) & 1][threadIdx.x] = z[P - 1];
  }
  if (threadIdx.x < lag_threads) {
#pragma unroll
    for (int m = 0; m < P; ++m) {
      const int j = base + m;
      if (j >= 1 && j < t) y[row * t1 + j - 1] = x[m];
    }
  }
  __syncthreads();
  double s1 = 0.0, s2 = 0.0;
  for (int k = 1 + threadIdx.x; k < t; k += blockDim.x) {
    const double l = log1p(-alpha_s[k] * alpha_s[k]);
    s1 = fma((double)(t - k), l, s1);
    s2 += l;
    if (SAVE) st[k - 1] = alpha_s[k];
  }
  s1 = block_sum(s1, part);
  __syncthreads();
  s2 = block_sum(s2, part);
  if (threadIdx.x == 0) {
    sum_log_e[row] = s1;
    e_out[row] = exp(s2);
  }
}

template <int P>
__global__ void __launch_bounds__(kMaxThreads)
durbin_bwd_kernel(const double* __restrict__ steps,
                  const double* __restrict__ last,
                  const double* __restrict__ g_sum,
                  const double* __restrict__ g_y,
                  const double* __restrict__ g_e, int t1,
                  double* __restrict__ g_rho) {
  // alpha_k, 1 / (1 - alpha_k^2), s[k] and 1 / t[k-1] (0 where alpha_k was
  // clamped) of every step k (index k)
  extern __shared__ double sm[];
  __shared__ double edge_w[2][kMaxWarps];  // each warp's first lane's W
  __shared__ double edge_wb[2][kMaxWarps];  // and Wbar
  __shared__ double part[2][kMaxWarps];
  const int t = t1 + 1;
  double* alpha_s = sm;
  double* inv_s = sm + t;
  double* num_s = sm + 2 * t;
  double* rden_s = sm + 3 * t;
  const long long row = blockIdx.x;
  const double* st = steps + row * 4 * t1;
  const double* lst = last + row * 2 * t;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  const int base = threadIdx.x * P;

  double s2 = 0.0;
  for (int k = 1 + threadIdx.x; k < t; k += blockDim.x) {
    const double al = st[k - 1], num = st[t1 + k - 1];
    const double den = st[2 * t1 + k - 1];
    const double raw = -num / den;
    alpha_s[k] = al;
    inv_s[k] = 1.0 / (1.0 - al * al);
    num_s[k] = num;
    rden_s[k] = raw >= -kLim && raw <= kLim ? 1.0 / den : 0.0;
    s2 += log1p(-al * al);
  }
  // e_bar e and S_bar, the log1p terms' weights
  const double gee = g_e ? g_e[row] * exp(block_sum(s2, part[0])) : 0.0;
  const double gs = g_sum ? g_sum[row] : 0.0;

  // the state after the last step is never read: step T - 1 starts from
  // `last`
  double x[P], z[P], xb[P], zb[P];
#pragma unroll
  for (int m = 0; m < P; ++m) {
    const int j = base + m;
    x[m] = 0.0;
    z[m] = 0.0;
    xb[m] = g_y && j >= 1 && j < t ? g_y[row * t1 + j - 1] : 0.0;
    zb[m] = 0.0;
  }
  double extra = 0.0;
  const int top = t - 1 - base;  // the lag T - 1, if this thread holds it
  double top_next = top >= 0 && top < P ? st[3 * t1 + t1 - 1] : 0.0;
  __syncthreads();  // the per-step arrays

  for (int k = t1; k >= 1; --k) {
    const double al = alpha_s[k], iv = inv_s[k];
    const double nk = num_s[k], rk = rden_s[k];
    const double top_k = top_next;
    if (top >= 0 && top < P && k > 1) top_next = st[3 * t1 + k - 2];
    double acc = 0.0, w0 = 0.0, wb0 = 0.0;
#pragma unroll
    for (int m = 0; m < P; ++m) {
      const int j = base + m;
      double xi, w;
      if (k == t1) {  // the last step's inputs, kept by the forward
        xi = j < t ? lst[j] : 0.0;
        w = j < t ? lst[t + j] : 0.0;
      } else {  // by the inverse step
        xi = fma(-al, z[m], x[m]) * iv;
        w = fma(-al, x[m], z[m]) * iv;
      }
      acc = fma(xb[m], w, acc);
      acc = fma(zb[m], xi, acc);
      const double xbi = fma(al, zb[m], xb[m]);
      const double wb = fma(al, xb[m], zb[m]);
      x[m] = xi;
      xb[m] = xbi;
      if (m > 0) {  // Z[m - 1] = W[m], Zbar[m - 1] = Wbar[m]
        z[m - 1] = w;
        zb[m - 1] = wb;
      } else {
        w0 = w;
        wb0 = wb;
      }
    }
    // the next thread's W and Wbar at its first lag
    double wn = __shfl_down_sync(kFull, w0, 1);
    double wbn = __shfl_down_sync(kFull, wb0, 1);
    if (lane == 0) {
      edge_w[k & 1][warp] = w0;
      edge_wb[k & 1][warp] = wb0;
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2) acc += __shfl_xor_sync(kFull, acc, o);
    if (lane == 0) part[k & 1][warp] = acc;
    // the terms every thread knows: tbar[k] s[k] and the log1p terms'
    const double known = fma(extra, nk,
                             -2.0 * al * iv * fma((double)(t - k), gs, gee));
    __syncthreads();
    if (lane == 31) {
      wn = warp + 1 < warps ? edge_w[k & 1][warp + 1] : 0.0;
      wbn = warp + 1 < warps ? edge_wb[k & 1][warp + 1] : 0.0;
    }
    z[P - 1] = wn;
    zb[P - 1] = wbn;
    const double g = (known + sum_parts(part[k & 1], warps)) * rk;
    const int own = k - base;
    const double xbk = fma(al, extra, -g);
#pragma unroll
    for (int m = 0; m < P; ++m) {
      if (m == own) {  // lag k turns from (a, b) to (s, t)
        x[m] = nk;
        xb[m] = xbk;
      }
      if (m == top) {
        z[m] = top_k;
        zb[m] = 0.0;
      }
    }
    extra = fma(-g, al, extra);
  }
#pragma unroll
  for (int m = 0; m < P; ++m) {
    const int j = base + m;
    if (j >= 1 && j < t) g_rho[row * t1 + j - 1] = xb[m] + zb[m];
  }
}

// The forward's chain alone: the same T - 1 barriers and double-buffered
// broadcasts, each step's value the previous one's, no arithmetic.
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

// The reverse's chain alone: each step a warp reduction, one barrier and
// the sum of the warps' parts, as durbin_bwd_kernel, no other arithmetic.
__global__ void __launch_bounds__(kMaxThreads)
durbin_bwd_chain_kernel(int t1, double* __restrict__ out) {
  __shared__ double part[2][kMaxWarps];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  double v = threadIdx.x == 0 ? 1.0 : 0.0;
  for (int k = t1; k >= 1; --k) {
    double acc = v;
#pragma unroll
    for (int o = 16; o > 0; o /= 2) acc += __shfl_xor_sync(kFull, acc, o);
    if (lane == 0) part[k & 1][warp] = acc;
    __syncthreads();
    const double s = sum_parts(part[k & 1], warps);
    v = threadIdx.x == 0 ? s : 0.0;
  }
  if (threadIdx.x == 0) out[blockIdx.x] = v;
}

// the lags a thread holds: the fewest that fit 256 threads, or one width
// for every T when built with -DGPVAE_DURBIN_LAGS=P (durbin_probe.py lags)
int lags_per_thread(int t) {
#ifdef GPVAE_DURBIN_LAGS
  return GPVAE_DURBIN_LAGS;
#else
  int p = 1;
  while (p < kMaxLagsPerThread && p * kMaxThreads < t) p *= 2;
  return p;
#endif
}

int block_threads(int t, int p) { return ((t + p - 1) / p + 31) / 32 * 32; }

template <int P>
int launch_fwd(const double* rho, int n, int t1, double* sum_log_e,
               double* y, double* e, double* steps, double* last,
               cudaStream_t stream) {
  // the lag threads and one warp whose first thread leads
  const int threads = block_threads(t1 + 1, P) + 32;
  if (steps)
    durbin_kernel<P, true><<<(unsigned)n, threads, 0, stream>>>(
        rho, t1, sum_log_e, y, e, steps, last);
  else
    durbin_kernel<P, false><<<(unsigned)n, threads, 0, stream>>>(
        rho, t1, sum_log_e, y, e, steps, last);
  return (int)cudaGetLastError();
}

template <int P>
int launch_bwd(const double* steps, const double* last, const double* g_sum,
               const double* g_y, const double* g_e, int n, int t1,
               double* g_rho, cudaStream_t stream) {
  const int t = t1 + 1;
  const int threads = block_threads(t, P);
  const size_t smem = 4 * sizeof(double) * t;
  cudaError_t err = cudaFuncSetAttribute(
      durbin_bwd_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  durbin_bwd_kernel<P><<<(unsigned)n, threads, smem, stream>>>(
      steps, last, g_sum, g_y, g_e, t1, g_rho);
  return (int)cudaGetLastError();
}

bool bad_shape(int n, int t1, int p) {
  return t1 < 0 || t1 + 1 > kMaxT || n > (1 << 30) ||
         (p != 1 && p != 2 && p != 4 && p != 8 && p != 16) ||
         block_threads(t1 + 1, p) > kMaxThreads;
}

}  // namespace

extern "C" {

// rho: [n, t1] float64 on the device, contiguous; sum_log_e, e: [n];
// y: [n, t1]; steps [n, 4, t1] and last [n, 2, t1 + 1] both null (no
// gradient) or both given (with t1 = 0 neither is written).  Launches on
// `stream` and returns the cudaError_t of the launch
// (cudaErrorInvalidValue for t1 + 1 > 4096).
int gpvae_durbin_f64(const void* rho, int n, int t1, void* sum_log_e,
                     void* y, void* e, void* steps, void* last,
                     void* stream) {
  if (n <= 0) return 0;
  const int p = lags_per_thread(t1 + 1);
  if (bad_shape(n, t1, p) ||
      (t1 > 0 && (steps == nullptr) != (last == nullptr)))
    return (int)cudaErrorInvalidValue;
  const double* r = (const double*)rho;
  double *s = (double*)sum_log_e, *yy = (double*)y, *ee = (double*)e;
  double *sv = (double*)steps, *ls = (double*)last;
  cudaStream_t st = (cudaStream_t)stream;
  switch (p) {
    case 1: return launch_fwd<1>(r, n, t1, s, yy, ee, sv, ls, st);
    case 2: return launch_fwd<2>(r, n, t1, s, yy, ee, sv, ls, st);
    case 4: return launch_fwd<4>(r, n, t1, s, yy, ee, sv, ls, st);
    case 8: return launch_fwd<8>(r, n, t1, s, yy, ee, sv, ls, st);
    default: return launch_fwd<16>(r, n, t1, s, yy, ee, sv, ls, st);
  }
}

// The gradient g_rho [n, t1] from the forward's steps and last and the
// cotangents g_sum [n], g_y [n, t1], g_e [n] (each may be null: zero).
int gpvae_durbin_bwd_f64(const void* steps, const void* last,
                         const void* g_sum, const void* g_y,
                         const void* g_e, int n, int t1, void* g_rho,
                         void* stream) {
  if (n <= 0 || t1 == 0) return 0;  // no step: g_rho is empty
  const int p = lags_per_thread(t1 + 1);
  if (bad_shape(n, t1, p) || steps == nullptr || last == nullptr)
    return (int)cudaErrorInvalidValue;
  const double *sv = (const double*)steps, *ls = (const double*)last;
  const double *gs = (const double*)g_sum, *gy = (const double*)g_y;
  const double* ge = (const double*)g_e;
  double* out = (double*)g_rho;
  cudaStream_t st = (cudaStream_t)stream;
  switch (p) {
    case 1: return launch_bwd<1>(sv, ls, gs, gy, ge, n, t1, out, st);
    case 2: return launch_bwd<2>(sv, ls, gs, gy, ge, n, t1, out, st);
    case 4: return launch_bwd<4>(sv, ls, gs, gy, ge, n, t1, out, st);
    case 8: return launch_bwd<8>(sv, ls, gs, gy, ge, n, t1, out, st);
    default: return launch_bwd<16>(sv, ls, gs, gy, ge, n, t1, out, st);
  }
}

// The chain floor of gpvae_durbin_f64 at the same n, t1 and block size:
// out [n] float64.
int gpvae_durbin_chain_f64(int n, int t1, void* out, void* stream) {
  if (n <= 0) return 0;
  const int p = lags_per_thread(t1 + 1);
  if (bad_shape(n, t1, p)) return (int)cudaErrorInvalidValue;
  durbin_chain_kernel<<<(unsigned)n, block_threads(t1 + 1, p), 0,
                        (cudaStream_t)stream>>>(t1, (double*)out);
  return (int)cudaGetLastError();
}

// The chain floor of gpvae_durbin_bwd_f64 at the same n, t1 and block
// size: out [n] float64.
int gpvae_durbin_bwd_chain_f64(int n, int t1, void* out, void* stream) {
  if (n <= 0) return 0;
  const int p = lags_per_thread(t1 + 1);
  if (bad_shape(n, t1, p)) return (int)cudaErrorInvalidValue;
  durbin_bwd_chain_kernel<<<(unsigned)n, block_threads(t1 + 1, p), 0,
                            (cudaStream_t)stream>>>(t1, (double*)out);
  return (int)cudaGetLastError();
}

const char* gpvae_cuda_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
