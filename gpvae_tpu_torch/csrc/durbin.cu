// The Durbin (Levinson) recursion of symmetric positive definite Toeplitz
// matrices and its reverse, in float64: one thread block a matrix up to
// T = 4096, a window of 32 steps a launch over many blocks above.
//
// Replaces no Pallas kernel: the JAX package runs the recursion under XLA,
// as a lax.scan of T - 1 steps (gpvae_tpu/toeplitz.py:88 _durbin_scan) or
// as a blocked Schur/Durbin whose float32 error needed compensated
// arithmetic (:386 _durbin_schur_blocked), and differentiates it by
// autodiff.  As eager PyTorch ops each of the T - 1 sequential steps costs
// several launches, thousands a call at T = 1024; here the whole chain
// runs inside one block, forward and reverse, or T / 32 launches (two
// a window in reverse) of the long route below.
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
// Lags per thread P in {1, 2, 4, 8, 16}, threads a block <= 256: these
// one-block kernels take T <= kShortMaxT = 4096.
//
// Above that, the long route: one block can no longer hold the lags in
// registers (16 bytes a lag), and one SM's 64 float64 lanes would take
// ~T^2 / 32 cycles a matrix.  So the lags live in global memory (L2 at
// these sizes) and the recursion advances a window of kNb = 32 steps a
// launch over the whole grid (durbin_window_kernel, T / 32 launches).
// Each warp owns a tile of kSpan = 256 lags, 8 a lane: it first recurs
// the window's 32 coefficients itself from the front lags [k0, k0 + 32)
// and the carried denominator t[k0-1] (the leader's chain above, here
// one lag a lane and a shuffle a step; every warp computes the same
// values, so no barrier is needed), then applies the 32 steps to its
// lags, the shift going through one warp shuffle a step.  A lag depends
// on the lag below it, so the bottom 32 of a tile are a halo recomputed
// by its neighbour and its top kOut = 224 come out exact.  The work is
// 2 T^2 FMAs and the halo's 1/7 more, spread over T / 224 warps a
// matrix; the chain is T - 1 front steps and T / 32 launches
// (durbin_window_chain_kernel runs the same launches and dependent
// shuffles with no arithmetic).  A finishing kernel sums the log1p terms
// and writes y.
//
// The long reverse undoes one window a pair of launches, on the same
// states the one-block reverse rebuilds (the inverse step from `last`,
// so its accuracy is the same).  abar_k sums over all lags; split the
// cotangent into what came in from later windows and what this window's
// coefficients inject at lags [k0, k0 + 32) (an injection at lag k
// spreads down one lag a step, so it stays inside the window's front).
// durbin_bwd_window_kernel carries the first part back through the
// window's 32 steps on each tile of kBwdSpan = 128 lags, 4 a lane, its
// bottom kBwdOut = 96 exact (halo on top: the inverse step and the
// cotangent's shift read the lag above), and writes each step's partial
// sum of the tile's own lags (kept a lane a step in shared memory and
// summed after the loop, off the chain) and the step's inputs (X, W) at
// the front lags; durbin_bwd_front_kernel, one block a matrix, sums the
// tiles' parts and stages the front's inputs in shared memory, then one
// warp runs the window's steps on the injected part alone, adding the
// tiles' sums to each abar_k, and adds its cotangents to the front lags.
// So a cross-block reduction happens once a window, not once a step.
// The long route's chains are short, but each warp has its SM
// sub-partition to itself (T / 224 warps a matrix), so every step pays
// its latencies: measured, not modelled (PERF.md).
// durbin_window_chain_kernel gives the floor: the same launches, each
// step a warp reduction and a shuffle.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxLagsPerThread = 16;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxT = kMaxThreads * kMaxLagsPerThread;
// the largest T of the one-block kernels; -DGPVAE_DURBIN_SHORT_MAX_T=1
// sends every T to the long route: a probe-only build (durbin_probe.py
// routes, which times the two routes where they meet); the package never
// sets it
#ifdef GPVAE_DURBIN_SHORT_MAX_T
constexpr int kShortMaxT = GPVAE_DURBIN_SHORT_MAX_T;
#else
constexpr int kShortMaxT = kMaxT;
#endif
// the long route: steps a window, lags a lane, lags a tile (one warp),
// its exact lags, warps a block
constexpr int kNb = 32;
constexpr int kLongLags = 8;
constexpr int kSpan = 32 * kLongLags;
constexpr int kOut = kSpan - kNb;
constexpr int kTileWarps = 4;
// the reverse's tiles: half as wide, twice as many warps (its step does
// four times the forward's work a lag, and at T = 8192 the forward's
// tiles leave most SMs idle); the forward keeps 8 lags a lane, where
// each extra warp would recur the window's front once more
constexpr int kBwdLags = 4;
constexpr int kBwdSpan = 32 * kBwdLags;
constexpr int kBwdOut = kBwdSpan - kNb;
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

// -- the long route ----------------------------------------------------------

// tiles (warps) a matrix and blocks a matrix of the long route, tiles of
// `out` exact lags (kOut forward, kBwdOut in reverse)
__host__ __device__ __forceinline__ int long_tiles(int t, int out) {
  return (t + out - 1) / out;
}
__host__ __device__ __forceinline__ int long_blocks(int t, int out) {
  return (long_tiles(t, out) + kTileWarps - 1) / kTileWarps;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The window of steps [k0, k0 + nw) over every lag (see the top).  The
// state is (X, Z) [n][2][T] in st_in (before the first window: 1 at lag 0
// and rho above, in both), written to st_out; the carried t[k0-1] in
// den_in / den_out [n].  Each step's alpha goes to alpha[k-1] (row stride
// astride); with SAVE alpha is steps' first row, and its numerator,
// denominator and top lag and the last step's inputs are kept too.
template <bool SAVE>
__global__ void __launch_bounds__(kTileWarps * 32)
durbin_window_kernel(const double* __restrict__ rho, int t1, int k0,
                     const double* __restrict__ st_in,
                     double* __restrict__ st_out,
                     const double* __restrict__ den_in,
                     double* __restrict__ den_out, double* __restrict__ alpha,
                     int astride, double* __restrict__ last) {
  const int t = t1 + 1;
  const int bpm = long_blocks(t, kOut);
  const long long row = blockIdx.x / bpm;
  const int blk = blockIdx.x % bpm;
  const int tile = blk * kTileWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (tile >= long_tiles(t, kOut)) return;  // a whole warp; no barrier
  const bool first = k0 == 1;
  const double* r = rho + row * t1;
  const double* xs = st_in + row * 2 * t;
  const double* zs = xs + t;
  auto state = [&](const double* v, int j) -> double {
    if (j < 0 || j >= t) return 0.0;
    if (first) return j == 0 ? 1.0 : r[j - 1];
    return v[j];
  };
  const int nw = min(kNb, t - k0);

  // the front: lane l holds s and t at lag k0 + l
  double s = state(xs, k0 + lane), tt = state(zs, k0 + lane);
  double den = first ? 1.0 : den_in[row];
  double al_mine = 0.0, num_mine = 0.0, den_mine = 0.0;
  for (int j = 0; j < nw; ++j) {
    const double num = __shfl_sync(kFull, s, j);
    const double a = clamp_alpha(-num / den);
    if (lane == j) {
      al_mine = a;
      num_mine = num;
      den_mine = den;
    }
    const double tprev = __shfl_up_sync(kFull, tt, 1);
    if (lane > j) {  // s' = s + alpha Z t, t' = Z t + alpha s
      const double s0 = s;
      s = fma(a, tprev, s0);
      tt = fma(a, s0, tprev);
    }
    den = fma(a, num, den);  // t'[k] = t[k-1] + alpha_k s[k]
  }
  double* al_row = alpha + row * astride;
  if (blk == 0 && threadIdx.x < 32) {  // one warp a matrix keeps them
    if (lane < nw) {
      al_row[k0 - 1 + lane] = al_mine;
      if (SAVE) {
        al_row[t1 + k0 - 1 + lane] = num_mine;
        al_row[2 * t1 + k0 - 1 + lane] = den_mine;
      }
    }
    if (lane == 0) den_out[row] = den;
  }

  // the tile: lags [m0 - kNb, m0 + kOut), exact from m0 up
  const int m0 = tile * kOut;
  const int hi = min(m0 + kOut, t);
  const int base = m0 - kNb + lane * kLongLags;
  double x[kLongLags], z[kLongLags];
#pragma unroll
  for (int i = 0; i < kLongLags; ++i) {
    x[i] = state(xs, base + i);
    z[i] = state(zs, base + i);
  }
  double* lst = SAVE ? last + row * 2 * t : nullptr;
  const int top = t - 1 - base;  // t[T-1], if this lane holds it
  for (int j = 0; j < nw; ++j) {
    const int k = k0 + j;
    const double a = __shfl_sync(kFull, al_mine, j);
    double zprev = __shfl_up_sync(kFull, z[kLongLags - 1], 1);
    if (lane == 0) zprev = 0.0;  // below the halo (or lag -1)
    if (SAVE) {
      if (top >= 0 && top < kLongLags && t - 1 >= m0)
        al_row[3 * t1 + k - 1] = pick(z, top);
      if (k == t1) {  // the last step's inputs
#pragma unroll
        for (int i = 0; i < kLongLags; ++i) {
          const int lag = base + i;
          if (lag >= m0 && lag < hi) {
            lst[lag] = lag == k ? 0.0 : x[i];
            lst[t + lag] = i > 0 ? z[i - 1] : zprev;
          }
        }
      }
    }
#pragma unroll
    for (int i = kLongLags - 1; i >= 0; --i) {
      const double w = i > 0 ? z[i - 1] : zprev;
      const double x0 = base + i == k ? 0.0 : x[i];
      x[i] = fma(a, w, x0);
      z[i] = fma(a, x0, w);
    }
  }
  double* xo = st_out + row * 2 * t;
#pragma unroll
  for (int i = 0; i < kLongLags; ++i) {
    const int lag = base + i;
    if (lag >= m0 && lag < hi) {
      xo[lag] = x[i];
      xo[t + lag] = z[i];
    }
  }
}

// After the last window: sum_k (T - k) log1p(-alpha_k^2), E = exp(sum_k
// log1p(-alpha_k^2)) and y = X at lags 1 .. T-1; one block a matrix.
__global__ void __launch_bounds__(kMaxThreads)
durbin_window_finish_kernel(const double* __restrict__ alpha, int astride,
                            int t1, const double* __restrict__ st,
                            double* __restrict__ sum_log_e,
                            double* __restrict__ y,
                            double* __restrict__ e_out) {
  __shared__ double part[kMaxWarps + 1];
  const int t = t1 + 1;
  const long long row = blockIdx.x;
  const double* al = alpha + row * astride;
  const double* xs = st + row * 2 * t;
  double s1 = 0.0, s2 = 0.0;
  for (int k = 1 + threadIdx.x; k < t; k += blockDim.x) {
    const double l = log1p(-al[k - 1] * al[k - 1]);
    s1 = fma((double)(t - k), l, s1);
    s2 += l;
    y[row * t1 + k - 1] = xs[k];
  }
  s1 = block_sum(s1, part);
  __syncthreads();
  s2 = block_sum(s2, part);
  if (threadIdx.x == 0) {
    sum_log_e[row] = s1;
    e_out[row] = exp(s2);
  }
}

// Before the long reverse: e_bar e [n] (g_e may be null) and the carried
// cotangent of t[k-1] [n], 0.
__global__ void __launch_bounds__(kMaxThreads)
durbin_bwd_start_kernel(const double* __restrict__ steps, int t1,
                        const double* __restrict__ g_e,
                        double* __restrict__ gee,
                        double* __restrict__ extra) {
  __shared__ double part[kMaxWarps + 1];
  const long long row = blockIdx.x;
  const double* al = steps + row * 4 * t1;
  double s2 = 0.0;
  for (int k = threadIdx.x; k < t1; k += blockDim.x)
    s2 += log1p(-al[k] * al[k]);
  s2 = block_sum(s2, part);
  if (threadIdx.x == 0) {
    gee[row] = g_e ? g_e[row] * exp(s2) : 0.0;
    extra[row] = 0.0;
  }
}

// The reverse of the window [k0, k0 + nw), the part of the cotangent that
// came in from later windows (see the top), on tiles of lags [m0, m0 +
// kBwdSpan), exact below m0 + kBwdOut.  State (X, Z) and cotangent (Xbar,
// Zbar) [n][2][T] after the window in st_in / ct_in (at the last window:
// none, and g_y), before it in st_out / ct_out; each step j's partial sum
// of the tile's own lags in part [n][tiles][kNb] and its inputs (X, W) at
// the front lags in fs [n][kNb][2][kNb].
__global__ void __launch_bounds__(kTileWarps * 32)
durbin_bwd_window_kernel(const double* __restrict__ steps,
                         const double* __restrict__ last,
                         const double* __restrict__ g_y, int t1, int k0,
                         const double* __restrict__ st_in,
                         const double* __restrict__ ct_in,
                         double* __restrict__ st_out,
                         double* __restrict__ ct_out,
                         double* __restrict__ part, double* __restrict__ fs) {
  const int t = t1 + 1;
  const int bpm = long_blocks(t, kBwdOut), tiles = long_tiles(t, kBwdOut);
  const long long row = blockIdx.x / bpm;
  const int tile = (blockIdx.x % bpm) * kTileWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (tile >= tiles) return;  // a whole warp; no block barrier
  const int nw = min(kNb, t - k0);
  const bool first = k0 + nw == t;  // the last window: the reverse starts
  const double* sv = steps + row * 4 * t1;
  const double* lst = last + row * 2 * t;
  // lane j: step k0 + j's alpha, 1 / (1 - alpha^2), s[k] and t[T-1]
  double al_l = 0.0, iv_l = 0.0, nk_l = 0.0, top_l = 0.0;
  if (lane < nw) {
    al_l = sv[k0 - 1 + lane];
    iv_l = 1.0 / (1.0 - al_l * al_l);
    nk_l = sv[t1 + k0 - 1 + lane];
    top_l = sv[3 * t1 + k0 - 1 + lane];
  }
  const int m0 = tile * kBwdOut;
  const int hi = min(m0 + kBwdOut, t);
  const int base = m0 + lane * kBwdLags;
  const double* xs = st_in + row * 2 * t;
  const double* xbs = ct_in + row * 2 * t;
  double x[kBwdLags], z[kBwdLags], xb[kBwdLags], zb[kBwdLags];
#pragma unroll
  for (int i = 0; i < kBwdLags; ++i) {
    const int lag = base + i;
    const bool in = lag < t;
    if (first) {  // the state after the last step is never read
      x[i] = z[i] = zb[i] = 0.0;
      xb[i] = g_y && lag >= 1 && in ? g_y[row * t1 + lag - 1] : 0.0;
    } else {
      x[i] = in ? xs[lag] : 0.0;
      z[i] = in ? xs[t + lag] : 0.0;
      xb[i] = in ? xbs[lag] : 0.0;
      zb[i] = in ? xbs[t + lag] : 0.0;
    }
  }
  // each lane's part of each step's sum, summed over the warp after the
  // loop (a reduction a step would sit on the chain)
  __shared__ double lane_sums[kTileWarps][kNb][33];
  double(*red)[33] = lane_sums[threadIdx.x / 32];
  double* f = fs + row * 2 * kNb * kNb;
  for (int j = nw - 1; j >= 0; --j) {
    const int k = k0 + j;
    const double al = __shfl_sync(kFull, al_l, j);
    const double iv = __shfl_sync(kFull, iv_l, j);
    const double nk = __shfl_sync(kFull, nk_l, j);
    const double top_k = __shfl_sync(kFull, top_l, j);
    double acc[2] = {0.0, 0.0}, w0 = 0.0, wb0 = 0.0;
#pragma unroll
    for (int i = 0; i < kBwdLags; ++i) {
      const int lag = base + i;
      double xi, w;
      if (k == t1) {  // the last step's inputs, kept by the forward
        xi = lag < t ? lst[lag] : 0.0;
        w = lag < t ? lst[t + lag] : 0.0;
      } else {  // by the inverse step
        xi = fma(-al, z[i], x[i]) * iv;
        w = fma(-al, x[i], z[i]) * iv;
      }
      if (lag < hi) {
        acc[i & 1] = fma(xb[i], w, acc[i & 1]);
        acc[i & 1] = fma(zb[i], xi, acc[i & 1]);
        if (lag >= k0 && lag < k0 + kNb) {
          f[2 * j * kNb + lag - k0] = xi;
          f[(2 * j + 1) * kNb + lag - k0] = w;
        }
      }
      const double xbi = fma(al, zb[i], xb[i]);
      const double wb = fma(al, xb[i], zb[i]);
      x[i] = xi;
      xb[i] = xbi;
      if (i > 0) {  // Z[i - 1] = W[i], Zbar[i - 1] = Wbar[i]
        z[i - 1] = w;
        zb[i - 1] = wb;
      } else {
        w0 = w;
        wb0 = wb;
      }
    }
    double wn = __shfl_down_sync(kFull, w0, 1);
    double wbn = __shfl_down_sync(kFull, wb0, 1);
    if (lane == 31) wn = wbn = 0.0;  // above the halo
    z[kBwdLags - 1] = wn;
    zb[kBwdLags - 1] = wbn;
#pragma unroll
    for (int i = 0; i < kBwdLags; ++i) {
      const int lag = base + i;
      if (lag == k) {  // lag k turns from (a, b) to (s, t)
        x[i] = nk;
        xb[i] = 0.0;  // its cotangent is the front's
      }
      if (lag == t - 1) {
        z[i] = top_k;
        zb[i] = 0.0;
      }
    }
    red[j][lane] = acc[0] + acc[1];
  }
  __syncwarp();
  if (lane < nw) {
    double sum = 0.0;
#pragma unroll 8
    for (int l = 0; l < 32; ++l) sum += red[lane][l];
    part[(row * tiles + tile) * kNb + lane] = sum;
  }
  double* xo = st_out + row * 2 * t;
  double* xbo = ct_out + row * 2 * t;
#pragma unroll
  for (int i = 0; i < kBwdLags; ++i) {
    const int lag = base + i;
    if (lag < hi) {
      xo[lag] = x[i];
      xo[t + lag] = z[i];
      xbo[lag] = xb[i];
      xbo[t + lag] = zb[i];
    }
  }
}

// The reverse of the window [k0, k0 + nw), the part its own coefficients
// inject, one block a matrix: its warps first sum the tiles' partial sums
// and stage the front's inputs in shared memory, then the first warp,
// lane l at lag k0 + l, runs the steps: each abar_k is the tiles' partial
// sum, this part's own sum and the terms every lane knows.  Its
// cotangents are added to ct (the window's cotangent before it, from
// durbin_bwd_window_kernel).
__global__ void __launch_bounds__(kMaxThreads)
durbin_bwd_front_kernel(const double* __restrict__ steps,
                        const double* __restrict__ g_sum, int t1, int k0,
                        const double* __restrict__ part,
                        const double* __restrict__ fs,
                        const double* __restrict__ gee,
                        double* __restrict__ extra_buf,
                        double* __restrict__ ct) {
  __shared__ double f[2 * kNb * kNb];
  __shared__ double tail_w[kMaxWarps][kNb];
  const int t = t1 + 1;
  const int tiles = long_tiles(t, kBwdOut);
  const long long row = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nw = min(kNb, t - k0);
  const bool in = k0 + lane < t;
  const double* fr = fs + row * 2 * kNb * kNb;
  for (int i = threadIdx.x; i < 2 * kNb * kNb; i += blockDim.x)
    f[i] = in ? fr[i] : 0.0;  // lane = i % kNb: lags past T unwritten
  const double* p = part + row * tiles * kNb + lane;
  double tw = 0.0;
  for (int tile = warp; tile < tiles; tile += kMaxWarps) tw += p[tile * kNb];
  tail_w[warp][lane] = tw;
  __syncthreads();
  if (warp > 0) return;
  const double* sv = steps + row * 4 * t1;
  // lane j: step k0 + j's alpha, s[k], 1 / t[k-1] (0 where alpha_k was
  // clamped), the log1p terms' weight and the tiles' partial sums
  double al_l = 0.0, nk_l = 0.0, rk_l = 0.0, coef_l = 0.0, tail_l = 0.0;
  if (lane < nw) {
    const int k = k0 + lane;
    const double al = sv[k - 1], num = sv[t1 + k - 1];
    const double den = sv[2 * t1 + k - 1];
    const double raw = -num / den;
    const double gs = g_sum ? g_sum[row] : 0.0;
    al_l = al;
    nk_l = num;
    rk_l = raw >= -kLim && raw <= kLim ? 1.0 / den : 0.0;
    coef_l = -2.0 * al / (1.0 - al * al) * fma((double)(t - k), gs, gee[row]);
#pragma unroll
    for (int w = 0; w < kMaxWarps; ++w) tail_l += tail_w[w][lane];
  }
  double xb = 0.0, zb = 0.0, extra = extra_buf[row];
  for (int j = nw - 1; j >= 0; --j) {
    const double xi = f[2 * j * kNb + lane];
    const double w = f[(2 * j + 1) * kNb + lane];
    const double acc = warp_sum(fma(xb, w, zb * xi));
    const double al = __shfl_sync(kFull, al_l, j);
    const double nk = __shfl_sync(kFull, nk_l, j);
    const double rk = __shfl_sync(kFull, rk_l, j);
    const double coef = __shfl_sync(kFull, coef_l, j);
    const double tail = __shfl_sync(kFull, tail_l, j);
    const double g = (acc + tail + fma(extra, nk, coef)) * rk;
    const double xbi = fma(al, zb, xb);
    const double wb = fma(al, xb, zb);
    double zn = __shfl_down_sync(kFull, wb, 1);
    if (lane == 31) zn = 0.0;
    xb = lane == j ? fma(al, extra, -g) : xbi;
    zb = zn;
    extra = fma(-g, al, extra);
  }
  if (in) {
    double* c = ct + row * 2 * t;
    c[k0 + lane] += xb;
    c[t + k0 + lane] += zb;
  }
  if (lane == 0) extra_buf[row] = extra;
}

// g_rho [n, t1]: Xbar + Zbar at lags 1 .. T-1 after the first window.
__global__ void durbin_bwd_finish_kernel(const double* __restrict__ ct,
                                         int n, int t1,
                                         double* __restrict__ g_rho) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= (long long)n * t1) return;
  const long long row = i / t1;
  const int lag = (int)(i % t1) + 1;
  const double* c = ct + row * 2 * (t1 + 1);
  g_rho[i] = c[lag] + c[t1 + 1 + lag];
}

// The long routes' chains alone, a launch a window: the forward's front
// and tile, each step a dependent shuffle (reduce = false); the reverse's
// tile and front, each step a warp reduction and a shuffle (reduce =
// true).  No other arithmetic.
__global__ void __launch_bounds__(kTileWarps * 32)
durbin_window_chain_kernel(int steps, bool reduce, int bpm,
                           double* __restrict__ out) {
  double v = 1.0;  // stays 1: the sum of 32 ones over 32
  for (int j = 0; j < steps; ++j) {
    if (reduce) v = warp_sum(v) * 0.03125;
    v = __shfl_sync(kFull, v, j % 32);
  }
  if (threadIdx.x == 0) out[blockIdx.x / bpm] = v;
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

// kernels launched by gpvae_durbin_f64 ([0]) and gpvae_durbin_bwd_f64
// ([1]) in this process, each counted at its launch (the chain floors'
// not): gpvae_durbin_launched reads them
unsigned g_launched[2] = {0, 0};

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
  ++g_launched[0];
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
  ++g_launched[1];
  return (int)cudaGetLastError();
}

bool bad_shape(int n, int t1, int p) {
  return t1 < 0 || n > (1 << 30) ||
         (p != 1 && p != 2 && p != 4 && p != 8 && p != 16) ||
         block_threads(t1 + 1, p) > kMaxThreads;
}

bool long_route(int t1) { return t1 + 1 > kShortMaxT; }

// the long route's larger grid, the reverse's tiles: blocks a matrix
bool bad_long_shape(int n, int t1) {
  return (long long)n * long_blocks(t1 + 1, kBwdOut) > 0x7fffffffLL;
}

// float64 scratch of the long route, in doubles: the state (X, Z) twice
// and the carried denominator twice, and alpha when no steps are kept
// (forward); the state and the cotangent twice, the partial sums, the
// front's inputs, e_bar e and the carried cotangent (reverse)
long long long_work(int n, int t1, bool bwd) {
  const long long t = t1 + 1;
  if (!bwd) return n * (4 * t + 2 + t1);
  return n * (8 * t + (long long)long_tiles(t1 + 1, kBwdOut) * kNb +
              2 * kNb * kNb + 2);
}

int launch_long_fwd(const double* rho, int n, int t1, double* sum_log_e,
                    double* y, double* e, double* steps, double* last,
                    double* work, cudaStream_t stream) {
  const long long t = t1 + 1;
  double* st[2] = {work, work + n * 2 * t};
  double* den[2] = {work + n * 4 * t, work + n * 4 * t + n};
  double* alpha = steps ? steps : work + n * (4 * t + 2);
  const int astride = steps ? 4 * t1 : t1;
  const unsigned blocks = (unsigned)(n * long_blocks(t1 + 1, kOut));
  int w = 0;
  for (int k0 = 1; k0 <= t1; k0 += kNb, ++w) {
    if (steps)
      durbin_window_kernel<true><<<blocks, kTileWarps * 32, 0, stream>>>(
          rho, t1, k0, st[w & 1], st[(w + 1) & 1], den[w & 1],
          den[(w + 1) & 1], alpha, astride, last);
    else
      durbin_window_kernel<false><<<blocks, kTileWarps * 32, 0, stream>>>(
          rho, t1, k0, st[w & 1], st[(w + 1) & 1], den[w & 1],
          den[(w + 1) & 1], alpha, astride, last);
    ++g_launched[0];
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  durbin_window_finish_kernel<<<(unsigned)n, kMaxThreads, 0, stream>>>(
      alpha, astride, t1, st[w & 1], sum_log_e, y, e);
  ++g_launched[0];
  return (int)cudaGetLastError();
}

int launch_long_bwd(const double* steps, const double* last,
                    const double* g_sum, const double* g_y,
                    const double* g_e, int n, int t1, double* g_rho,
                    double* work, cudaStream_t stream) {
  const long long t = t1 + 1;
  double* st[2] = {work, work + n * 2 * t};
  double* ct[2] = {work + n * 4 * t, work + n * 6 * t};
  double* part = work + n * 8 * t;
  double* fs = part + (long long)n * long_tiles(t1 + 1, kBwdOut) * kNb;
  double* gee = fs + (long long)n * 2 * kNb * kNb;
  double* extra = gee + n;
  const unsigned blocks = (unsigned)(n * long_blocks(t1 + 1, kBwdOut));
  durbin_bwd_start_kernel<<<(unsigned)n, kMaxThreads, 0, stream>>>(
      steps, t1, g_e, gee, extra);
  ++g_launched[1];
  int w = 0;
  for (int k0 = (t1 - 1) / kNb * kNb + 1; k0 >= 1; k0 -= kNb, ++w) {
    durbin_bwd_window_kernel<<<blocks, kTileWarps * 32, 0, stream>>>(
        steps, last, g_y, t1, k0, st[w & 1], ct[w & 1], st[(w + 1) & 1],
        ct[(w + 1) & 1], part, fs);
    durbin_bwd_front_kernel<<<(unsigned)n, kMaxThreads, 0, stream>>>(
        steps, g_sum, t1, k0, part, fs, gee, extra, ct[(w + 1) & 1]);
    g_launched[1] += 2;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long total = (long long)n * t1;
  durbin_bwd_finish_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                             stream>>>(ct[w & 1], n, t1, g_rho);
  ++g_launched[1];
  return (int)cudaGetLastError();
}

// the long routes' chain floors: the same launches, no arithmetic
int launch_long_chain(int n, int t1, bool bwd, double* out,
                      cudaStream_t stream) {
  const int bpm = long_blocks(t1 + 1, bwd ? kBwdOut : kOut);
  for (int k0 = 1; k0 <= t1; k0 += kNb) {
    const int nw = t1 + 1 - k0 < kNb ? t1 + 1 - k0 : kNb;
    durbin_window_chain_kernel<<<(unsigned)(n * bpm), kTileWarps * 32, 0,
                                 stream>>>(bwd ? nw : 2 * nw, bwd, bpm, out);
    if (bwd)
      durbin_window_chain_kernel<<<(unsigned)n, 32, 0, stream>>>(nw, true, 1,
                                                                 out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" {

// The scratch the call with these n, t1 needs, in doubles, into *count
// (a long long): 0 for T <= 4096, the long route's otherwise; bwd
// selects gpvae_durbin_bwd_f64's.
int gpvae_durbin_work_f64(int n, int t1, int bwd, void* count) {
  *(long long*)count = n > 0 && long_route(t1) ? long_work(n, t1, bwd) : 0;
  return 0;
}

// rho: [n, t1] float64 on the device, contiguous; sum_log_e, e: [n];
// y: [n, t1]; steps [n, 4, t1] and last [n, 2, t1 + 1] both null (no
// gradient) or both given (with t1 = 0 neither is written); work: the
// scratch gpvae_durbin_work_f64 names (null when it names 0).  Launches
// on `stream` and returns the cudaError_t of the launches.
int gpvae_durbin_f64(const void* rho, int n, int t1, void* sum_log_e,
                     void* y, void* e, void* steps, void* last, void* work,
                     void* stream) {
  if (n <= 0) return 0;
  if (t1 > 0 && (steps == nullptr) != (last == nullptr))
    return (int)cudaErrorInvalidValue;
  const double* r = (const double*)rho;
  double *s = (double*)sum_log_e, *yy = (double*)y, *ee = (double*)e;
  double *sv = (double*)steps, *ls = (double*)last;
  cudaStream_t st = (cudaStream_t)stream;
  if (long_route(t1)) {
    if (bad_long_shape(n, t1) || work == nullptr)
      return (int)cudaErrorInvalidValue;
    return launch_long_fwd(r, n, t1, s, yy, ee, sv, ls, (double*)work, st);
  }
  const int p = lags_per_thread(t1 + 1);
  if (bad_shape(n, t1, p)) return (int)cudaErrorInvalidValue;
  switch (p) {
    case 1: return launch_fwd<1>(r, n, t1, s, yy, ee, sv, ls, st);
    case 2: return launch_fwd<2>(r, n, t1, s, yy, ee, sv, ls, st);
    case 4: return launch_fwd<4>(r, n, t1, s, yy, ee, sv, ls, st);
    case 8: return launch_fwd<8>(r, n, t1, s, yy, ee, sv, ls, st);
    default: return launch_fwd<16>(r, n, t1, s, yy, ee, sv, ls, st);
  }
}

// The gradient g_rho [n, t1] from the forward's steps and last and the
// cotangents g_sum [n], g_y [n, t1], g_e [n] (each may be null: zero);
// work as for gpvae_durbin_f64 (bwd = 1).
int gpvae_durbin_bwd_f64(const void* steps, const void* last,
                         const void* g_sum, const void* g_y,
                         const void* g_e, int n, int t1, void* g_rho,
                         void* work, void* stream) {
  if (n <= 0 || t1 == 0) return 0;  // no step: g_rho is empty
  if (steps == nullptr || last == nullptr) return (int)cudaErrorInvalidValue;
  const double *sv = (const double*)steps, *ls = (const double*)last;
  const double *gs = (const double*)g_sum, *gy = (const double*)g_y;
  const double* ge = (const double*)g_e;
  double* out = (double*)g_rho;
  cudaStream_t st = (cudaStream_t)stream;
  if (long_route(t1)) {
    if (bad_long_shape(n, t1) || work == nullptr)
      return (int)cudaErrorInvalidValue;
    return launch_long_bwd(sv, ls, gs, gy, ge, n, t1, out, (double*)work,
                           st);
  }
  const int p = lags_per_thread(t1 + 1);
  if (bad_shape(n, t1, p)) return (int)cudaErrorInvalidValue;
  switch (p) {
    case 1: return launch_bwd<1>(sv, ls, gs, gy, ge, n, t1, out, st);
    case 2: return launch_bwd<2>(sv, ls, gs, gy, ge, n, t1, out, st);
    case 4: return launch_bwd<4>(sv, ls, gs, gy, ge, n, t1, out, st);
    case 8: return launch_bwd<8>(sv, ls, gs, gy, ge, n, t1, out, st);
    default: return launch_bwd<16>(sv, ls, gs, gy, ge, n, t1, out, st);
  }
}

// The chain floor of gpvae_durbin_f64 at the same n, t1, on the same
// route and grid: out [n] float64.
int gpvae_durbin_chain_f64(int n, int t1, void* out, void* stream) {
  if (n <= 0) return 0;
  if (long_route(t1)) {
    if (bad_long_shape(n, t1)) return (int)cudaErrorInvalidValue;
    return launch_long_chain(n, t1, false, (double*)out,
                             (cudaStream_t)stream);
  }
  const int p = lags_per_thread(t1 + 1);
  if (bad_shape(n, t1, p)) return (int)cudaErrorInvalidValue;
  durbin_chain_kernel<<<(unsigned)n, block_threads(t1 + 1, p), 0,
                        (cudaStream_t)stream>>>(t1, (double*)out);
  return (int)cudaGetLastError();
}

// The chain floor of gpvae_durbin_bwd_f64 at the same n, t1, on the same
// route and grid: out [n] float64.
int gpvae_durbin_bwd_chain_f64(int n, int t1, void* out, void* stream) {
  if (n <= 0) return 0;
  if (long_route(t1)) {
    if (bad_long_shape(n, t1)) return (int)cudaErrorInvalidValue;
    return launch_long_chain(n, t1, true, (double*)out,
                             (cudaStream_t)stream);
  }
  const int p = lags_per_thread(t1 + 1);
  if (bad_shape(n, t1, p)) return (int)cudaErrorInvalidValue;
  durbin_bwd_chain_kernel<<<(unsigned)n, block_threads(t1 + 1, p), 0,
                            (cudaStream_t)stream>>>(t1, (double*)out);
  return (int)cudaGetLastError();
}

// The kernels gpvae_durbin_f64 (bwd = 0) or gpvae_durbin_bwd_f64 (bwd =
// 1) launched so far in this process, modulo 2^32: one a call up to
// T = 4096, the long route's windows and finishing kernels above it.
int gpvae_durbin_launched(int bwd) { return (int)g_launched[bwd != 0]; }

const char* gpvae_cuda_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
