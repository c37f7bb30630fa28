// Cholesky of one small SPD matrix inside one thread block, blocked by
// panels, and the inverse of the factor: shared by gram_chol.cu (T <= 64)
// and chol_block.cu (t <= 128); tri_inv.cu takes the shared layout and its
// fill and store, and panel_solve.cu steps 2 and 3 for the rows below a
// block.
//
// What bounds it on Hopper: a matrix of side t holds t^3/3 flops (0.7
// MFLOP at t = 128) and t^2 floats, so one thread block per matrix is
// bound by the latency of its serial chain, never by flops or bytes.  An
// unblocked column recurrence spends one block-wide barrier per column and
// leaves most threads idle late in the recurrence (~0.7 us a column
// measured on an H100).  Here the columns go in panels of kNb = 16:
//
//   1. diagonal tile: warp 0 factors the kNb x kNb tile from registers,
//      lane i holding row i; each pivot and each L[k, j] reaches the
//      other lanes by __shfl_sync, so the panel needs no block barrier;
//   2. panel solve: every row below the tile is solved against it, one
//      row per thread, the row held in registers;
//   3. trailing update: a register-tiled SYRK of the lower triangle to the
//      right of the panel, each thread owning 4 x 4 entries: it sums the
//      kNb products of the panel into registers (fma, in column order)
//      and subtracts that sum from the entry once.
//
// Three barriers a panel: 24 at t = 128, where the unblocked recurrence
// spends 128.  (Panels of 32, with 12, measured slower on an H100 for
// both kernels; PERF.md has the times.)
//
// Layout.  The matrix lives column-major in shared memory, s[c * p + r] =
// A[r][c] for r >= c, with the row pitch p = pitch(t) = 4 (mod 8): a
// column's rows are contiguous and 16-byte aligned, so the update reads
// four rows of a panel column as one float4, and a warp that reads a
// 4-row x 8-column chunk (fill_lower, store_lower) touches 32 distinct
// banks.  cols(t) = t rounded up to 4 columns are allocated.  Only the
// lower triangle of the t x t matrix is ever filled: what the 4 x 4 tiles
// compute above the diagonal or past t stays there (nothing reads it into
// a real entry of L or X), and the output writes zeros above the
// diagonal.  The slot s[j * p + p - 1], below every row of column j,
// keeps d_j = 1/L[j][j] for the panel solve and the inverse.
//
// A ragged last panel (t = 45, 100, 127: 13, 4 and 15 columns) is only
// ever a diagonal tile, factored with identity rows in the lanes past its
// width; no rows lie below it, so the panel solve and the trailing update
// only ever see full panels.
//
// Numerics: d_j = rsqrt(a_jj) (floored at 1e-20 with kFloor, as the TPU's
// _chol_lane_body does), L[:, j] = a[:, j] d_j.  Without the floor a block
// that is not positive definite gets NaN from the failing column on (a
// negative pivot) or inf/NaN (a zero one), never finite garbage.  All
// arithmetic is float32 fma; no tensor cores, no split.
#pragma once

#include <cuda_runtime.h>

namespace gpvae {
namespace chol_tile {

constexpr int kNb = 16;  // panel width
constexpr unsigned kFull = 0xffffffffu;
constexpr float kDiagFloor = 1e-20f;

// rsqrt on the pivot chain: the bare MUFU.RSQ, without rsqrtf's scaling of
// a denormal argument (a pivot below 1.2e-38 is a zero pivot here)
__device__ __forceinline__ float rsqrt_pivot(float a) {
#ifdef __CUDA_ARCH__
  float d;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(d) : "f"(a));
  return d;
#else
  return rsqrtf(a);
#endif
}

// row pitch of the shared matrix of side t: 4 (mod 8), at least t + 4
__host__ __device__ constexpr int pitch(int t) { return (t + 7) / 8 * 8 + 4; }
// columns (and rows) allocated: t rounded up to a whole 4 x 4 tile
__host__ __device__ constexpr int cols(int t) { return (t + 3) / 4 * 4; }
// floats of one shared matrix of side t
__host__ __device__ constexpr int floats(int t) { return cols(t) * pitch(t); }

// s[c * p + r] = elem(r, c) for c <= r < t; nothing else is written
// (entries above the diagonal and past t are never read into L or X).
// A warp takes 4 rows at a time, 8 columns a lane group, kBatch chunks of
// 4 x 8 read before any is stored so that many reads are in flight; it
// takes row blocks in pairs from both ends, each pair as long as the
// first and last row blocks together.
template <int kThreads, class Elem>
__device__ void fill_lower(float* s, int p, int t, Elem elem) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kBatch = 8;
  const int lane = threadIdx.x & 31;
  const int rbs = (t + 3) / 4;
  for (int q = threadIdx.x >> 5; q < (rbs + 1) / 2; q += kWarps) {
    for (int half = 0; half < 2; ++half) {
      const int rb = half ? rbs - 1 - q : q;
      if (half && rb == q) break;
      const int r = 4 * rb + (lane >> 3);
      const int cbs = rb / 2 + 1;  // chunks of 8 columns reaching c <= 4 rb + 3
      for (int cb = 0; cb < cbs; cb += kBatch) {
        float v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int c = 8 * (cb + u) + (lane & 7);
          v[u] = (cb + u < cbs && c <= r && r < t) ? elem(r, c) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int c = 8 * (cb + u) + (lane & 7);
          if (cb + u < cbs && c <= r && r < t) s[c * p + r] = v[u];
        }
      }
    }
  }
}

// out[r * row + c] = L[r][c] for r, c < t, zeros above the diagonal: a
// warp writes 4 rows x 8 columns at a time.
template <int kThreads>
__device__ void store_lower(const float* s, int p, int t, float* out,
                            long long row) {
  const int lane = threadIdx.x & 31;
  for (int rb = threadIdx.x >> 5; rb < (t + 3) / 4; rb += kThreads / 32) {
    const int r = 4 * rb + (lane >> 3);
    if (r >= t) continue;
    for (int c = lane & 7; c < t; c += 8) {
      out[r * row + c] = c <= r ? s[c * p + r] : 0.0f;
    }
  }
}

// Step 1: warp 0 factors the diagonal tile at c0 (nbp <= kNb columns),
// two columns a step.  Every lane factors the step's 2 x 2 diagonal block
// itself, then its own row's two entries, then updates its row with the
// other lanes' entries by shuffle.  The next step's block comes in the
// same round of shuffles, as its entries before this step's update plus
// the two rows' new entries, and every lane applies that update itself
// in the owner lane's order (bit for bit the owner's result): the serial
// chain crosses lanes once per two columns.  (Updates read from shared
// memory after a __syncwarp instead measured slower on an H100.)  The
// lanes past nbp hold identity rows, so the loops run their full length
// without a branch.
template <bool kFloor>
__device__ __forceinline__ void diag_tile(float* s, int p, int c0, int nbp) {
  const int lane = threadIdx.x & 31;
  const bool mine = lane < nbp;
  float r[kNb];  // row `lane` of the tile; zeros above its diagonal
#pragma unroll
  for (int k = 0; k < kNb; ++k) {
    r[k] = (mine && k <= lane) ? s[(c0 + k) * p + c0 + lane]
                               : (k == lane ? 1.0f : 0.0f);
  }
  float a00 = __shfl_sync(kFull, r[0], 0);
  float a10 = __shfl_sync(kFull, r[0], 1);
  float a11 = __shfl_sync(kFull, r[1], 1);
#pragma unroll
  for (int j = 0; j < kNb; j += 2) {
    const float d0 = rsqrt_pivot(kFloor ? fmaxf(a00, kDiagFloor) : a00);
    const float l10 = a10 * d0;
    const float e11 = fmaf(-l10, l10, a11);
    const float d1 = rsqrt_pivot(kFloor ? fmaxf(e11, kDiagFloor) : e11);
    // this lane's L[lane][j], L[lane][j+1]: the same operations as the
    // block's own (lane j+1 gets l10 and L[j+1][j+1] bit for bit)
    const float x0 = lane >= j ? r[j] * d0 : 0.0f;
    const float x1 = lane >= j + 1 ? fmaf(-x0, l10, r[j + 1]) * d1 : 0.0f;
    r[j] = x0;
    r[j + 1] = x1;
    if (lane == j && j < nbp) s[(c0 + j) * p + p - 1] = d0;
    if (lane == j + 1 && j + 1 < nbp) s[(c0 + j + 1) * p + p - 1] = d1;
    if (j + 2 < kNb) {
      const int n0 = j + 2, n1 = j + 3;
      const float b00 = __shfl_sync(kFull, r[n0], n0);
      const float b10 = __shfl_sync(kFull, r[n0], n1);
      const float b11 = __shfl_sync(kFull, r[n1], n1);
      const float p0 = __shfl_sync(kFull, x0, n0);
      const float p1 = __shfl_sync(kFull, x1, n0);
      const float q0 = __shfl_sync(kFull, x0, n1);
      const float q1 = __shfl_sync(kFull, x1, n1);
#pragma unroll
      for (int k = n0; k < kNb; ++k) {
        r[k] = fmaf(-x0, __shfl_sync(kFull, x0, k), r[k]);
        r[k] = fmaf(-x1, __shfl_sync(kFull, x1, k), r[k]);
      }
      a00 = fmaf(-p1, p1, fmaf(-p0, p0, b00));
      a10 = fmaf(-q1, p1, fmaf(-q0, p0, b10));
      a11 = fmaf(-q1, q1, fmaf(-q0, q0, b11));
    }
  }
  if (mine) {
#pragma unroll
    for (int k = 0; k < kNb; ++k) {
      if (k <= lane) s[(c0 + k) * p + c0 + lane] = r[k];
    }
  }
}

// Step 2 on a row held in registers: a[k] = A[r][c0+k] on entry,
// L[r][c0+k] on return,
// L[r][c0+j] = (A[r][c0+j] - sum_{k<j} L[r][c0+k] L[c0+j][c0+k]) d_j,
// the sum taken right-looking in k order.  s holds the tile column-major
// (pitch p) with d_j in the slot under each column; the tile's columns are
// read as float4, the same address for every thread.
__device__ __forceinline__ void solve_regs(const float* s, int p, int c0,
                                           float (&a)[kNb]) {
#pragma unroll
  for (int j = 0; j < kNb; ++j) {
    const float* col = s + (c0 + j) * p;
    const float x = a[j] * col[p - 1];
    a[j] = x;
    // L[c0+k][c0+j] for k > j: four at a time from the tile's column
#pragma unroll
    for (int q = (j + 1) / 4; q < kNb / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(col + c0 + 4 * q);
      const float lk[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (4 * q + e > j) a[4 * q + e] = fmaf(-x, lk[e], a[4 * q + e]);
      }
    }
  }
}

// Step 2: row r below the full panel at c0, solved against its tile.
__device__ __forceinline__ void solve_row(float* s, int p, int c0, int r) {
  float a[kNb];
#pragma unroll
  for (int k = 0; k < kNb; ++k) a[k] = s[(c0 + k) * p + r];
  solve_regs(s, p, c0, a);
#pragma unroll
  for (int k = 0; k < kNb; ++k) s[(c0 + k) * p + r] = a[k];
}

// Step 3: A[i][k] -= sum_j L[i][j] L[k][j] over the panel's columns j, for
// c1 <= k <= i < t (c1 = c0 + kNb), in 4 x 4 tiles of the lower triangle
// numbered row by row (tile q is (ti, tk), ti >= tk): tiles q0, q0 + step,
// ... below q1.
__device__ __forceinline__ void trailing(float* s, int p, int c0, int q0,
                                         int q1, int step) {
  const int c1 = c0 + kNb;
  for (int q = q0; q < q1; q += step) {
    int ti = (int)((sqrtf(8.0f * q + 1.0f) - 1.0f) * 0.5f);
    if ((ti + 1) * (ti + 2) / 2 <= q) ++ti;
    if (ti * (ti + 1) / 2 > q) --ti;
    const int i0 = c1 + 4 * ti;
    const int k0 = c1 + 4 * (q - ti * (ti + 1) / 2);
    float acc[4][4] = {};
#pragma unroll
    for (int j = 0; j < kNb; ++j) {
      const float* col = s + (c0 + j) * p;
      const float4 vi = *reinterpret_cast<const float4*>(col + i0);
      const float4 vk = *reinterpret_cast<const float4*>(col + k0);
      const float li[4] = {vi.x, vi.y, vi.z, vi.w};
      const float lk[4] = {vk.x, vk.y, vk.z, vk.w};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(li[a], lk[b], acc[a][b]);
      }
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      float4* dst = reinterpret_cast<float4*>(s + (k0 + b) * p + i0);
      float4 v = *dst;
      v.x -= acc[0][b];
      v.y -= acc[1][b];
      v.z -= acc[2][b];
      v.w -= acc[3][b];
      *dst = v;
    }
  }
}

// The factorization in place: on entry s holds the lower triangle (after
// fill_lower; no barrier needed in between), on return L, all threads
// synchronized.
template <bool kFloor, int kThreads>
__device__ void factor(float* s, int p, int t) {
  for (int c0 = 0; c0 < t; c0 += kNb) {
    __syncthreads();  // the fill, or the last trailing update, is done
    if (threadIdx.x < 32) diag_tile<kFloor>(s, p, c0, min(kNb, t - c0));
    __syncthreads();
    const int c1 = c0 + kNb;
    if (c1 >= t) break;
    for (int r = c1 + threadIdx.x; r < t; r += kThreads) {
      solve_row(s, p, c0, r);
    }
    __syncthreads();
    const int nt = (t - c1 + 3) / 4;
    trailing(s, p, c0, threadIdx.x, nt * (nt + 1) / 2, kThreads);
  }
}

// X = L^{-1} of the factor in s, into x, row-major: x[r * p + c] = X[r][c]
// for c <= r (cols(t) rows of pitch p).  On entry all threads are
// synchronized after factor(); on return too.
//
//   a. each diagonal tile X_qq = L_qq^{-1}, one warp a tile, lane c
//      substituting column c from registers;
//   b. then blocks of side B = kNb, 2 kNb, 4 kNb, ... are joined in pairs,
//      [[X_11, 0], [X_21, X_22]] with X_21 = -X_22 (L_21 X_11), all pairs
//      of a level at once in 4 x 4 register tiles over every thread (two
//      products, two barriers a level: 2 levels at t = 128).  The product
//      Y = L_21 X_11 is parked in L's unused upper triangle, Y[r][c] at
//      s[r * p + c] (c < r), where the second product reads its rows as
//      float4.
// Store X with its lower half only; L's upper triangle is scratch.
template <int kThreads>
__device__ void invert(float* s, float* x, int p, int t) {
  const int nt = (t + kNb - 1) / kNb;
  const int lane = threadIdx.x & 31;
  for (int q = threadIdx.x >> 5; q < nt; q += kThreads / 32) {
    const int qb = q * kNb;
    const int nbq = min(kNb, t - qb);
    float acc[kNb];  // column `lane` of X_qq
#pragma unroll
    for (int m = 0; m < kNb; ++m) acc[m] = m == lane ? 1.0f : 0.0f;
#pragma unroll
    for (int j = 0; j < kNb; ++j) {
      // past nbq: d = 1 and no column, so those steps change nothing
      const float* col = s + (qb + j) * p;
      const float xj = acc[j] * (j < nbq ? col[p - 1] : 1.0f);
      acc[j] = xj;
#pragma unroll
      for (int g = (j + 1) / 4; g < kNb / 4; ++g) {
        if (j < nbq && 4 * g < nbq) {
          const float4 v = *reinterpret_cast<const float4*>(col + qb + 4 * g);
          const float lm[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = 4 * g + e;
            if (m > j) acc[m] = fmaf(-lm[e], xj, acc[m]);
          }
        }
      }
    }
    if (lane < nbq) {
#pragma unroll
      for (int m = 0; m < kNb; ++m) {
        if (m >= lane && m < nbq) x[(qb + m) * p + qb + lane] = acc[m];
      }
    }
  }
  __syncthreads();

  for (int side = kNb; side < t; side *= 2) {
    const int st = side / 4;  // 4 x 4 thread tiles per side of a block
    int pairs = 0;            // pairs whose second block starts before t
    while ((2 * pairs + 1) * side < t) ++pairs;
    const int work = pairs * st * st;
    // Y = L_21 X_11: Y[r][c] = sum_{u=c}^{cb+side-1} L[r][u] X[u][c]
    for (int w = threadIdx.x; w < work; w += kThreads) {
      const int cb = 2 * side * (w / (st * st));
      const int r0 = cb + side + 4 * ((w / st) % st);
      const int c0 = cb + 4 * (w % st);
      if (r0 >= t) continue;
      float acc[4][4] = {};
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // u in c0..c0+3: X[u][c0+b] for b <= e
        const int u = c0 + e;
        const float4 vl = *reinterpret_cast<const float4*>(s + u * p + r0);
        const float li[4] = {vl.x, vl.y, vl.z, vl.w};
#pragma unroll
        for (int b = 0; b <= e; ++b) {
          const float xv = x[u * p + c0 + b];
#pragma unroll
          for (int a = 0; a < 4; ++a) acc[a][b] = fmaf(li[a], xv, acc[a][b]);
        }
      }
#pragma unroll 4
      for (int u = c0 + 4; u < cb + side; ++u) {
        const float4 vl = *reinterpret_cast<const float4*>(s + u * p + r0);
        const float4 vx = *reinterpret_cast<const float4*>(x + u * p + c0);
        const float li[4] = {vl.x, vl.y, vl.z, vl.w};
        const float xv[4] = {vx.x, vx.y, vx.z, vx.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(li[a], xv[b], acc[a][b]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {  // Y[r][c] at s[r * p + c]: L's upper half
        *reinterpret_cast<float4*>(s + (r0 + a) * p + c0) =
            make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
      }
    }
    __syncthreads();
    // X_21 = -X_22 Y: Z[r][c] = sum_{v=rb}^{r} X[r][v] Y[v][c]
    for (int w = threadIdx.x; w < work; w += kThreads) {
      const int cb = 2 * side * (w / (st * st));
      const int rb = cb + side;
      const int r0 = rb + 4 * ((w / st) % st);
      const int c0 = cb + 4 * (w % st);
      if (r0 >= t) continue;
      float acc[4][4] = {};
#pragma unroll 4
      for (int v = rb; v < r0; ++v) {
        float xi[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) xi[a] = x[(r0 + a) * p + v];
        const float4 vy = *reinterpret_cast<const float4*>(s + v * p + c0);
        const float y[4] = {vy.x, vy.y, vy.z, vy.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(xi[a], y[b], acc[a][b]);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // v = r0 + e: X[r0+a][v] for a >= e
        const int v = r0 + e;
        const float4 vy = *reinterpret_cast<const float4*>(s + v * p + c0);
        const float y[4] = {vy.x, vy.y, vy.z, vy.w};
#pragma unroll
        for (int a = e; a < 4; ++a) {
          const float xi = x[(r0 + a) * p + v];
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(xi, y[b], acc[a][b]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        *reinterpret_cast<float4*>(x + (r0 + a) * p + c0) =
            make_float4(-acc[a][0], -acc[a][1], -acc[a][2], -acc[a][3]);
      }
    }
    __syncthreads();
  }
}

// out[r * t + c] = X[r][c] for r, c < t, zeros above the diagonal: a
// warp writes a row at a time.
template <int kThreads>
__device__ void store_inverse(const float* x, int p, int t, float* out) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < t; r += kThreads / 32) {
    for (int c = lane; c < t; c += 32) {
      out[r * t + c] = c <= r ? x[r * p + c] : 0.0f;
    }
  }
}

}  // namespace chol_tile
}  // namespace gpvae
