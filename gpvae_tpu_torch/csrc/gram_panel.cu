// The panel kernels of the blocked Cholesky (ops/blocked.py), left-looking:
// cholesky_gram_inplace, with the gram built in-kernel, and
// cholesky_inplace, of a pre-built gram bank; and right-looking (trail_*,
// below, ops/trail.py).  Block column b starts at
// column o and is w <= 128 wide; L is [n, T, T] with its rows at stride
// ld, and every write goes into L in place.
//
// The panel, for rows r in [r0, T) and columns c in [o, o + w):
//
//   L[r, c] = K[r, c] - sum_{k < o} L[r, k] L[c, k]
//
// with K, by template parameter, either
//   gram_panel (K2): built from the time vectors (gram.cuh), so the
//     [n, T, T] gram never exists in device memory, or
//   hist_panel (K5): read from a pre-built bank K [n, T, T] at its own
//     matrix and row strides.  K is only read: the caller's K comes back
//     unchanged.  At o = 0 the panel is a copy of K's column block.
//
// panel_solve (K3): for rows r in [o + w, T), once the diagonal block
// L_d = L[o:o+w, o:o+w] is factored in place,
//
//   L[r, o:o+w] <- L[r, o:o+w] L_d^{-T}
//
// by substitution against L_d, and zeros into the mirrored upper tile
// L[o:o+w, r].
//
// gram_panel and panel_solve replace the TPU kernels
// pallas_big._make_defer1_kernel (B9, the b = 1 step) and
// _make_defer_kernel with the gram (B10, b >= 2).  hist_panel replaces
// the pre-built-gram history kernels: pallas_big._hist_kernel (B14) and
// _hist2_kernel (B15, the same panel split in two outputs), the panel half
// of _make_defer_kernel without the gram (B18), and
// pallas_left._make_kernel (B19, the streamed panel of the 64 < T < 768
// route); with panel_solve it also does the column work of
// pallas_big._init_kernel (B16) and _wb_kernel (B17).
// The TPU defers each column's product with the block's inverse into the
// next step's kernel to save a pass over HBM on its in-order grid, cuts
// the panel into VMEM-sized slabs, and multiplies by an explicit inverse
// so that its matrix unit does the work.  Here blocks run in parallel and
// the column is finished in its own step, and it is solved, not
// multiplied: in float32 the explicit inverse left the factor 3-4x the
// library's error from the float64 factor at T = 256-1024, the
// substitution 1.5-2x (CPU emulation of both on the same inputs).  The
// solve multiplies by 1 / L_d[c, c], which may differ from a division in
// the last bit.
//
// The right-looking factorization (ops/blocked.py cholesky_blocked_fused,
// cholesky(method="blocked_fused")) takes two more, which together replace
// the TPU kernel pallas_trail._make_kernel (B23): one step at column o with
// a factored diagonal block Ld of width nb in {64, 128} and its explicit
// inverse,
//
//   trail_panel (K6):  X = L[o+nb:, o:o+nb] Ld^-T, in place, and zeros into
//                      the mirrored upper tile;
//   trail_update (K7): L[o+nb:, o+nb:] -= X X^T on the lower-triangular
//                      64 x 64 tiles only (the hist_panel tile, K = L,
//                      history [o, o+nb)).
//
// The TPU kernel does both in one grid: row tiles run in order and each
// finished X tile waits in a VMEM scratch for the downdates of the later
// ones.  Blocks on the card run in no order and share nothing, so X is
// finished by one launch before the next reads it, on the same stream;
// recomputing X rows in each downdate block instead would triple the
// work.  X is multiplied by the explicit inverse, as on the TPU, which in
// float32 costs 3-4x the library's factor error (see panel_solve below):
// "auto" never takes this route.  What bounds them: at the T = 1024, n =
// 128 middle step (o = 384, 512 rows below the block) the lower triangle
// of the downdate needs 4.3 GFLOP against 0.17 GB, bound by float32
// operations (0.064 ms at 67 TFLOP/s), and X against the triangular
// inverse 1.1 GFLOP against 0.07 GB, bound by bytes (0.021 ms at 3.35
// TB/s).  They run the panel's SIMT design, plain FMA, no TF32;
// trail_update computes the diagonal tiles whole and trail_panel the full
// product with Ld^-1, zeros included (4.8 and 2.1 GFLOP done).
//
// What bounds them on Hopper: the panel is the factorization's floating
// point work (n T^3 / 3 over all steps: 46 GFLOP at T = 1024, n = 128), a
// batched fp32 product with a history depth of up to T - 128.  It is a
// classic shared-memory SGEMM tile: 64 x 64 outputs per block, depth 16 per
// stage, 4 x 4 outputs per thread in registers, plain fp32 FMA (no TF32,
// no tensor cores: the covariance path stays fp32).  hist_panel reads its
// 64 x 64 K tile (16 KB) where gram_panel builds it, beside the 2 * 64 * o
// floats of history a block streams.  panel_solve is
// serial in the w columns of a row but rows are independent: a block
// holds L_d (66 KB) in shared memory and 32 rows in registers, eight
// lanes a row, and the column loop is unrolled so each lane's 16 values
// stay in registers; a column costs one shuffle and at most 16 FMAs a
// lane.

#include <cuda_runtime.h>

#include "gram.cuh"

namespace {

// -- gram_panel --------------------------------------------------------------

constexpr int kBM = 64;   // panel rows per block
constexpr int kBN = 64;   // panel columns per block
constexpr int kBK = 16;   // history depth per stage
constexpr int kPanelThreads = 256;

struct PanelParams {
  float* l;
  long long l_mat;
  int ld;
  // gram_panel: K built from the time vectors
  const float* times;  // [n, tlen]
  const float* mask;   // [n, tlen]
  const float* ls;     // [n]
  const float* var;    // [n]
  int tlen;
  int code;
  float noise;
  float one_minus_noise;
  // hist_panel: K read from a pre-built bank
  const float* k;
  long long k_mat;
  int kld;
  int r0, o, w, t;
  int h0;  // first history column (0 but in trail_update)
};

// One 64 x 64 tile of the panel of matrix n, rows row0 .., panel columns
// col0 .. (0 .. w); kGram says where K comes from.  The history runs over
// columns [h0, o).  The history loop and its bounds checks are the same
// for every kernel of the tile.
template <bool kGram>
__device__ __forceinline__ void panel_tile(const PanelParams& p, int n,
                                           int row0, int col0) {
  __shared__ __align__(16) float as[kBK][kBM + 4];  // as[k][m] = L[row m, k]
  __shared__ __align__(16) float bs[kBK][kBN + 4];  // bs[k][c] = L[col c, k]
  __shared__ float tr[kBM], mr[kBM], tc[kBN], mc[kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx*4 .. tx*4+3
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3
  float* lm = p.l + (size_t)n * p.l_mat;

  if constexpr (kGram) {
    const size_t vb = (size_t)n * p.tlen;
    if (tid < kBM) {
      const int r = row0 + tid;
      tr[tid] = (r < p.t) ? p.times[vb + r] : 0.0f;
      mr[tid] = (r < p.t) ? p.mask[vb + r] : 0.0f;
    } else if (tid < kBM + kBN) {
      const int c = col0 + tid - kBM;
      tc[tid - kBM] = (c < p.w) ? p.times[vb + p.o + c] : 0.0f;
      mc[tid - kBM] = (c < p.w) ? p.mask[vb + p.o + c] : 0.0f;
    }
    __syncthreads();  // the time vectors, for the epilogue
  }

  float acc[4][4] = {};
  for (int k0 = p.h0; k0 < p.o; k0 += kBK) {
    // 64 x 16 of each operand, four elements a thread, k fastest so a
    // row's 16 floats are one coalesced read
    for (int e = tid; e < kBM * kBK; e += kPanelThreads) {
      const int m = e / kBK;
      const int kk = e % kBK;
      const int r = row0 + m;
      const int k = k0 + kk;
      as[kk][m] = (r < p.t && k < p.o) ? lm[(size_t)r * p.ld + k] : 0.0f;
    }
    for (int e = tid; e < kBN * kBK; e += kPanelThreads) {
      const int c = e / kBK;
      const int kk = e % kBK;
      const int k = k0 + kk;
      bs[kk][c] = (col0 + c < p.w && k < p.o)
                      ? lm[(size_t)(p.o + col0 + c) * p.ld + k]
                      : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  float lsn = 0.0f, varn = 0.0f;
  const float* km = nullptr;
  if constexpr (kGram) {
    lsn = p.ls[n];
    varn = p.var[n];
  } else {
    km = p.k + (size_t)n * p.k_mat;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = ty * 4 + i;
    const int r = row0 + m;
    if (r >= p.t) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx * 4 + j;
      const int gc = p.o + col0 + c;
      if (col0 + c >= p.w) continue;
      float kv;
      if constexpr (kGram) {
        kv = gpvae::gram_value(p.code, tr[m], tc[c], mr[m], mc[c], lsn, varn,
                               p.noise, p.one_minus_noise, r == gc);
      } else {
        kv = km[(size_t)r * p.kld + gc];
      }
      lm[(size_t)r * p.ld + gc] = kv - acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(kPanelThreads)
gram_panel_kernel(PanelParams p) {
  panel_tile<true>(p, blockIdx.z, p.r0 + blockIdx.y * kBM, blockIdx.x * kBN);
}

__global__ void __launch_bounds__(kPanelThreads)
hist_panel_kernel(PanelParams p) {
  panel_tile<false>(p, blockIdx.z, p.r0 + blockIdx.y * kBM, blockIdx.x * kBN);
}

// trail_update: the tile over the lower-triangular tile pairs (i, j <= i)
// of the trailing square, one pair per blockIdx.x, row-major:
// x = i (i + 1) / 2 + j.  K is L itself (see gpvae_trail_update_f32).
__global__ void __launch_bounds__(kPanelThreads)
trail_update_kernel(PanelParams p) {
  const int x = blockIdx.x;
  int i = (int)((sqrtf(8.0f * x + 1.0f) - 1.0f) * 0.5f);
  while (i * (i + 1) / 2 > x) --i;  // float rounding, either way
  while ((i + 1) * (i + 2) / 2 <= x) ++i;
  const int j = x - i * (i + 1) / 2;
  panel_tile<false>(p, blockIdx.y, p.r0 + i * kBM, j * kBN);
}

// -- trail_panel -------------------------------------------------------------

constexpr int kTrailRows = 64;  // panel rows per block

// X[r, :] = P[r, :] Ld^-T for the 64 rows of one block, all NB columns,
// in place over P = L[r, o:o+NB].  The block reads its whole 64 x NB slab
// into shared memory before it writes any of it, and no other block reads
// those rows, so the in-place write is safe.  Ld^-1 (lower triangular,
// zeros above the diagonal) streams through in chunks of depth kBK; the
// full product is taken, zeros included, as the TPU's matmul does.
template <int NB>
__global__ void __launch_bounds__(kPanelThreads)
trail_panel_kernel(float* l, long long l_mat, int ld, const float* inv,
                   int o, int t) {
  constexpr int kGroups = NB / 64;  // float4 column groups a thread owns
  __shared__ __align__(16) float ps[NB][kTrailRows + 4];  // ps[k][m]
  __shared__ __align__(16) float bs[kBK][NB + 4];  // bs[k][c] = Ld^-1[c, k]

  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx*4 + 64 g .. + 3
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3
  const int row0 = o + NB + blockIdx.x * kTrailRows;
  float* lm = l + (size_t)n * l_mat;
  const float* im = inv + (size_t)n * NB * NB;

  for (int e = tid; e < kTrailRows * NB; e += kPanelThreads) {
    const int m = e / NB;
    const int k = e % NB;
    const int r = row0 + m;
    ps[k][m] = (r < t) ? lm[(size_t)r * ld + o + k] : 0.0f;
  }

  float acc[4][4 * kGroups] = {};
  for (int k0 = 0; k0 < NB; k0 += kBK) {
    for (int e = tid; e < NB * kBK; e += kPanelThreads) {
      const int c = e / kBK;
      const int kk = e % kBK;
      bs[kk][c] = im[(size_t)c * NB + k0 + kk];
    }
    __syncthreads();  // (the first time also the whole slab)
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a4 =
          *reinterpret_cast<const float4*>(&ps[k0 + kk][ty * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const float4 b4 =
            *reinterpret_cast<const float4*>(&bs[kk][tx * 4 + 64 * g]);
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            acc[i][4 * g + jj] = fmaf(av[i], bv[jj], acc[i][4 * g + jj]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= t) continue;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        lm[(size_t)r * ld + o + tx * 4 + 64 * g + jj] = acc[i][4 * g + jj];
      }
    }
  }
  // the strictly upper tile that mirrors these rows
  for (int e = tid; e < NB * kTrailRows; e += kPanelThreads) {
    const int c = e / kTrailRows;
    const int m = e % kTrailRows;
    if (row0 + m < t) lm[(size_t)(o + c) * ld + row0 + m] = 0.0f;
  }
}

// -- panel_solve -------------------------------------------------------------

constexpr int kMaxW = 128;
constexpr int kDiagPitch = kMaxW + 1;  // L_d rows: column reads conflict-free
constexpr int kSolveRows = 32;         // panel rows per block
constexpr int kLanesPerRow = 8;
constexpr int kPerLane = kMaxW / kLanesPerRow;  // columns a lane owns
constexpr int kSolveThreads = kSolveRows * kLanesPerRow;
constexpr size_t kSolveSmem =
    ((size_t)kMaxW * kDiagPitch + kMaxW) * sizeof(float);

struct SolveParams {
  float* l;
  long long l_mat;
  int ld;
  int o, w, t;
};

__global__ void __launch_bounds__(kSolveThreads)
panel_solve_kernel(SolveParams p) {
  extern __shared__ float smem[];
  float* dg = smem;                        // dg[k][c] = L[o + k, o + c]
  float* rdiag = smem + kMaxW * kDiagPitch;  // 1 / L_d[c, c]

  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  const int w = p.w;
  float* lm = p.l + (size_t)n * p.l_mat;
  const float* dm = lm + (size_t)p.o * p.ld + p.o;

  for (int e = tid; e < w * w; e += kSolveThreads) {
    const int k = e / w;
    const int c = e - k * w;
    if (c <= k) dg[k * kDiagPitch + c] = dm[(size_t)k * p.ld + c];
  }
  for (int c = tid; c < w; c += kSolveThreads) {
    rdiag[c] = 1.0f / dm[(size_t)c * p.ld + c];
  }

  // Row r = r0 + m solves x L_d^T = p by substitution, column after
  // column: x_c = p_c / L_d[c, c], then p_k -= x_c L_d[k, c] for k > c.
  // Its eight lanes (a warp holds four rows) keep the columns
  // k = q + 8 s in registers; x_c travels by a shuffle from its owner.
  const int m = tid / kLanesPerRow;
  const int q = tid % kLanesPerRow;
  const int r = p.o + p.w + blockIdx.x * kSolveRows + m;
  float* lr = lm + (size_t)r * p.ld + p.o;
  float v[kPerLane];
#pragma unroll
  for (int s = 0; s < kPerLane; ++s) {
    const int k = q + kLanesPerRow * s;
    v[s] = (r < p.t && k < w) ? lr[k] : 0.0f;
  }
  __syncthreads();  // L_d is in shared memory; every row read precedes a write

#pragma unroll
  for (int cb = 0; cb < kPerLane; ++cb) {
#pragma unroll
    for (int qq = 0; qq < kLanesPerRow; ++qq) {
      const int c = cb * kLanesPerRow + qq;
      if (c < w) {  // the same for every thread of the block
        const float x =
            __shfl_sync(0xffffffffu, v[cb] * rdiag[c], qq, kLanesPerRow);
        if (q == qq) v[cb] = x;
#pragma unroll
        for (int s = cb; s < kPerLane; ++s) {
          const int k = q + kLanesPerRow * s;
          if (s > cb || q > qq) {
            v[s] = fmaf(-x, dg[k * kDiagPitch + c], v[s]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int s = 0; s < kPerLane; ++s) {
    const int k = q + kLanesPerRow * s;
    if (r < p.t && k < w) lr[k] = v[s];
  }
  // the strictly upper tile that mirrors these rows
  const int r0 = p.o + p.w + blockIdx.x * kSolveRows;
  for (int e = tid; e < w * kSolveRows; e += kSolveThreads) {
    const int c = e / kSolveRows;
    const int mm = e - c * kSolveRows;
    if (r0 + mm < p.t) lm[(size_t)(p.o + c) * p.ld + r0 + mm] = 0.0f;
  }
}

}  // namespace

extern "C" {

// l: [n, t, t] at matrix stride l_mat, row stride ld; times/mask: [n,
// tlen]; ls/var: [n]; all float32 on the device.  Writes rows [r0, t) of
// columns [o, o + w).  Launches on `stream` and returns the cudaError_t
// of the launch (0 on success).
int gpvae_gram_panel_f32(void* l, long long l_mat, int ld, const void* times,
                         const void* mask, const void* ls, const void* var,
                         int tlen, int code, float noise,
                         float one_minus_noise, int r0, int o, int w, int t,
                         int n, void* stream) {
  if (n <= 0 || r0 >= t) return 0;
  if (!gpvae::valid_kernel_code(code) || w < 1 || o < 0 || o + w > t ||
      r0 < o || n > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  PanelParams p = {};
  p.l = (float*)l;
  p.l_mat = l_mat;
  p.ld = ld;
  p.times = (const float*)times;
  p.mask = (const float*)mask;
  p.ls = (const float*)ls;
  p.var = (const float*)var;
  p.tlen = tlen;
  p.code = code;
  p.noise = noise;
  p.one_minus_noise = one_minus_noise;
  p.r0 = r0;
  p.o = o;
  p.w = w;
  p.t = t;
  const dim3 grid((w + kBN - 1) / kBN, (t - r0 + kBM - 1) / kBM, n);
  gram_panel_kernel<<<grid, kPanelThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// l as above; k: [n, t, t] float32 at matrix stride k_mat and row stride
// kld, read only (it must not overlap l).  Writes rows [r0, t) of columns
// [o, o + w) of l.
int gpvae_hist_panel_f32(void* l, long long l_mat, int ld, const void* k,
                         long long k_mat, int kld, int r0, int o, int w,
                         int t, int n, void* stream) {
  if (n <= 0 || r0 >= t) return 0;
  if (w < 1 || o < 0 || o + w > t || r0 < o || n > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  PanelParams p = {};
  p.l = (float*)l;
  p.l_mat = l_mat;
  p.ld = ld;
  p.k = (const float*)k;
  p.k_mat = k_mat;
  p.kld = kld;
  p.r0 = r0;
  p.o = o;
  p.w = w;
  p.t = t;
  const dim3 grid((w + kBN - 1) / kBN, (t - r0 + kBM - 1) / kBM, n);
  hist_panel_kernel<<<grid, kPanelThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// l as above, its diagonal block [o, o + w)^2 holding the factor L_d.
// Writes rows [o + w, t) of columns [o, o + w) and zeros into rows
// [o, o + w) of columns [o + w, t).
int gpvae_panel_solve_f32(void* l, long long l_mat, int ld, int o, int w,
                          int t, int n, void* stream) {
  if (n <= 0 || o + w >= t) return 0;
  if (w < 1 || w > kMaxW || o < 0 || n > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t e = cudaFuncSetAttribute(
      panel_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSolveSmem);
  if (e != cudaSuccess) return (int)e;
  SolveParams p = {(float*)l, l_mat, ld, o, w, t};
  const dim3 grid((t - o - w + kSolveRows - 1) / kSolveRows, n);
  panel_solve_kernel<<<grid, kSolveThreads, kSolveSmem,
                       (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// One right-looking step at column o with a diagonal block of width nb in
// {64, 128}, already factored: rows [o + nb, t) of columns [o, o + nb) of
// l become X = P Ld^-T in place, with inv: [n, nb, nb] contiguous, the
// block's inverse; zeros go into rows [o, o + nb) of columns [o + nb, t).
int gpvae_trail_panel_f32(void* l, long long l_mat, int ld, const void* inv,
                          int o, int nb, int t, int n, void* stream) {
  if (n <= 0 || o + nb >= t) return 0;
  if ((nb != 64 && nb != 128) || o < 0 || n > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((t - o - nb + kTrailRows - 1) / kTrailRows, n);
  if (nb == 128) {
    trail_panel_kernel<128><<<grid, kPanelThreads, 0, (cudaStream_t)stream>>>(
        (float*)l, l_mat, ld, (const float*)inv, o, t);
  } else {
    trail_panel_kernel<64><<<grid, kPanelThreads, 0, (cudaStream_t)stream>>>(
        (float*)l, l_mat, ld, (const float*)inv, o, t);
  }
  return (int)cudaGetLastError();
}

// The same step's trailing downdate, in place: for the lower-triangular
// 64 x 64 tiles of the square [o + nb, t)^2,
//
//   L[r, c] -= sum_{o <= k < o + nb} L[r, k] L[c, k]
//
// with X = L[:, o:o+nb] as trail_panel left it.  It is the hist_panel
// tile with K = L and the history [o, o + nb): each element is read and
// written by one thread, and no block writes the X columns it reads.
// Tiles above the diagonal are not computed; the lower triangle of the
// square, and the next step's diagonal block and panel, lie in the lower
// tiles because nb is a multiple of 64.
int gpvae_trail_update_f32(void* l, long long l_mat, int ld, int o, int nb,
                           int t, int n, void* stream) {
  if (n <= 0 || o + nb >= t) return 0;
  if ((nb != 64 && nb != 128) || o < 0 || n > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  PanelParams p = {};
  p.l = (float*)l;
  p.l_mat = l_mat;
  p.ld = ld;
  p.k = (const float*)l;
  p.k_mat = l_mat;
  p.kld = ld;
  p.h0 = o;
  p.o = o + nb;
  p.r0 = o + nb;
  p.w = t - o - nb;
  p.t = t;
  const int tiles = (p.w + kBM - 1) / kBM;
  const dim3 grid(tiles * (tiles + 1) / 2, n);
  trail_update_kernel<<<grid, kPanelThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

const char* gpvae_cuda_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
