// panel_solve: the rows below a factored diagonal block of the blocked
// Cholesky (ops/blocked.py), solved against that block in place.
//
// For rows r in [o + w, T) of each matrix, once the diagonal block L_d =
// L[o:o+w, o:o+w] (w <= 128) is factored,
//
//   L[r, o:o+w] <- L[r, o:o+w] L_d^{-T}
//
// by substitution, and zeros into the mirrored upper tile L[o:o+w, r].  L
// is [n, T, T] at matrix stride l_mat and row stride ld; its rows need not
// start 16-byte aligned.  Only the lower triangle of L_d is read.
//
// Replaces the column step of the TPU kernels
// pallas_big._make_defer1_kernel (B9, the b = 1 step) and
// _make_defer_kernel (b >= 2: with the gram, and without it, B18), and
// the column work of pallas_big._init_kernel (B16) and _wb_kernel (B17).
// The TPU multiplies each column by the block's explicit inverse and
// defers that product into the next step's kernel, to save a pass over
// HBM on its in-order grid.  Here the column is finished in its own step,
// and it is solved, not multiplied: in float32 the explicit inverse left
// the factor 3-4x the library's error from the float64 factor at T =
// 256-1024, the substitution 1.5-2x (a CPU emulation of both on the same
// inputs).  d_j = 1 / L_d[j, j] by IEEE division, and each step multiplies
// by it, which may differ from a division in the last bit.
//
// What bounds it on Hopper: bytes.  At the T = 1024 middle step (o = 512,
// w = 128, n = 128: 384 rows a matrix) it reads and writes the panel and
// writes the zero tile, 80 MB, 0.0238 ms at 3.35 TB/s; its r w^2 / 2
// multiply-adds take 0.012 ms at the 67 TFLOP/s of float32 fma.  So the
// design fetches L_d once, streams the rows past it with the copies spread
// over the arithmetic, and keeps the arithmetic at a few shared loads per
// fma:
//
//   * L_d sits in shared memory column-major at chol_tile.cuh's pitch,
//     filled by fill_lower, with d_j in the slot under each column: once
//     per matrix a block works on;
//   * a block owns row tiles of kRows rows, row-major in shared memory
//     (pitch 132 = 33 float4, so that a float4 of eight consecutive rows
//     falls in eight distinct bank groups), and walks over a contiguous run
//     of the flat list of (matrix, tile) pairs: the grid is one wave of
//     the card, sized to it and not to the rows, and a matrix's rows are
//     spread over as many blocks as keep the SMs busy (64-row tiles where
//     128-row ones would leave the busiest block more rows);
//   * per 16-column panel of L_d: (a) the first kRows threads solve a row
//     of the tile each against the panel's diagonal tile, in registers
//     (chol_tile::solve_regs: L_d's column read as float4, the same for
//     every thread), and store its 16 columns, which are final, straight
//     from registers; meanwhile the other threads write the rows of the
//     zero tile that mirror those columns and issue a slice of the next
//     tile's cp.async copies (16 bytes where the panel's rows start
//     16-byte aligned, else 4; two buffers), so that every kind of memory
//     traffic spreads over the tile: issued in one burst, a tile's copies
//     and stores stalled the warps that issued them;
//   * (b) every warp updates the tile's columns to the right, P[:, c] -=
//     X_j L_d[c, j]^T over the panel's 16 columns j, in 8 x 4 register
//     tiles summed in registers and subtracted once, as
//     chol_tile::trailing sums;
//   * the zero tile is written with 16-byte stores where its rows are
//     aligned, and no index is divided per element.
// Plain float32 fma, no tensor cores: the operations take half the time
// of the bytes, and a 3xTF32 split would only add error.  On an H100 the
// kernel runs at about 2.4x its bound; per 128-row tile the update and
// the row solves took most of the time, and neither a look-ahead (the next
// panel solved while the rest is updated), bulk copies (TMA) for the rows
// and the zero tile, 4 x 4 or 8 x 8 register tiles, nor 256 or 1,024
// threads ran faster (PERF.md).

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>

#include "chol_tile.cuh"
#include "cp_async.cuh"

namespace {

namespace ct = gpvae::chol_tile;

constexpr int kMaxW = 128;
constexpr int kLdPitch = ct::pitch(kMaxW);  // L_d, column-major
constexpr int kTilePitch = kMaxW + 4;       // a tile row: 33 float4
constexpr int kChunks = kMaxW / 4;          // float4 chunks of a tile row
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

template <int kRows>
struct Shape {
  static constexpr int kTile = kRows * kTilePitch;  // floats of one buffer
  static constexpr size_t kSmem =
      (size_t)(kMaxW * kLdPitch + 2 * kTile) * sizeof(float);
};

struct Params {
  float* l;
  long long l_mat;
  int ld, o, w, t;
  int tiles;  // row tiles of a matrix
  int total;  // (matrix, tile) pairs
  int chunk;  // pairs a block
  int vec_p;  // the panel's rows start 16-byte aligned (column o)
  int vec_z;  // the zero tile's rows do (column o + w)
};

using gpvae::aligned16;
using gpvae::cp_async16;
using gpvae::cp_async4;
using gpvae::cp_async_commit;
using gpvae::cp_async_wait;

// Step (b) for the panel at c0: the tile's columns to its right, in
// `groups` groups of 16 (group g: columns c0 + 16 (1 + g) ..), P[r][c] -=
// sum_j X[r][c0+j] L_d[c][c0+j] for the kRows rows in `x`, the sum over j
// in registers, subtracted once.  A thread holds 8 rows x 4 columns, a warp
// 64 rows x 16 columns: lane (ri, ci) the rows ri + 8 a (a < 8) and the
// columns 4 ci + b (b < 4), so that a float4 load touches eight
// consecutive rows of the tile, or four consecutive chunks of a column of
// L_d: 32 fmas for every three float4 loads.
constexpr int kUpdRows = 8;  // rows of a thread's register tile

template <int kRows>
__device__ __forceinline__ void update(float* x, const float* lds, int c0,
                                       int groups) {
  constexpr int kRowTiles = kRows / (8 * kUpdRows);
  const int lane = threadIdx.x & 31;
  const int ri = lane & 7, ci = lane >> 3;
  for (int wt = threadIdx.x >> 5; wt < kRowTiles * groups; wt += kWarps) {
    const int k0 = c0 + ct::kNb * (1 + wt / kRowTiles) + 4 * ci;
    float* xr = x + ((wt % kRowTiles) * 8 * kUpdRows + ri) * kTilePitch;
    float acc[kUpdRows][4] = {};
#pragma unroll
    for (int q = 0; q < ct::kNb / 4; ++q) {
      float xv[kUpdRows][4];
#pragma unroll
      for (int a = 0; a < kUpdRows; ++a) {
        const float4 v = *reinterpret_cast<const float4*>(
            xr + 8 * a * kTilePitch + c0 + 4 * q);
        xv[a][0] = v.x, xv[a][1] = v.y, xv[a][2] = v.z, xv[a][3] = v.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 v = *reinterpret_cast<const float4*>(
            lds + (c0 + 4 * q + e) * kLdPitch + k0);
        const float lk[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int a = 0; a < kUpdRows; ++a) {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            acc[a][b] = fmaf(xv[a][e], lk[b], acc[a][b]);
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < kUpdRows; ++a) {
      float4* dst = reinterpret_cast<float4*>(xr + 8 * a * kTilePitch + k0);
      float4 v = *dst;
      v.x -= acc[a][0];
      v.y -= acc[a][1];
      v.z -= acc[a][2];
      v.w -= acc[a][3];
      *dst = v;
    }
  }
}

template <int kRows>
__global__ void __launch_bounds__(kThreads) panel_solve_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kTile = Shape<kRows>::kTile;
  float* lds = smem;                     // L_d, column-major, d_j below
  float* tiles = smem + kMaxW * kLdPitch;  // two row tiles
  const int tid = threadIdx.x;
  const int w = p.w;
  const int panels = (w + ct::kNb - 1) / ct::kNb;
  const int first = blockIdx.x * p.chunk;
  const int last = min(p.total, first + p.chunk);

  // pair idx: its matrix and its first row
  auto locate = [&](int idx, float*& lm, int& r0) {
    const int mat = idx / p.tiles;
    lm = p.l + (size_t)mat * p.l_mat;
    r0 = p.o + w + (idx - mat * p.tiles) * kRows;
    return mat;
  };
  // rows [m0, m1) of pair idx's tile into dst: floats [o, o + w) of each,
  // a row's last chunk past w and rows past t zero-filled by the copy
  auto fetch = [&](int idx, float* dst, int m0, int m1, int from) {
    float* lm;
    int r0;
    locate(idx, lm, r0);
    if (p.vec_p) {
      for (int e = m0 * kChunks + tid - from; e < m1 * kChunks;
           e += kThreads - from) {
        const int m = e / kChunks, q = e % kChunks;
        if (4 * q >= w) continue;
        const int r = r0 + m;
        const int bytes = r < p.t ? 4 * min(w - 4 * q, 4) : 0;
        cp_async16(dst + m * kTilePitch + 4 * q,
                   bytes ? lm + (size_t)r * p.ld + p.o + 4 * q : lm, bytes);
      }
    } else {
      for (int e = m0 * kMaxW + tid - from; e < m1 * kMaxW;
           e += kThreads - from) {
        const int m = e / kMaxW, c = e % kMaxW;
        if (c >= w) continue;
        const int r = r0 + m;
        const bool in = r < p.t;
        cp_async4(dst + m * kTilePitch + c,
                  in ? lm + (size_t)r * p.ld + p.o + c : lm, in ? 4 : 0);
      }
    }
  };
  // zeros into rows [o + c0, o + c0 + 16) (below w) of the zero tile at
  // pair idx's columns, 4 columns a thread, by the threads past the
  // solvers (tid >= kRows)
  auto zero = [&](int idx, int c0) {
    constexpr int kQuads = kRows / 4;
    float* lm;
    int r0;
    locate(idx, lm, r0);
    const int rows = min(ct::kNb, w - c0);
    for (int e = tid - kRows; e < rows * kQuads; e += kThreads - kRows) {
      const int c = c0 + e / kQuads;
      const int m = r0 + 4 * (e % kQuads);
      if (m >= p.t) continue;
      float* dst = lm + (size_t)(p.o + c) * p.ld + m;
      if (p.vec_z && m + 4 <= p.t) {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        for (int j = 0; j < 4 && m + j < p.t; ++j) dst[j] = 0.0f;
      }
    }
  };

  // (a) for the panel at c0, by the solver threads (tid < kRows), one row
  // a thread: its 16 columns are then final, so they go out from
  // registers, and into the tile for (b)
  auto solve = [&](float* cur, float* lm, int r0, int c0) {
    float* row = cur + tid * kTilePitch + c0;
    float a[ct::kNb];
#pragma unroll
    for (int q = 0; q < ct::kNb / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(row + 4 * q);
      a[4 * q] = v.x, a[4 * q + 1] = v.y, a[4 * q + 2] = v.z,
      a[4 * q + 3] = v.w;
    }
    ct::solve_regs(lds, kLdPitch, c0, a);
#pragma unroll
    for (int q = 0; q < ct::kNb / 4; ++q) {
      *reinterpret_cast<float4*>(row + 4 * q) =
          make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
    }
    if (r0 + tid >= p.t) return;
    float* dst = lm + (size_t)(r0 + tid) * p.ld + p.o + c0;
    if (p.vec_p && c0 + ct::kNb <= w) {
#pragma unroll
      for (int q = 0; q < ct::kNb / 4; ++q) {
        *reinterpret_cast<float4*>(dst + 4 * q) =
            make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < ct::kNb; ++k) {
        if (c0 + k < w) dst[k] = a[k];
      }
    }
  };

  if (first >= last) return;
  fetch(first, tiles, 0, kRows, 0);
  cp_async_commit();
  // Per panel: the first kRows threads solve a row each and store it,
  // while the others write the zero tile's rows that mirror those columns
  // and copy a slice of the next tile's rows (so that its requests spread
  // over the tile instead of stalling in one burst); then every warp
  // updates the columns to the right.
  const bool solver = tid < kRows;
  const int slice = (kRows + panels - 1) / panels;
  int mat_ld = -1;  // the matrix whose L_d is in shared memory
  for (int idx = first; idx < last; ++idx) {
    // the last tile's final barrier: the other buffer and L_d are free
    float* cur = tiles + ((idx - first) & 1) * kTile;
    float* next = tiles + ((idx + 1 - first) & 1) * kTile;
    float* lm;
    int r0;
    const int mat = locate(idx, lm, r0);
    if (mat != mat_ld) {
      const float* dm = lm + (size_t)p.o * p.ld + p.o;
      ct::fill_lower<kThreads>(lds, kLdPitch, w, [&](int i, int k) {
        return dm[(size_t)i * p.ld + k];
      });
      for (int j = tid; j < w; j += kThreads) {
        lds[j * kLdPitch + kLdPitch - 1] = 1.0f / dm[(size_t)j * p.ld + j];
      }
      mat_ld = mat;
    }
    cp_async_wait<0>();
    __syncthreads();  // the tile and L_d are in shared memory
    for (int jp = 0; jp < panels; ++jp) {
      const int c0 = jp * ct::kNb;
      if (solver) {
        solve(cur, lm, r0, c0);
      } else {
        zero(idx, c0);
        if (idx + 1 < last) {
          fetch(idx + 1, next, jp * slice, min(kRows, (jp + 1) * slice),
                kRows);
        }
      }
      if (jp + 1 < panels) {
        __syncthreads();
        update<kRows>(cur, lds, c0, panels - jp - 1);
      }
      __syncthreads();
    }
    cp_async_commit();
  }
}

// the rows the busiest block takes with tiles of `rows`, one block an SM
long long busiest(int r, int n, int rows, int sms) {
  const long long total = (long long)n * ((r + rows - 1) / rows);
  const long long blocks = std::min<long long>(total, sms);
  return (total + blocks - 1) / blocks * rows;
}

template <int kRows>
int launch(Params p, int n, int sms, void* stream) {
  using S = Shape<kRows>;
  const long long tiles = (p.t - p.o - p.w + kRows - 1) / kRows;
  if (tiles * n > INT_MAX) return (int)cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  p.total = (int)(tiles * n);
  const int blocks = std::min(p.total, sms);
  p.chunk = (p.total + blocks - 1) / blocks;
  const int grid = (p.total + p.chunk - 1) / p.chunk;
  const cudaError_t e = cudaFuncSetAttribute(
      panel_solve_kernel<kRows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)S::kSmem);
  if (e != cudaSuccess) return (int)e;
  panel_solve_kernel<kRows>
      <<<grid, kThreads, S::kSmem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// l: [n, t, t] float32 on the device at matrix stride l_mat and row stride
// ld, its diagonal block [o, o + w)^2 holding the factor L_d.  Writes rows
// [o + w, t) of columns [o, o + w) and zeros into rows [o, o + w) of
// columns [o + w, t).  Launches on `stream` and returns the cudaError_t of
// the launch (0 on success).
int gpvae_panel_solve_f32(void* l, long long l_mat, int ld, int o, int w,
                          int t, int n, void* stream) {
  if (n <= 0 || o + w >= t) return 0;
  if (w < 1 || w > kMaxW || o < 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return (int)e;
  Params p = {};
  p.l = (float*)l;
  p.l_mat = l_mat;
  p.ld = ld;
  p.o = o;
  p.w = w;
  p.t = t;
  p.vec_p = aligned16(l, l_mat, ld, o);
  p.vec_z = aligned16(l, l_mat, ld, o + w);
  const int r = t - o - w;
  return busiest(r, n, 128, sms) <= busiest(r, n, 64, sms)
             ? launch<128>(p, n, sms, stream)
             : launch<64>(p, n, sms, stream);
}

const char* gpvae_cuda_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
