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
// The rows below each factored diagonal block are solved against it by
// another kernel, panel_solve (K3, csrc/panel_solve.cu).
//
// gram_panel replaces the panel half of the TPU kernels
// pallas_big._make_defer1_kernel (B9, the b = 1 step) and
// _make_defer_kernel with the gram (B10, b >= 2).  hist_panel replaces
// the pre-built-gram history kernels: pallas_big._hist_kernel (B14) and
// _hist2_kernel (B15, the same panel split in two outputs), the panel half
// of _make_defer_kernel without the gram (B18), and
// pallas_left._make_kernel (B19, the streamed panel of the 64 < T < 768
// route); with chol_block and panel_solve it also does the work of
// pallas_big._init_kernel (B16) and _wb_kernel (B17).  The TPU cuts the
// panel into VMEM-sized slabs on its in-order grid; here blocks run in
// parallel over 128 x 128 tiles of it.
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
//                      64 x 64 tiles only (the panel tile, K = L, history
//                      [o, o+nb)).
//
// The TPU kernel does both in one grid: row tiles run in order and each
// finished X tile waits in a VMEM scratch for the downdates of the later
// ones.  Blocks on the card run in no order and share nothing, so X is
// finished by one launch before the next reads it, on the same stream;
// recomputing X rows in each downdate block instead would triple the
// work.  X is multiplied by the explicit inverse, as on the TPU, which in
// float32 costs 3-4x the library's factor error (see panel_solve.cu):
// "auto" never takes this route.
//
// What bounds them on Hopper.  The panel is the factorization's floating
// point work (n T^3 / 3 over all steps: 46 GFLOP at T = 1024, n = 128), a
// batched product with a history depth of up to T - 128: at the T = 1024
// middle step (o = 512, w = 128, n = 128) 8.6 GFLOP against 35 MB, bound
// by operations (0.129 ms at the 67 TFLOP/s of plain float32 FMA, 0.052
// ms for the three TF32 products below at 495 TFLOP/s).  The trailing
// downdate is the same tile at depth nb; X against the triangular Ld^-1
// needs 1.1 GFLOP against 104 MB (the panel read, X and the zero tile
// written), bound by bytes (0.031 ms at 3.35 TB/s).
//
// The panel tile (panel_tile) runs on the tensor cores in 3xTF32: each
// float32 operand x is split into TF32 parts hi = rna(x) and lo = rna(x -
// hi), x to 2^-22 |x| (rounding both keeps the split unbiased; a truncated
// one biased a panel's diagonal, a sum of squares, by 2^-20 a term), and
// a b is taken as al bh + ah bl + ah bh by wgmma (m64nNk8, TF32 inputs,
// float32 sums), the al bl term (2^-22 of |a b|) dropped.  Plain TF32 (ah
// bh alone) keeps 11 bits of each operand; the covariance path stays
// float32.  The tensor cores' float32 sum truncates,
// which over a depth of 900 biases it and left the pre-built
// factorization at T = 1024 several times the library's float32 error.
// So each 32-deep stage's twelve products sum into fresh registers, which
// an ordinary (rounding) float32 add takes into the tile's sum (python -m
// gpvae_tpu_torch.ops.split_emulation emulates the tile's sums on the
// CPU).  The order of that sum matters as much: a Cholesky factor's
// columns shrink with its Schur complement, so the history's first
// columns hold its largest products, and K - sum cancels down to the
// Schur complement.  On a near-low-rank gram (T = 4096, lengthscale 256
// over a span of 60, cond ~4e6) a sum taken first column first, into a
// total of K's size to which every later stage adds its small part, left
// the pre-built factor at 3.5x cuSOLVER's float32 error on an H100, and
// the plain route (cuBLAS products) at 3.2-3.5x.  So in gram_panel and
// hist_panel the stages run from the history's last columns back to its
// first, and its first kBK columns, the largest products, are summed
// apart by float32 fma (exact products, where 3xTF32 keeps 2^-22 of each)
// and added last: in the CPU emulation 0.53x the library's error on that
// gram, against 2.6x.  trail_update's depth is one block's columns of X,
// which no such order ranks: it keeps every stage on the tensor cores,
// first column first (summed last first it took the right-looking factor
// past its band on an H100).
// A stage is 32 k, one 128-byte row of each of the tile's BM + BN rows of
// L.  Stages arrive through a 4-stage ring of cp.async copies (16 bytes
// where a row starts 16-byte aligned, else 4, in the same kernel; past
// the history's end, T or w zero-filled by the copy itself), in the
// 128-byte swizzle that wgmma reads without bank conflicts.  One pass over
// a landed stage splits each element once, hi in place and lo into one of
// two planes of the same layout; the split of stage s + 1 runs while the
// tensor cores multiply stage s, with the loads of stage s + 3 in flight.
// gram_panel and hist_panel take 128 x 128 tiles, two warpgroups of 64
// rows: the w = 128 panel is one block column, so each history row is
// fetched once per row block.  trail_update takes 64 x 64 tiles, one
// warpgroup: its tile pairs (i, j <= i) must not write above the diagonal
// outside a block of width nb, which at nb = 64 a 128-wide tile would do.
// The epilogue goes through shared memory, so that K is built
// (gram.cuh) or read, and K - sum stored, 16 bytes a thread.
//
// trail_panel is a streaming kernel in plain float32 FMA.  Its product
// with the explicit inverse cancels (the terms |P| |Ld^-T| dwarf X), which
// the panel's 3xTF32 (2^-22 an operand) magnifies: that took the
// blocked_fused factor past its band on the card, and six TF32 products
// of three parts, as accurate as float32, ran slower than this loop.  A
// block holds Ld^-1 transposed, its lower triangle and zeros above, in
// shared memory for all of its 64-row tiles of one matrix; each tile of P
// is stored transposed for the loop while the next one's loads are in
// flight in registers.  A thread computes 4 rows x 8 columns from k-major
// operands (16-byte shared loads); a warp's columns are the groups wc and
// 7 - wc of NB / 8, so that every warp's loop over the triangle (k <= c,
// half the full product) is as long.  X goes over P's rows, which no other
// block reads and which the tile already holds, and the zero tile is
// written with 16-byte stores.  Two blocks fit on an SM, and the grid is
// one wave of them.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "cp_async.cuh"
#include "gram.cuh"
#include "tf32_wgmma.cuh"

namespace {

// -- building blocks: cp.async (cp_async.cuh), the TF32 split and wgmma ------
// (tf32_wgmma.cuh)

using gpvae::aligned16;
using gpvae::cp_async16;
using gpvae::cp_async4;
using gpvae::cp_async_commit;
using gpvae::cp_async_wait;
using gpvae::smem_addr;
using gpvae::fence_proxy_async;
using gpvae::fence_reg;
using gpvae::smem_desc_sw128;
using gpvae::split2;
using gpvae::wgmma_commit;
using gpvae::wgmma_fence;
using gpvae::wgmma_m64n128k8;
using gpvae::wgmma_m64n64k8;
using gpvae::wgmma_wait_all;

// rows x 32 floats into shared memory in the 128-byte swizzle (chunk j of
// row i at chunk j ^ (i % 8) of the row's 128 bytes), asynchronously.
// row(i, src, valid) gives row i's first element in global memory and how
// many of its 32 floats are real; the rest, and rows with valid = 0, are
// zero-filled by the copy.  vec: every src + 4j is 16-byte aligned, so
// 16-byte copies; else 4-byte ones.
template <int kRows, int kThreads, class RowFn>
__device__ __forceinline__ void copy_rows_sw128(float* dst, bool vec,
                                                RowFn row) {
  if (vec) {
    constexpr int kChunks = kRows * 8;
#pragma unroll
    for (int i = 0; i < kChunks / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = e / 8, j = e % 8;
      const float* src;
      int valid;
      row(r, src, valid);
      const int bytes = 4 * min(max(valid - 4 * j, 0), 4);
      cp_async16(dst + r * 32 + ((j ^ (r & 7)) * 4), bytes ? src + 4 * j : src,
                 bytes);
    }
  } else {
    constexpr int kChunks = kRows * 32;
#pragma unroll 4
    for (int i = 0; i < kChunks / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = e / 32, k = e % 32;
      const float* src;
      int valid;
      row(r, src, valid);
      const int bytes = k < valid ? 4 : 0;
      cp_async4(dst + r * 32 + (((k / 4) ^ (r & 7)) * 4) + k % 4,
                bytes ? src + k : src, bytes);
    }
  }
}

// -- the panel tile: gram_panel, hist_panel, trail_update ---------------------

constexpr int kBK = 32;   // history depth per stage: one 128-byte row
constexpr int kStages = 4;

// a block tile of BM x BN outputs: BM / 64 warpgroups, each 64 rows x BN
template <int BM, int BN>
struct TileShape {
  static constexpr int kBM = BM, kBN = BN;
  static constexpr int kThreads = 2 * BM;  // 128 a warpgroup
  static constexpr int kAcc = BN / 2;      // accumulators a thread
  // a stage: the BM rows of the first operand, then the BN of the second
  static constexpr int kStageFloats = (BM + BN) * kBK;
  // the ring (its stages hold the high parts once split), two planes of
  // low parts, the gram's time vectors of the tile's rows and columns,
  // and room to align the ring to 1024 bytes
  static constexpr size_t kSmem =
      (size_t)((kStages + 2) * kStageFloats + 2 * (BM + BN)) *
          sizeof(float) + 1024;
  static_assert(BM % 64 == 0 && (BN == 64 || BN == 128), "tile");
};
using PanelTile = TileShape<128, 128>;  // gram_panel, hist_panel
using TrailTile = TileShape<64, 64>;    // trail_update

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t a,
                                           uint64_t b, int scale_d) {
  if constexpr (BN == 128) {
    wgmma_m64n128k8(d, a, b, scale_d);
  } else {
    wgmma_m64n64k8(d, a, b, scale_d);
  }
}

struct PanelParams {
  float* l;
  long long l_mat;
  int ld;
  int vec;      // L's rows 16-byte aligned at column h0 (the copies)
  int out_vec;  // ... and at column o, and K's where it is read (the
                // epilogue's loads and stores)
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

// K from the bank, not from the time vectors
constexpr int kFromBank = -1;

// L[r, c] = K[r, c] - acc for the tile's outputs, K built with kernel code
// kCode from the time vectors or, for kFromBank, read from the bank.
// Accumulator i of a thread of warpgroup wg, warp w (of 4), lane (g, q)
// holds row 64 wg + 16 w + g (+ 8 if i & 2), column 8 (i / 4) + 2 q (+ 1
// if odd); the tile goes through shared memory (`stage`, free by now) so
// that K is read and L written 16 bytes a thread, a row's 128 bytes by
// eight threads.
template <int kCode, class S>
__device__ __forceinline__ void store_tile(const PanelParams& p, int n,
                                           int row0, int col0,
                                           const float (&acc)[S::kAcc],
                                           float* stage, const float* tr,
                                           const float* mr, const float* tc,
                                           const float* mc) {
  constexpr int BM = S::kBM, BN = S::kBN, kOut = BN + 4;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int i = 0; i < S::kAcc; i += 2) {
    const int m = (warp / 4) * 64 + (warp % 4) * 16 + g + 8 * ((i >> 1) & 1);
    const int c = 8 * (i / 4) + 2 * q;
    *reinterpret_cast<float2*>(stage + m * kOut + c) =
        make_float2(acc[i], acc[i + 1]);
  }
  __syncthreads();

  float lsn = 0.0f, varn = 0.0f;
  const float* km = nullptr;
  if constexpr (kCode == kFromBank) {
    km = p.k + (size_t)n * p.k_mat;
  } else {
    lsn = p.ls[n];
    varn = p.var[n];
  }
  float* lw = p.l + (size_t)n * p.l_mat;
  for (int e = tid; e < BM * BN / 4; e += S::kThreads) {
    const int m = e / (BN / 4), c = (e % (BN / 4)) * 4;
    const int r = row0 + m;
    if (r >= p.t || col0 + c >= p.w) continue;
    const int gc = p.o + col0 + c;
    const float4 a = *reinterpret_cast<const float4*>(stage + m * kOut + c);
    const float av[4] = {a.x, a.y, a.z, a.w};
    float kv[4];
    float* dst = lw + (size_t)r * p.ld + gc;
    const bool whole = p.out_vec && col0 + c + 4 <= p.w;
    if constexpr (kCode == kFromBank) {
      const float* src = km + (size_t)r * p.kld + gc;
      if (whole) {
        const float4 k4 = *reinterpret_cast<const float4*>(src);
        kv[0] = k4.x;
        kv[1] = k4.y;
        kv[2] = k4.z;
        kv[3] = k4.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kv[j] = (col0 + c + j < p.w) ? src[j] : 0.0f;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = gpvae::gram_value(kCode, tr[m], tc[c + j], mr[m], mc[c + j],
                                  lsn, varn, p.noise, p.one_minus_noise,
                                  r == gc + j);
      }
    }
    if (whole) {
      *reinterpret_cast<float4*>(dst) = make_float4(
          kv[0] - av[0], kv[1] - av[1], kv[2] - av[2], kv[3] - av[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (col0 + c + j < p.w) dst[j] = kv[j] - av[j];
      }
    }
  }
}

// One S::kBM x S::kBN tile of the panel of matrix n, rows row0 .., panel
// columns col0 .. (of 0 .. w); kGram says where K comes from.  The history
// runs over columns [h0, o); kFactor: it is a factor's columns to the
// left of the panel, largest first, summed in the order of the top of
// this file.
template <bool kGram, bool kFactor, class S>
__device__ __forceinline__ void panel_tile(const PanelParams& p, int n,
                                           int row0, int col0,
                                           float* smem_raw) {
  constexpr int BM = S::kBM, BN = S::kBN;
  float* ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* lo = ring + kStages * S::kStageFloats;  // two planes of low parts
  float* tr = lo + 2 * S::kStageFloats;          // the gram's time vectors
  float* mr = tr + BM;
  float* tc = mr + BM;
  float* mc = tc + BN;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const float* lm = p.l + (size_t)n * p.l_mat;

  if constexpr (kGram) {
    const size_t vb = (size_t)n * p.tlen;
    for (int i = tid; i < BM + BN; i += S::kThreads) {
      if (i < BM) {
        const int r = row0 + i;
        tr[i] = (r < p.t) ? p.times[vb + r] : 0.0f;
        mr[i] = (r < p.t) ? p.mask[vb + r] : 0.0f;
      } else {
        const int c = col0 + i - BM;
        tc[i - BM] = (c < p.w) ? p.times[vb + p.o + c] : 0.0f;
        mc[i - BM] = (c < p.w) ? p.mask[vb + p.o + c] : 0.0f;
      }
    }
  }

  // with kFactor the history's first kBK columns [h0, h1) are summed by
  // fma at the end, and the tensor cores take [h1, o) a stage at a time
  // from the last columns back; else they take it all, first to last.
  // Stage s is rows 0..BM-1 L[row0 + m, k0 ..], rows BM.. L[o + col0 + c,
  // k0 ..], for k0 = h1 + (stages - 1 - s) kBK (kFactor) or h1 + s kBK,
  // in the 128-byte swizzle; past o, t or w zero-filled.  With kFactor
  // one more, s = stages, brings [h0, h1) for the fma.
  const int h1 = kFactor ? min(p.h0 + kBK, p.o) : p.h0;
  const int stages = (p.o - h1 + kBK - 1) / kBK;
  auto load_stage = [&](int s) {
    if (s > stages || (s == stages && !kFactor)) return;
    const bool first = s == stages;
    const int k0 = first ? p.h0 : h1 + (kFactor ? stages - 1 - s : s) * kBK;
    const int depth = (first ? h1 : p.o) - k0;
    float* st = ring + (s % kStages) * S::kStageFloats;
    copy_rows_sw128<BM + BN, S::kThreads>(
        st, p.vec != 0, [&](int i, const float*& src, int& valid) {
          const bool is_row = i < BM;
          const int rr = is_row ? row0 + i : p.o + col0 + (i - BM);
          const bool ok = is_row ? rr < p.t : col0 + (i - BM) < p.w;
          src = ok ? lm + (size_t)rr * p.ld + k0 : lm;
          valid = ok ? depth : 0;
        });
  };
  // each element of stage s split once into TF32 parts, x = hi + lo +
  // (2^-22 |x|): hi over x in place, lo at the same place in a plane
  auto split_stage = [&](int s) {
    float* st = ring + (s % kStages) * S::kStageFloats;
    float* pl = lo + (s % 2) * S::kStageFloats;
    constexpr int kQuads = S::kStageFloats / 4;
#pragma unroll
    for (int e = tid; e < kQuads; e += S::kThreads) {
      float4 v = *reinterpret_cast<const float4*>(st + 4 * e);
      float4 l4;
      split2(v.x, v.x, l4.x);
      split2(v.y, v.y, l4.y);
      split2(v.z, v.z, l4.z);
      split2(v.w, v.w, l4.w);
      *reinterpret_cast<float4*>(st + 4 * e) = v;
      *reinterpret_cast<float4*>(pl + 4 * e) = l4;
    }
    fence_proxy_async();
  };

  float acc[S::kAcc] = {};
  float d[S::kAcc];
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    load_stage(s);
    cp_async_commit();
  }
  if (stages > 0) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage 0 landed
    split_stage(0);
    __syncthreads();  // and is split
  }
  for (int s = 0; s < stages; ++s) {
    // stage s on the tensor cores: a b = al bh + ah bl + ah bh (al bl
    // dropped), its twelve products into d, which an ordinary float32 add
    // rounds into acc (see the top); meanwhile stage s + 1 is split
    const float* sh = ring + (s % kStages) * S::kStageFloats;
    const float* sl = lo + (s % 2) * S::kStageFloats;
#pragma unroll
    for (int i = 0; i < S::kAcc; ++i) fence_reg(d[i]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 8; ++ks) {
      const int a_at = wg * 64 * kBK + ks * 8;  // k offset in the row
      const int b_at = BM * kBK + ks * 8;
      const uint64_t ah = smem_desc_sw128(sh + a_at);
      const uint64_t al = smem_desc_sw128(sl + a_at);
      const uint64_t bh = smem_desc_sw128(sh + b_at);
      const uint64_t bl = smem_desc_sw128(sl + b_at);
      wgmma_tile<BN>(d, al, bh, ks > 0);
      wgmma_tile<BN>(d, ah, bl, 1);
      wgmma_tile<BN>(d, ah, bh, 1);
    }
    wgmma_commit();
    if (s + 1 < stages) {
      cp_async_wait<kStages - 3>();
      __syncthreads();  // stage s + 1 landed
      split_stage(s + 1);
    }
    __syncthreads();  // stage s + 1 split; stage s - 1's buffer is free
    load_stage(s + kStages - 1);
    cp_async_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < S::kAcc; ++i) {
      fence_reg(d[i]);
      acc[i] += d[i];
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the time vectors, where no stage ran
  if constexpr (kFactor) {
    // the first columns, raw in the ring since stage `stages` landed, by
    // fma, added last.  Accumulator i of this thread is row 64 wg + 16 w
    // + g + 8 ((i >> 1) & 1), column 8 (i / 4) + 2 q + (i & 1) of the
    // tile, as store_tile reads it: stage rows ra (+ 8) and BM + column
    const float* st = ring + (stages % kStages) * S::kStageFloats;
    const int lane = tid % 32, g = lane / 4, q = lane % 4;
    const int ra = wg * 64 + (tid / 32 % 4) * 16 + g;
    auto at = [](int r, int k) {  // the swizzle of copy_rows_sw128
      return r * kBK + (((k >> 2) ^ (r & 7)) << 2) + (k & 3);
    };
    float f[S::kAcc] = {};
    for (int k = 0; k < h1 - p.h0; ++k) {
      const float a0 = st[at(ra, k)], a1 = st[at(ra + 8, k)];
#pragma unroll
      for (int j = 0; j < S::kAcc / 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float b = st[at(BM + 8 * j + 2 * q + e, k)];
          f[4 * j + e] = fmaf(a0, b, f[4 * j + e]);
          f[4 * j + 2 + e] = fmaf(a1, b, f[4 * j + 2 + e]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < S::kAcc; ++i) acc[i] += f[i];
    __syncthreads();  // the ring stages the epilogue next
  }

  auto store = [&](auto code) {
    store_tile<decltype(code)::value, S>(p, n, row0, col0, acc, ring, tr, mr,
                                         tc, mc);
  };
  using std::integral_constant;
  if constexpr (kGram) {
    // one epilogue for each kernel family, the code a constant in it
    switch (p.code) {
      case gpvae::kRbf:
        store(integral_constant<int, gpvae::kRbf>());
        break;
      case gpvae::kMatern12:
        store(integral_constant<int, gpvae::kMatern12>());
        break;
      case gpvae::kMatern32:
        store(integral_constant<int, gpvae::kMatern32>());
        break;
      case gpvae::kMatern52:
        store(integral_constant<int, gpvae::kMatern52>());
        break;
      case gpvae::kCauchy:
        store(integral_constant<int, gpvae::kCauchy>());
        break;
      default:
        store(integral_constant<int, gpvae::kCosine>());
    }
  } else {
    store(integral_constant<int, kFromBank>());
  }
}

__global__ void __launch_bounds__(PanelTile::kThreads)
gram_panel_kernel(PanelParams p) {
  extern __shared__ __align__(128) float smem[];
  panel_tile<true, true, PanelTile>(p, blockIdx.z,
                                    p.r0 + blockIdx.y * PanelTile::kBM,
                                    blockIdx.x * PanelTile::kBN, smem);
}

__global__ void __launch_bounds__(PanelTile::kThreads)
hist_panel_kernel(PanelParams p) {
  extern __shared__ __align__(128) float smem[];
  panel_tile<false, true, PanelTile>(p, blockIdx.z,
                                     p.r0 + blockIdx.y * PanelTile::kBM,
                                     blockIdx.x * PanelTile::kBN, smem);
}

// trail_update: the tile over the lower-triangular tile pairs (i, j <= i)
// of the trailing square, one pair per blockIdx.x, row-major:
// x = i (i + 1) / 2 + j.  K is L itself (see gpvae_trail_update_f32).
__global__ void __launch_bounds__(TrailTile::kThreads)
trail_update_kernel(PanelParams p) {
  extern __shared__ __align__(128) float smem[];
  const int x = blockIdx.x;
  int i = (int)((sqrtf(8.0f * x + 1.0f) - 1.0f) * 0.5f);
  while (i * (i + 1) / 2 > x) --i;  // float rounding, either way
  while ((i + 1) * (i + 2) / 2 <= x) ++i;
  const int j = x - i * (i + 1) / 2;
  panel_tile<false, false, TrailTile>(p, blockIdx.y,
                                      p.r0 + i * TrailTile::kBM,
                                      j * TrailTile::kBN, smem);
}

// -- trail_panel -------------------------------------------------------------

constexpr int kTrailRows = 64;      // rows of P a tile
constexpr int kTrailThreads = 256;  // 2 x 4 warps
constexpr int kTrailPerSM = 2;      // blocks an SM holds (shared memory)

// N (4 or 2) consecutive floats from shared memory, or to global memory,
// in one access (16- or 8-byte aligned)
template <int N>
__device__ __forceinline__ void load_f(float* v, const float* src) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(src);
    v[0] = x.x, v[1] = x.y;
  }
}

template <int N>
__device__ __forceinline__ void store_f(float* dst, const float* v) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  }
}

template <int NB>
struct TrailPanelShape {
  static constexpr int kLPitch = NB + 4;          // lt[k][c]
  static constexpr int kPPitch = kTrailRows + 4;  // pt[k][r]
  static constexpr int kGroup = NB / 8;   // columns of a group: a warp
  static constexpr int kCols = kGroup / 4;  // owns two, a lane kCols of each
  // the registers that carry the next tile: 4 floats per row and chunk
  static constexpr int kChunks = kTrailRows * NB / 4 / kTrailThreads;
  static constexpr size_t kSmem =
      (size_t)(NB * kLPitch + NB * kPPitch) * sizeof(float);
};

// X[r, c] = sum_{k <= c} P[r, k] Ld^-1[c, k] over the 64-row tiles
// blockIdx.x, blockIdx.x + gridDim.x, .. of matrix blockIdx.y, in place
// over P = L[o + nb + ..., o:o+NB], and zeros into the mirrored upper
// tile.  vec_l: L's rows are 16-byte aligned at column o (and o + NB).
// Float32 FMA: both operands k-major in shared memory, lt[k][c] =
// Ld^-1[c, k] (0 for k > c) once per block, and pt[k][r] = P[r, k] for
// the current tile, whose successor waits in registers meanwhile.  A
// thread holds 4 rows x 2 kCols columns; warp (wr, wc) owns rows wr 32 ..
// and the column groups wc and 7 - wc, so that every warp's k loop over
// the triangle (to its groups' last column) is as long.
template <int NB>
__global__ void __launch_bounds__(kTrailThreads, kTrailPerSM)
trail_panel_kernel(float* l, long long l_mat, int ld, const float* inv,
                   int o, int t, int vec_l) {
  using S = TrailPanelShape<NB>;
  constexpr int LP = S::kLPitch, PP = S::kPPitch, C = S::kCols;
  extern __shared__ __align__(16) float smem[];
  float* lt = smem;
  float* pt = smem + NB * LP;

  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wr = warp / 4, wc = warp % 4;
  const int rq = lane % 8, cq = lane / 8;
  float* lm = l + (size_t)n * l_mat;
  const float* im = inv + (size_t)n * NB * NB;
  const int first = o + NB;  // P's first row
  const int tiles = (t - first + kTrailRows - 1) / kTrailRows;
  const int step = gridDim.x;

  // lt from Ld^-1 (row-major, c = row), a lane a row so that the stores
  // are consecutive
  for (int e = tid; e < NB * NB / 4; e += kTrailThreads) {
    const int c = e % NB, k = (e / NB) * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lt[(k + j) * LP + c] = (k + j <= c) ? im[(size_t)c * NB + k + j] : 0.0f;
    }
  }

  // chunk i of a thread: row m = (tid + i kTrailThreads) % 64, floats 4 kc
  // .. 4 kc + 3 of its NB; rows past t read as 0
  float4 next[S::kChunks];
  auto fetch = [&](int tile) {
    const int row0 = first + tile * kTrailRows;
#pragma unroll
    for (int i = 0; i < S::kChunks; ++i) {
      const int e = tid + i * kTrailThreads;
      const int m = e % kTrailRows, kc = e / kTrailRows;
      const int r = row0 + m;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < t) {
        const float* src = lm + (size_t)r * ld + o + 4 * kc;
        if (vec_l) {
          v = *reinterpret_cast<const float4*>(src);
        } else {
          v = make_float4(src[0], src[1], src[2], src[3]);
        }
      }
      next[i] = v;
    }
  };
  auto put = [&]() {  // the fetched tile into pt, a lane a row
#pragma unroll
    for (int i = 0; i < S::kChunks; ++i) {
      const int e = tid + i * kTrailThreads;
      const int m = e % kTrailRows, kc = e / kTrailRows;
      pt[(4 * kc + 0) * PP + m] = next[i].x;
      pt[(4 * kc + 1) * PP + m] = next[i].y;
      pt[(4 * kc + 2) * PP + m] = next[i].z;
      pt[(4 * kc + 3) * PP + m] = next[i].w;
    }
  };

  const int ga = wc * S::kGroup + cq * C;        // the lane's columns in
  const int gb = (7 - wc) * S::kGroup + cq * C;  // groups wc and 7 - wc
  const int end_a = (wc + 1) * S::kGroup;        // k runs to these
  const int end_b = (8 - wc) * S::kGroup;
  const int r0 = wr * 32 + rq * 4;               // the lane's 4 rows

  int tile = blockIdx.x;
  if (tile < tiles) fetch(tile);
  for (; tile < tiles; tile += step) {
    __syncthreads();  // lt is whole; every warp is done with pt
    put();
    __syncthreads();
    if (tile + step < tiles) fetch(tile + step);  // in flight meanwhile

    // k below group wc's end feeds both groups, then group 7 - wc alone
    float acc[4][2 * C] = {};
    int k = 0;
    for (; k < end_a; ++k) {
      float pv[4], lv[2 * C];
      load_f<4>(pv, &pt[k * PP + r0]);
      load_f<C>(lv, &lt[k * LP + ga]);
      load_f<C>(lv + C, &lt[k * LP + gb]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 2 * C; ++j) {
          acc[i][j] = fmaf(pv[i], lv[j], acc[i][j]);
        }
      }
    }
    for (; k < end_b; ++k) {
      float pv[4], lv[C];
      load_f<4>(pv, &pt[k * PP + r0]);
      load_f<C>(lv, &lt[k * LP + gb]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < C; ++j) {
          acc[i][C + j] = fmaf(pv[i], lv[j], acc[i][C + j]);
        }
      }
    }

    const int row0 = first + tile * kTrailRows;
    // X over P: this tile's rows are in pt and no other block reads them
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + r0 + i;
      if (r >= t) continue;
      float* dst = lm + (size_t)r * ld + o;
      if (vec_l) {
        store_f<C>(dst + ga, acc[i]);
        store_f<C>(dst + gb, acc[i] + C);
      } else {
#pragma unroll
        for (int j = 0; j < C; ++j) {
          dst[ga + j] = acc[i][j];
          dst[gb + j] = acc[i][C + j];
        }
      }
    }
    // the strictly upper tile that mirrors these rows
    if (vec_l) {
      constexpr int kQuads = kTrailRows / 4;
      for (int e = tid; e < NB * kQuads; e += kTrailThreads) {
        const int c = e / kQuads;
        const int m = (e - c * kQuads) * 4;
        float* dst = &lm[(size_t)(o + c) * ld + row0 + m];
        if (row0 + m + 3 < t) {
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
        } else {
          for (int j = 0; row0 + m + j < t; ++j) dst[j] = 0.0f;
        }
      }
    } else {
      for (int e = tid; e < NB * kTrailRows; e += kTrailThreads) {
        const int c = e / kTrailRows;
        const int m = e - c * kTrailRows;
        if (row0 + m < t) lm[(size_t)(o + c) * ld + row0 + m] = 0.0f;
      }
    }
  }
}

// launches a panel-tile kernel over `grid` with its dynamic shared memory
template <class S>
int launch_panel(void (*kernel)(PanelParams), const PanelParams& p,
                 const dim3& grid, void* stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, S::kThreads, S::kSmem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <int NB>
cudaError_t launch_trail_panel(const dim3& grid, void* stream, float* l,
                               long long l_mat, int ld, const float* inv,
                               int o, int t, int vec_l) {
  const cudaError_t e = cudaFuncSetAttribute(
      trail_panel_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)TrailPanelShape<NB>::kSmem);
  if (e != cudaSuccess) return e;
  trail_panel_kernel<NB><<<grid, kTrailThreads, TrailPanelShape<NB>::kSmem,
                           (cudaStream_t)stream>>>(l, l_mat, ld, inv, o, t,
                                                   vec_l);
  return cudaGetLastError();
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
  p.vec = aligned16(l, l_mat, ld, 0);
  p.out_vec = aligned16(l, l_mat, ld, o);
  const dim3 grid((w + PanelTile::kBN - 1) / PanelTile::kBN,
                  (t - r0 + PanelTile::kBM - 1) / PanelTile::kBM, n);
  return launch_panel<PanelTile>(gram_panel_kernel, p, grid, stream);
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
  p.vec = aligned16(l, l_mat, ld, 0);
  p.out_vec = aligned16(l, l_mat, ld, o) && aligned16(k, k_mat, kld, o);
  const dim3 grid((w + PanelTile::kBN - 1) / PanelTile::kBN,
                  (t - r0 + PanelTile::kBM - 1) / PanelTile::kBM, n);
  return launch_panel<PanelTile>(hist_panel_kernel, p, grid, stream);
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
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return (int)e;
  // one wave, kTrailPerSM blocks an SM, each on one matrix's row tiles
  const int tiles = (t - o - nb + kTrailRows - 1) / kTrailRows;
  const int per_matrix = std::max(1, std::min(tiles, kTrailPerSM * sms / n));
  const dim3 grid(per_matrix, n);
  const int vec_l = aligned16(l, l_mat, ld, o);
  if (nb == 128) {
    e = launch_trail_panel<128>(grid, stream, (float*)l, l_mat, ld,
                                (const float*)inv, o, t, vec_l);
  } else {
    e = launch_trail_panel<64>(grid, stream, (float*)l, l_mat, ld,
                               (const float*)inv, o, t, vec_l);
  }
  return (int)e;
}

// The same step's trailing downdate, in place: for the lower-triangular
// 64 x 64 tiles of the square [o + nb, t)^2,
//
//   L[r, c] -= sum_{o <= k < o + nb} L[r, k] L[c, k]
//
// with X = L[:, o:o+nb] as trail_panel left it.  It is the panel tile,
// 64 x 64, with K = L and the history [o, o + nb): each element is read and
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
  p.vec = aligned16(l, l_mat, ld, o);
  p.out_vec = aligned16(l, l_mat, ld, o + nb);
  const int tiles = (p.w + TrailTile::kBM - 1) / TrailTile::kBM;
  const dim3 grid(tiles * (tiles + 1) / 2, n);
  return launch_panel<TrailTile>(trail_update_kernel, p, grid, stream);
}

const char* gpvae_cuda_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
