// The products of the Cholesky factor's reverse mode (ops/chol_bwd.py),
// on the inverse route of ops/chol.py::cholesky_bwd_from_l: with L the
// factor, L_bar its cotangent, g a logdet's cotangent and X = L^-1,
//
//   K_bar = X^T W X,   W = sym(phi(L^T L_bar)) + g I,
//
// in three passes over a bank of n matrices [n, T, T] (row-major, T a
// multiple of 128), each a 128 x 128 output tile a block:
//
//   pass 0: W = 1/2 L^T L_bar on the lower tiles, mirrored, g added to
//           the diagonal (phi halves the diagonal and drops the upper
//           triangle, sym halves the rest: W = 1/2 P on and below the
//           diagonal).  L[k, i] = 0 for k < i, so row tile i0 sums over
//           k >= i0;
//   pass 1: M = X^T W on every tile, row tile i0 over k >= i0 (X lower);
//   pass 2: K_bar = M X on the lower tiles, column tile j0 over k >= j0,
//           mirrored, each diagonal tile averaged with its transpose.
//
// It replaces no TPU kernel: the JAX package leaves these products to XLA
// (gpvae_tpu/ops/chol.py:497-578, the 2 x 2 blocks of _phi_w_blocks and
// _tri_sandwich_blocks: 14 half-size products, 3.5 T^3 a matrix, which
// skip the zero half-blocks but not the zero tiles inside them).  The
// passes take 2 T^3 a matrix and write W, M and K_bar whole, so nothing
// else touches the bank between them.
//
// What bounds it on Hopper: operations.  2 T^3 n flops (2.2 TFLOP at T =
// 8192, n = 2; 0.27 at T = 1024, n = 128) against 8 T^2 n floats moved (L,
// L_bar, X read, W and M written and read, K_bar written): 13.3 ms and
// 1.67 ms at the tensor cores' float32-equivalent 165 TFLOP/s (three TF32
// products at 495), 33 ms and 4.1 at plain float32 FMA (67), the bytes
// 1.3 and 1.3 ms at 3.35 TB/s.  On an H100 it takes 29.2 and 5.2 ms.  By
// count, shared memory holds it there: a 32-deep stage of a 128 x 128
// tile (1 MFLOP) reads 144 KB of operands into the tensor cores, and its
// split and copies move 128 KB more, about 2,100 cycles at the SM's 128
// bytes a cycle against 1,540 of tensor work; the fresh accumulators
// (230 registers) leave no room for a larger tile or a second block.
//
// The design is the panel tile's (gram_panel.cu, tf32_wgmma.cuh): 3xTF32
// on the tensor cores, each operand split once into rounded TF32 parts
// and a b taken as al bh + ah bl + ah bh by wgmma m64n128k8 (float32
// sums), each 32-deep stage's twelve products summed into fresh registers
// that an ordinary float32 add rounds into the tile's total (the tensor
// cores truncate).  Pass 0 rounds into its total after every 8-deep
// k-step's three products instead: W's sums are short in effect (a
// factor's column decays from its diagonal), so a whole stage's twelve
// truncations are most of its error, up to 3x the FMA loop's on the CPU
// emulation's T = 256 banks (python -m gpvae_tpu_torch.ops.split_emulation
// --backward), 2x at most when rounded every k-step; the tensor cores
// then idle while each of the stage's four sums drains, on a sixth of the
// work.  Stages run first column first, within half the FMA loop's error
// at T = 1024 in the emulation; the panel tile's order (the first stage
// by FMA, the rest last first) does a little better there but would need
// an FMA pass over transposed stages.  The truncation still biases the
// sums toward zero: K_bar's entries shrink by ~4e-7 of themselves on an
// H100 (the library's float32: ~2e-9).  Rounding every pass every k-step
// took that to 1e-7 at 15% more time, and adding half an ulp, the
// truncation's mean, to each k-step's sum to 1e-8 at twice the time (255
// registers); neither moved chip_smoke.py's T=1024 lengthscale gradient,
// which reads the same with the library's products.
//
// A stage arrives through a 4-stage ring of 16-byte cp.async copies.
// wgmma reads every operand k-major (TF32 takes no transposed operand),
// but L, L_bar and X are multiplied down their columns: such an operand's
// stage lands as it lies, 32 rows of 128 floats, and the pass that splits
// it reads it into registers, waits for the block, and writes the parts
// back transposed in the 128-byte swizzle, 16 bytes a thread
// (conflict-free both ways); an operand read along its rows (W, M) is
// split in place.  W is symmetric, so pass 1 reads its rows as its
// columns.
//
// Tiles are walked longest depth first within a matrix, so that the
// triangle's ragged depths end the grid with short tiles: pass 0 by row
// tile, pass 2 by column tile, pass 1 in groups of 8 row tiles, column by
// column, so that the blocks in flight share their operands' rows in L2.
// Matrices run one after another (blockIdx.y): at T = 1024 a matrix's
// operands stay in L2 while its tiles run.  The epilogue goes through
// shared memory at an odd pitch, so that a tile and its mirror are both
// stored a row at a time.

#include <cuda_runtime.h>

#include <cstdint>

#include "cp_async.cuh"
#include "tf32_wgmma.cuh"

namespace {

using gpvae::cp_async16;
using gpvae::cp_async_commit;
using gpvae::cp_async_wait;
using gpvae::fence_proxy_async;
using gpvae::fence_reg;
using gpvae::smem_desc_sw128;
using gpvae::split2;
using gpvae::wgmma_commit;
using gpvae::wgmma_fence;
using gpvae::wgmma_m64n128k8;
using gpvae::wgmma_wait_all;

constexpr int kTile = 128;     // output tile side, and a part's rows
constexpr int kBK = 32;        // depth a stage: one 128-byte row
constexpr int kSteps = kBK / 8;  // wgmma k-steps a stage
constexpr int kStages = 4;
constexpr int kThreads = 256;  // two warpgroups of 64 rows
constexpr int kAcc = kTile / 2;  // accumulators a thread
constexpr int kPartFloats = kTile * kBK;        // one operand's stage
constexpr int kStageFloats = 2 * kPartFloats;   // A's rows, then B's
constexpr int kPitch = kTile + 1;               // the epilogue's rows
constexpr int kGroup = 8;                       // pass 1's row tiles
// the ring (its stages hold the high parts once split), two planes of low
// parts, and room to align the ring to 1024 bytes
constexpr size_t kSmem =
    (size_t)(kStages + 2) * kStageFloats * sizeof(float) + 1024;
static_assert(kTile * kPitch <= kStages * kStageFloats, "epilogue in ring");

struct BwdParams {
  const float* a;  // first operand [n, t, t]
  const float* b;  // second operand [n, t, t]
  const float* g;  // [n], pass 0 only, or null
  float* out;      // [n, t, t]
  int t;
};

// What each pass reads and writes.  Operand A gives the tile's rows,
// A(i, k); B its columns, B(j, k); kTrans: the operand is read down its
// columns (A(i, k) = a[k, i]).  kLower: the lower tiles only, mirrored.
// kFromCol: the depth starts at the column tile, else at the row tile.
// kSums: fresh accumulators a stage (see the top).
template <int kPass>
struct Pass;
template <>
struct Pass<0> {  // W from L (A) and L_bar (B)
  static constexpr bool kTransA = true, kTransB = true, kLower = true,
                        kFromCol = false;
  static constexpr int kSums = kSteps;
};
template <>
struct Pass<1> {  // M from X (A) and W (B)
  static constexpr bool kTransA = true, kTransB = false, kLower = false,
                        kFromCol = false;
  static constexpr int kSums = 1;
};
template <>
struct Pass<2> {  // K_bar from M (A) and X (B)
  static constexpr bool kTransA = false, kTransB = true, kLower = true,
                        kFromCol = true;
  static constexpr int kSums = 1;
};

// x = i (i + 1) / 2 + j, j <= i: (i, j)
__device__ __forceinline__ void tri_index(int x, int& i, int& j) {
  i = (int)((sqrtf(8.0f * x + 1.0f) - 1.0f) * 0.5f);
  while (i * (i + 1) / 2 > x) --i;  // float rounding, either way
  while ((i + 1) * (i + 2) / 2 <= x) ++i;
  j = x - i * (i + 1) / 2;
}

// the tile (row bi, column bj) of block x of a matrix's nb x nb tiles,
// deepest first (see the top)
template <int kPass>
__device__ __forceinline__ void tile_of(int x, int nb, int& bi, int& bj) {
  if constexpr (kPass == 0) {  // lower tiles, by row
    tri_index(x, bi, bj);
  } else if constexpr (kPass == 1) {  // every tile, 8 rows a group
    const int first = (x / (kGroup * nb)) * kGroup;
    const int rows = min(kGroup, nb - first);
    const int within = x % (kGroup * nb);
    bi = first + within % rows;
    bj = within / rows;
  } else {  // lower tiles, by column: the row-wise order from the end
    int u, v;
    tri_index(nb * (nb + 1) / 2 - 1 - x, u, v);
    bj = nb - 1 - u;
    bi = nb - 1 - v;
  }
}

// one operand's stage: rows row0 .. row0 + 127 of A(i, k) or B(j, k), k in
// [k0, k0 + 32), 16 bytes a copy.  Read along its rows, in the 128-byte
// swizzle (chunk j of row r at chunk j ^ (r % 8)); down its columns, as
// it lies: k-row k at dst + 128 k.
template <bool kTrans>
__device__ __forceinline__ void load_part(float* dst, const float* m, int t,
                                          int row0, int k0) {
#pragma unroll
  for (int i = 0; i < kPartFloats / 4 / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if constexpr (kTrans) {
      const int k = e / (kTile / 4), c = e % (kTile / 4);
      cp_async16(dst + k * kTile + 4 * c,
                 m + (size_t)(k0 + k) * t + row0 + 4 * c, 16);
    } else {
      const int r = e / (kBK / 4), j = e % (kBK / 4);
      cp_async16(dst + r * kBK + ((j ^ (r & 7)) * 4),
                 m + (size_t)(row0 + r) * t + k0 + 4 * j, 16);
    }
  }
}

// one landed operand's stage split into TF32 parts: hi over the stage in
// the swizzle, lo at the same place in its plane.  Down the columns: a
// thread takes row m = tid % 128 and k-chunks 4 h .. 4 h + 3 (h = tid /
// 128) into registers, all threads wait, then each writes its 16-byte
// chunks transposed.  Collective: every thread calls it.
template <bool kTrans>
__device__ __forceinline__ void split_part(float* part, float* lo) {
  const int tid = threadIdx.x;
  if constexpr (kTrans) {
    const int m = tid % kTile, h = tid / kTile;
    float v[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[c][i] = part[(16 * h + 4 * c + i) * kTile + m];
      }
    }
    __syncthreads();  // every thread holds its raw values
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int at = m * kBK + (((4 * h + c) ^ (m & 7)) * 4);
      float4 hi, l4;
      split2(v[c][0], hi.x, l4.x);
      split2(v[c][1], hi.y, l4.y);
      split2(v[c][2], hi.z, l4.z);
      split2(v[c][3], hi.w, l4.w);
      *reinterpret_cast<float4*>(part + at) = hi;
      *reinterpret_cast<float4*>(lo + at) = l4;
    }
  } else {
#pragma unroll
    for (int e = tid; e < kPartFloats / 4; e += kThreads) {
      float4 v = *reinterpret_cast<const float4*>(part + 4 * e);
      float4 l4;
      split2(v.x, v.x, l4.x);
      split2(v.y, v.y, l4.y);
      split2(v.z, v.z, l4.z);
      split2(v.w, v.w, l4.w);
      *reinterpret_cast<float4*>(part + 4 * e) = v;
      *reinterpret_cast<float4*>(lo + 4 * e) = l4;
    }
  }
}

template <int kPass>
__global__ void __launch_bounds__(kThreads) chol_bwd_kernel(BwdParams p) {
  using P = Pass<kPass>;
  extern __shared__ __align__(128) float smem_raw[];
  float* ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* lo = ring + kStages * kStageFloats;  // two planes of low parts

  const int t = p.t, nb = t / kTile, n = blockIdx.y;
  int bi, bj;
  tile_of<kPass>(blockIdx.x, nb, bi, bj);
  const int i0 = bi * kTile, j0 = bj * kTile;
  const int k_begin = P::kFromCol ? j0 : i0;
  const int stages = (t - k_begin) / kBK;
  const size_t mat = (size_t)n * t * t;
  const float* am = p.a + mat;
  const float* bm = p.b + mat;

  const int tid = threadIdx.x, wg = tid / 128;
  auto load_stage = [&](int s) {
    if (s >= stages) return;
    float* st = ring + (s % kStages) * kStageFloats;
    const int k0 = k_begin + s * kBK;
    load_part<P::kTransA>(st, am, t, i0, k0);
    load_part<P::kTransB>(st + kPartFloats, bm, t, j0, k0);
  };
  auto split_stage = [&](int s) {
    float* st = ring + (s % kStages) * kStageFloats;
    float* pl = lo + (s % 2) * kStageFloats;
    split_part<P::kTransA>(st, pl);
    split_part<P::kTransB>(st + kPartFloats, pl + kPartFloats);
    fence_proxy_async();
  };

  float acc[kAcc] = {};
  float d[kAcc];
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    load_stage(s);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();  // stage 0 landed (every tile has 4 or more)
  split_stage(0);
  __syncthreads();  // and is split
  for (int s = 0; s < stages; ++s) {
    // stage s on the tensor cores: a b = al bh + ah bl + ah bh (al bl
    // dropped), its products into d, which an ordinary float32 add rounds
    // into acc: all twelve, or in pass 0 three at a time (P::kSums);
    // meanwhile stage s + 1 is split
    const float* sh = ring + (s % kStages) * kStageFloats;
    const float* sl = lo + (s % 2) * kStageFloats;
#pragma unroll
    for (int sum = 0; sum < P::kSums; ++sum) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) fence_reg(d[i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSteps / P::kSums; ++kk) {
        const int ks = sum * (kSteps / P::kSums) + kk;
        const int a_at = wg * 64 * kBK + ks * 8;  // k offset in the row
        const int b_at = kPartFloats + ks * 8;
        const uint64_t ah = smem_desc_sw128(sh + a_at);
        const uint64_t al = smem_desc_sw128(sl + a_at);
        const uint64_t bh = smem_desc_sw128(sh + b_at);
        const uint64_t bl = smem_desc_sw128(sl + b_at);
        wgmma_m64n128k8(d, al, bh, kk > 0);
        wgmma_m64n128k8(d, ah, bl, 1);
        wgmma_m64n128k8(d, ah, bh, 1);
      }
      wgmma_commit();
      if (sum == 0) {
        if (s + 1 < stages) {
          cp_async_wait<kStages - 3>();
          __syncthreads();  // stage s + 1 landed
          split_stage(s + 1);
        }
        __syncthreads();  // stage s + 1 split; stage s - 1's buffer is free
        load_stage(s + kStages - 1);
        cp_async_commit();
      }
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        fence_reg(d[i]);
        acc[i] += d[i];
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the epilogue

  // accumulator i of warp w (of 8), lane (g, q): row 64 (w / 4) + 16 (w %
  // 4) + g (+ 8 if i & 2), column 8 (i / 4) + 2 q (+ 1 if odd); pass 0
  // keeps 1/2 of it
  float* stg = ring;
  {
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
    const float scale = kPass == 0 ? 0.5f : 1.0f;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int m = (warp / 4) * 64 + (warp % 4) * 16 + g + 8 * ((i >> 1) & 1);
      const int c = 8 * (i / 4) + 2 * q + (i & 1);
      stg[m * kPitch + c] = scale * acc[i];
    }
  }
  __syncthreads();

  float* out = p.out + mat;
  if (P::kLower && bi == bj) {
    // pass 0: the lower triangle mirrored, g on the diagonal; pass 2: the
    // tile averaged with its transpose
    const float gn = (kPass == 0 && p.g != nullptr) ? p.g[n] : 0.0f;
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int m = e / kTile, c = e % kTile;
      float v;
      if constexpr (kPass == 0) {
        v = m >= c ? stg[m * kPitch + c] : stg[c * kPitch + m];
        if (m == c) v += gn;
      } else {
        v = 0.5f * (stg[m * kPitch + c] + stg[c * kPitch + m]);
      }
      out[(size_t)(i0 + m) * t + j0 + c] = v;
    }
    return;
  }
  for (int e = tid; e < kTile * kTile; e += kThreads) {
    const int m = e / kTile, c = e % kTile;
    out[(size_t)(i0 + m) * t + j0 + c] = stg[m * kPitch + c];
  }
  if constexpr (P::kLower) {  // the mirror, a row of it at a time
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int c = e / kTile, m = e % kTile;
      out[(size_t)(j0 + c) * t + i0 + m] = stg[m * kPitch + c];
    }
  }
}

template <int kPass>
int launch(const BwdParams& p, int n, void* stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      chol_bwd_kernel<kPass>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  const int nb = p.t / kTile;
  const dim3 grid(Pass<kPass>::kLower ? nb * (nb + 1) / 2 : nb * nb, n);
  chol_bwd_kernel<kPass>
      <<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One pass of the reverse mode over n contiguous [t, t] float32 matrices,
// t a multiple of 128: pass 0 writes W from a = L, b = L_bar and g ([n]
// or null); pass 1 M from a = X, b = W; pass 2 K_bar from a = M, b = X.
// out must overlap neither operand.
int gpvae_chol_bwd_f32(int pass, const void* a, const void* b,
                       const void* g, void* out, int t, int n,
                       void* stream) {
  if (n <= 0) return 0;
  if (pass < 0 || pass > 2 || t < kTile || t % kTile != 0 || n > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  BwdParams p = {};
  p.a = (const float*)a;
  p.b = (const float*)b;
  p.g = (const float*)g;
  p.out = (float*)out;
  p.t = t;
  switch (pass) {
    case 0:
      return launch<0>(p, n, stream);
    case 1:
      return launch<1>(p, n, stream);
    default:
      return launch<2>(p, n, stream);
  }
}

const char* gpvae_cuda_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
