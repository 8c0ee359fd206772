// Shared pieces of the block-sparse SpMM kernels (sm_90a, plain C ABI):
// Y = A X for a dense (n, p) f32 right-hand side, X and Y row-major.
//
// What bounds them on this card: bytes up to a few columns, then a mix.
// A stored entry costs 4 (f32) or 2 (bf16) bytes and does 2p flops (4p in
// half storage), so at p = 16 the f32 FMA time comes within a factor two of
// the streaming time.  The design therefore has to do two things at once:
// read every block from device memory ONCE for all p columns, and keep the
// FMA pipes fed from on-chip memory.  This first version does the first and
// not yet the second: its inner loops make about one load from shared
// memory per two to three FMAs, and that, not device memory, sets its pace
// beyond a few columns.
//
// Work decomposition, shared by both kernels: one CTA of 8 warps owns one
// block row.  A block is staged in shared memory, widened to f32, in row
// panels of at most kPanelElems entries (a whole 128x128 block; 64 rows of a
// 256-wide one), together with the (bn, p) panel of X it multiplies.  A work
// item is one row of the panel (one column, for the transposed product of
// the symmetric kernel) times a tile of kColTile columns of X, carried in
// kColTile register accumulators; items are dealt round-robin to the
// threads, so ANY p >= 1 and any panel height work with the same code.  The
// TPU kernels' pad of p to 8 sublanes and their (nbc, p, bn) slab layout are
// not part of the function and are not carried over: only the shared-memory
// copy of a panel is padded to a multiple of kColTile columns (with zeros).
//
// Both access patterns have to be conflict-free: the direct product reads a
// panel row-wise (lanes on 32 consecutive rows, four consecutive entries
// each), the transposed product column-wise (lanes on 32 consecutive
// columns of one row).  A 16-byte XOR swizzle does both: the four-entry
// chunk c4 of row i lives at chunk (c4 ^ i) & 31 of its aligned group of 32
// chunks, which needs bn to be a multiple of 128.
//
// Precision rule: as in spmv_common.cuh (bf16 widened exactly, f32 FMA on
// CUDA cores, no tensor cores, no TF32).  Every sum has a fixed order.
//
// A launch covers at most kMaxCols columns; the C entries walk wider X in
// column chunks.  At 32 columns a launch is bound by operations, so the
// second read of the blocks is not what limits a wide product.
#pragma once

#include "spmv_common.cuh"

namespace eigenex {

constexpr int kColTile = 8;         // columns of X one work item carries in registers
constexpr int kMaxCols = 32;        // columns of X per launch
constexpr int kPanelElems = 16384;  // staged entries of a block per panel: 64 KB as f32
constexpr int kStageLoads = 8;      // block loads a thread keeps in flight while staging
constexpr int kMaxSharedBytes = 232448;  // 227 KB: what one CTA can be given on sm_90

// rows of a (bm, bn) block staged at a time
__host__ __device__ inline int panel_rows(int bm, int bn) {
  int prows = kPanelElems / bn;
  if (prows < 1) prows = 1;
  return prows < bm ? prows : bm;
}

// width of the shared-memory copy of a panel of pc columns
__host__ __device__ inline int padded_cols(int pc) {
  return (pc + kColTile - 1) / kColTile * kColTile;
}

// chunk of a staged row where the four entries 4*c4 .. 4*c4+3 of row i live
__device__ __forceinline__ int swizzled_chunk(int i, int c4) {
  return (c4 & ~31) | ((c4 ^ i) & 31);
}

// Stage `rows` rows of a block (bn entries each, contiguous from `blk`) into
// As, widened to f32 and swizzled.  Each thread starts kStageLoads
// independent 16-byte (f32) / 8-byte (bf16) streaming loads before it
// stores any, which is what keeps device memory busy.
template <typename T>
__device__ __forceinline__ void stage_panel(float* __restrict__ As, const T* __restrict__ blk,
                                            int rows, int bn) {
  const int per_row = bn >> 2;
  const int units = rows * per_row;
  for (int u0 = 0; u0 < units; u0 += kThreads * kStageLoads) {
    float4 v[kStageLoads];
#pragma unroll
    for (int t = 0; t < kStageLoads; ++t) {
      const int u = u0 + t * kThreads + (int)threadIdx.x;
      if (u < units) v[t] = load_block4<T>(blk + (size_t)u * 4);
    }
#pragma unroll
    for (int t = 0; t < kStageLoads; ++t) {
      const int u = u0 + t * kThreads + (int)threadIdx.x;
      if (u < units) {
        const int i = u / per_row;
        const int c4 = u - i * per_row;
        *reinterpret_cast<float4*>(As + (size_t)i * bn + 4 * swizzled_chunk(i, c4)) = v[t];
      }
    }
  }
}

// (rows, pc) tile of a row-major matrix with row stride ld -> shared panel
// of width ps, pad columns zero.
__device__ __forceinline__ void load_x_panel(float* __restrict__ Xs, const float* __restrict__ X,
                                             int rows, int pc, int ps, size_t ld) {
  for (int e = threadIdx.x; e < rows * ps; e += kThreads) {
    const int row = e / ps;
    const int col = e - row * ps;
    Xs[e] = (col < pc) ? __ldg(X + (size_t)row * ld + col) : 0.f;
  }
}

__device__ __forceinline__ void zero_panel(float* __restrict__ P, int count) {
  for (int e = threadIdx.x; e < count; e += kThreads) P[e] = 0.f;
}

// shared panel of width ps -> (rows, pc) tile of a row-major matrix
__device__ __forceinline__ void store_panel(float* __restrict__ Y, const float* __restrict__ Ps,
                                            int rows, int pc, int ps, size_t ld) {
  for (int e = threadIdx.x; e < rows * pc; e += kThreads) {
    const int row = e / pc;
    const int col = e - row * pc;
    Y[(size_t)row * ld + col] = Ps[row * ps + col];
  }
}

// acc[0..7] += a * x[0..7], x in shared memory (the same address in every
// lane of a warp that works on one column tile: a broadcast)
__device__ __forceinline__ void fma_tile(float (&acc)[kColTile], float a,
                                         const float* __restrict__ x) {
  const float4 x0 = *reinterpret_cast<const float4*>(x);
  const float4 x1 = *reinterpret_cast<const float4*>(x + 4);
  acc[0] = fmaf(a, x0.x, acc[0]);
  acc[1] = fmaf(a, x0.y, acc[1]);
  acc[2] = fmaf(a, x0.z, acc[2]);
  acc[3] = fmaf(a, x0.w, acc[3]);
  acc[4] = fmaf(a, x1.x, acc[4]);
  acc[5] = fmaf(a, x1.y, acc[5]);
  acc[6] = fmaf(a, x1.z, acc[6]);
  acc[7] = fmaf(a, x1.w, acc[7]);
}

// dst[0..7] += acc[0..7] in shared memory; dst is 16-byte aligned (panel
// widths and tile offsets are multiples of kColTile)
__device__ __forceinline__ void add_tile(float* __restrict__ dst, const float (&acc)[kColTile]) {
  float4* d = reinterpret_cast<float4*>(dst);
  float4 lo = d[0], hi = d[1];
  lo.x += acc[0];
  lo.y += acc[1];
  lo.z += acc[2];
  lo.w += acc[3];
  hi.x += acc[4];
  hi.y += acc[5];
  hi.z += acc[6];
  hi.w += acc[7];
  d[0] = lo;
  d[1] = hi;
}

// Ys[i, :] += As[i, :] @ Xc   for the `rows` staged rows.  Item (i, g): row
// i, column tile g.  Ys points at the panel's first row; each element of Ys
// belongs to one item, so the += needs no atomics.
__device__ __forceinline__ void direct_panel(const float* __restrict__ As,
                                             const float* __restrict__ Xc,
                                             float* __restrict__ Ys, int rows, int bn, int ps) {
  const int items = rows * (ps / kColTile);
  for (int item = threadIdx.x; item < items; item += kThreads) {
    const int g = item / rows;
    const int i = item - g * rows;
    const float* arow = As + (size_t)i * bn;
    const float* xcol = Xc + g * kColTile;
    float acc[kColTile];
#pragma unroll
    for (int e = 0; e < kColTile; ++e) acc[e] = 0.f;
#pragma unroll 2
    for (int c4 = 0; c4 < (bn >> 2); ++c4) {
      const float4 a = *reinterpret_cast<const float4*>(arow + 4 * swizzled_chunk(i, c4));
      const float* x = xcol + (size_t)(4 * c4) * ps;
      fma_tile(acc, a.x, x);
      fma_tile(acc, a.y, x + ps);
      fma_tile(acc, a.z, x + 2 * ps);
      fma_tile(acc, a.w, x + 3 * ps);
    }
    add_tile(Ys + (size_t)i * ps + g * kColTile, acc);
  }
}

// Ts[j, :] += sum_i As[i, j] * Xr[i, :]   over the `rows` staged rows (the
// transposed product).  Item (j, g): column j of the block, column tile g.
// Xr points at the panel's first row of the block row's own X.
__device__ __forceinline__ void transposed_panel(const float* __restrict__ As,
                                                 const float* __restrict__ Xr,
                                                 float* __restrict__ Ts, int rows, int bn,
                                                 int ps) {
  const int items = bn * (ps / kColTile);
  for (int item = threadIdx.x; item < items; item += kThreads) {
    const int g = item / bn;
    const int j = item - g * bn;
    const int c4 = j >> 2;
    const int within = j & 3;
    const float* xcol = Xr + g * kColTile;
    float acc[kColTile];
#pragma unroll
    for (int e = 0; e < kColTile; ++e) acc[e] = 0.f;
#pragma unroll 4
    for (int i = 0; i < rows; ++i) {
      const float a = As[(size_t)i * bn + 4 * swizzled_chunk(i, c4) + within];
      fma_tile(acc, a, xcol + (size_t)i * ps);
    }
    add_tile(Ts + (size_t)j * ps + g * kColTile, acc);
  }
}

}  // namespace eigenex
