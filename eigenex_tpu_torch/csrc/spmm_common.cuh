// Shared body of the block-sparse SpMM kernels (sm_90a, plain C ABI):
// Y = A X for a dense (n, p) f32 right-hand side, X and Y row-major.
// Replaces the block products of _spmm_kernel and the three _sym_spmm_*
// kernels of eigenex_tpu/ops/pallas_spmv.py and their precision rule
// (_dot_mode/_sdot).
//
// What bounds them on this card: bytes, up to p = 32 columns.  A stored entry
// costs 4 (f32) or 2 (bf16) bytes and does 2p flops (4p in half storage); on
// the tensor cores that is far below the streaming time, so the design has one
// aim: keep device memory busy all the time and hide everything else under it.
//
//   * Tiles.  A block is walked as 128x128 tiles.  A tile is copied into
//     shared memory IN ITS STORAGE TYPE with cp.async (16 bytes a thread,
//     .cg with an evict-first L2 hint: the blocks are read once, bypass L1
//     and leave L2 to X, Y and the scratch), 32 KB in bf16 and 64 KB in f32,
//     into a ring of two tiles, so the next tile is in flight while this one
//     is multiplied.  Each block is read from device memory once for all p
//     columns.  (A ring of three was measured and is no faster.)
//   * Persistent CTAs.  The grid is SMs x CTAs-an-SM; CTA g walks the
//     contiguous range of block rows [g nbr / G, (g + 1) nbr / G) and the
//     ring runs on across block rows, so there is a prologue a CTA, not a
//     block row.  The walk over tiles is arithmetic; what it needs from
//     device memory is requested early and used late: a tile's column id two
//     steps ahead, its X panel one step ahead (into registers, before this
//     step's products), so no step waits on a load it has just started.  The
//     assignment is static and every output element is
//     summed by one thread in one fixed order, so the result does not depend
//     on the grid and two runs are bit-equal.
//   * Outputs in registers.  Warp w of 8 owns rows 16w..16w+15 of the tile's
//     128 rows of Y (direct product, summed over all slots and column tiles
//     of the block row) and rows 16w..16w+15 of the slot's transposed
//     partial (columns 16w..16w+15 of the tile, summed over its 128 rows).
//     No accumulator lives in shared memory.
//   * Products on the tensor cores, mma.sync, compensated to f32 grade:
//       bf16 storage: the block entries are exact in bf16.  Each f32 entry of
//         X is split into hi + mid + lo bf16 parts (exactly, as _sdot does)
//         once per panel; three m16n8k16 bf16 products (lo, mid, hi) go into
//         one f32 fragment.  A fragments by ldmatrix (direct) and
//         ldmatrix.trans (transposed) from the same staged tile.
//       f32 storage: 3xTF32.  x = big + small + (a remainder under 2^-21 |x|)
//         with big = x rounded to TF32 (nearest, ties away) and small = the
//         exact difference x - big cut to TF32.  Both are made with integer
//         operations (add half a unit, mask 13 mantissa bits; subtract, mask),
//         not with cvt.rna.tf32.f32, so every operand handed to mma.sync is a
//         TF32 value already and the result does not depend on what the tensor
//         core does with low mantissa bits.  Three m16n8k8 tf32 products (small
//         x big, big x small, big x big).  Block entries are split when a
//         fragment is read, X entries once per panel.
//     Every chain of three products starts from zero and is added to the
//     owner's accumulator with an f32 add, so the tensor core's truncating
//     accumulation acts on one k-step only and the long sums round to
//     nearest (measured: longer chains cost the same time and lose accuracy).
//     Rule: NO product of X in one TF32 or bf16 pass; every product is exact
//     in the block entries (bf16) or carries both cross terms (f32), and is
//     compensated to f32 grade in X.
//   * X panels.  The (128, p) panel of X a tile multiplies is read from
//     device memory (L2, mostly), split, and written to shared memory in the
//     order the B fragments are read: one 8-byte (bf16 route, per part) or
//     16-byte (tf32 route) load a lane, conflict-free.  p is padded to a
//     multiple of 8 with zeros in shared memory only.
//
// Swizzles (both fragment patterns conflict-free):
//   bf16 tile, rows of 256 bytes = 16 chunks of 16 bytes: chunk c of row i at
//     c ^ (i & 7).  ldmatrix reads 8 rows of one chunk per phase, direct and
//     transposed alike.
//   f32 tile, rows of 512 bytes = 32 chunks: chunk c of row i at c ^ f(i),
//     f(i) = 2 ((i ^ (i >> 2)) & 1) + 4 ((i >> 1) & 1).  The k index of an
//     m16n8k8 step is permuted (fragment index t -> column 2t, t + 4 -> 2t + 1)
//     so the direct fragment is two 8-byte loads: rows g..g+3 x column pairs.
//     The transposed fragment is four 4-byte loads: rows 2t (+1) x 8 columns.
//     f separates both; a plain XOR with the row gives a 2-way conflict on
//     the transposed pattern.
//
// Shared memory and occupancy, a CTA of 256 threads (8 warps):
//   bf16: ring 2 x 32 KB + panels (6 KB per 8 columns, two panels in the
//         symmetric kernel) = 70-112 KB.  Up to 16 columns 2 CTAs an SM at
//         104-128 registers a thread; 17-32 columns 1 CTA at up to 224.
//   f32:  ring 2 x 64 KB + panels (8 KB per 8 columns) = 136-192 KB: 1 CTA an
//         SM at 113-238 registers a thread.
//   No spills in any instantiation (ptxas -v, kept beside each library).
//
// A launch covers at most kMaxCols columns; the C entries walk wider X in
// column chunks.
#pragma once

#include "spmv_common.cuh"

namespace eigenex {

constexpr int kTile = 128;               // side of a staged tile
constexpr int kStages = 2;               // tiles in the ring: one multiplied, one in flight
constexpr int kMaxNT = 4;                // n-tiles of 8 columns per launch
constexpr int kMaxCols = 8 * kMaxNT;     // columns of X per launch
constexpr int kMaxSharedBytes = 232448;  // 227 KB: what one CTA can be given on sm_90
constexpr int kTwoCtaSharedBytes = 115712;  // (228 KB - 2 x 1 KB reserved) / 2

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// L2 policy for data that is read once: first to be evicted, so the block
// stream does not push X, Y and the scratch out of L2
__device__ __forceinline__ uint64_t l2_evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint64_t policy) {
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "l"(policy)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x8 tf32, row) * b (8x8 tf32, col)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// the splits
// ---------------------------------------------------------------------------
// x rounded to TF32 (10 mantissa bits), nearest with ties away from zero.
// |x| is first held to the largest f32 that does not round up to infinity, so
// big is finite for every x; an infinity or a NaN is carried by tf32_small.
__device__ __forceinline__ float tf32_big(float x) {
  const float top = __uint_as_float(0x7f7fefffu);
  const float held = fminf(fmaxf(x, -top), top);
  return __uint_as_float((__float_as_uint(held) + 0x1000u) & 0xffffe000u);
}

// the exact remainder x - big cut to TF32: its leading 10 mantissa bits
__device__ __forceinline__ float tf32_small(float x, float big) {
  return __uint_as_float(__float_as_uint(x - big) & 0xffffe000u);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// two f32 values (exactly representable in bf16) as one packed register,
// the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float first, float second) {
  return (__float_as_uint(first) >> 16) | (__float_as_uint(second) & 0xffff0000u);
}

// ---------------------------------------------------------------------------
// per storage type: tile geometry, swizzle, X panel, products
// ---------------------------------------------------------------------------
template <typename T>
struct Route;

template <>
struct Route<__nv_bfloat16> {
  static constexpr int kTileBytes = kTile * kTile * 2;
  static constexpr int kRowBytes = kTile * 2;
  static constexpr int kChunksPerRow = kRowBytes / 16;
  static constexpr int kPanelBytesPerNT = 8 * 3 * 32 * 8;  // 8 k-steps x 3 parts x 32 lanes x 8 B
  static constexpr int kCtasPerSm = 2;
  __device__ static __forceinline__ int swizzle(int row) { return row & 7; }
};

template <>
struct Route<float> {
  static constexpr int kTileBytes = kTile * kTile * 4;
  static constexpr int kRowBytes = kTile * 4;
  static constexpr int kChunksPerRow = kRowBytes / 16;
  static constexpr int kPanelBytesPerNT = 16 * 32 * 16;  // 16 k-steps x 32 lanes x 16 B
  static constexpr int kCtasPerSm = 1;
  __device__ static __forceinline__ int swizzle(int row) {
    return (((row ^ (row >> 2)) & 1) << 1) | ((row & 2) << 1);
  }
};

// CTAs an SM a kernel instantiation is compiled for: two on the bf16 route up
// to 16 columns (at most 128 registers a thread), else one.
template <typename T, int NT>
__host__ __device__ constexpr int ctas_per_sm() {
  return (Route<T>::kCtasPerSm == 2 && NT <= 2) ? 2 : 1;
}

// dynamic shared memory of a kernel instantiation with `PANELS` X panels
template <typename T, int NT, int PANELS>
__host__ __device__ constexpr size_t shared_bytes() {
  return (size_t)kStages * Route<T>::kTileBytes +
         (size_t)PANELS * NT * Route<T>::kPanelBytesPerNT;
}

// Start the copy of `rows` rows of a tile (kTile entries each, row stride ld
// entries, from `src`) into the ring slot at shared address `dst`.
template <typename T>
__device__ __forceinline__ void stage_tile(uint32_t dst, const T* __restrict__ src, int rows,
                                           size_t ld) {
  using R = Route<T>;
  const uint64_t policy = l2_evict_first_policy();
  const int units = rows * R::kChunksPerRow;
  for (int u = threadIdx.x; u < units; u += kThreads) {
    const int row = u / R::kChunksPerRow;
    const int ch = u - row * R::kChunksPerRow;
    cp_async16(dst + row * R::kRowBytes + ((ch ^ R::swizzle(row)) << 4),
               reinterpret_cast<const char*>(src + (size_t)row * ld) + ch * 16, policy);
  }
}

// An f32 read that stays where it is written (the panel of the NEXT tile is
// requested before this tile's products and used after them).
__device__ __forceinline__ float load_early(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ int load_early(const int* p) {
  int v;
  asm volatile("ld.global.nc.s32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

// The (kTile, pc) panel of X that starts at row `X` (row stride ld), in two
// steps: panel_load requests this thread's 2 NT pairs of entries into
// registers, panel_store splits them and writes them in B-fragment order;
// columns pc.. of the last n-tile are zero.
//   bf16 route: uint2 Xf[k-step (8)][n-tile][part hi, mid, lo][lane], a pair =
//     rows k, k + 1 with k = 16 ks + 2 (lane % 4) + 8 reg, column 8 nt + lane / 4
//   tf32 route: float4 Xf[k-step (16)][n-tile][lane] = (big0, big1, small0,
//     small1), a pair = rows k, k + 1 with k = 8 ks + 2 (lane % 4): fragment
//     index t is column 2t of the k-step, t + 4 is column 2t + 1
template <typename T, int NT>
struct PanelRegs {
  float x0[2 * NT], x1[2 * NT];
};

template <typename T, int NT>
__device__ __forceinline__ void panel_load(PanelRegs<T, NT>& regs, const float* __restrict__ X,
                                           size_t ld, int pc) {
#pragma unroll
  for (int e = 0; e < 2 * NT; ++e) {
    const int item = e * kThreads + (int)threadIdx.x;
    const int lane = item & 31;
    int k, q;
    if constexpr (sizeof(T) == 2) {
      q = item >> 6;
      k = (q / NT) * 16 + 2 * (lane & 3) + 8 * ((item >> 5) & 1);
    } else {
      q = item >> 5;
      k = (q / NT) * 8 + 2 * (lane & 3);
    }
    const int n = (q % NT) * 8 + (lane >> 2);
    regs.x0[e] = regs.x1[e] = 0.f;
    if (n < pc) {
      regs.x0[e] = load_early(X + (size_t)k * ld + n);
      regs.x1[e] = load_early(X + (size_t)(k + 1) * ld + n);
    }
  }
}

template <typename T, int NT>
__device__ __forceinline__ void panel_store(unsigned char* __restrict__ Xf,
                                            const PanelRegs<T, NT>& regs) {
#pragma unroll
  for (int e = 0; e < 2 * NT; ++e) {
    const int item = e * kThreads + (int)threadIdx.x;
    const float x0 = regs.x0[e], x1 = regs.x1[e];
    if constexpr (sizeof(T) == 2) {
      const int lane = item & 31, reg = (item >> 5) & 1, q = item >> 6;  // q = ks * NT + nt
      const float h0 = bf16_round(x0), h1 = bf16_round(x1);
      const float r0 = x0 - h0, r1 = x1 - h1;
      const float m0 = bf16_round(r0), m1 = bf16_round(r1);
      const float l0 = bf16_round(r0 - m0), l1 = bf16_round(r1 - m1);
      uint32_t* dst = reinterpret_cast<uint32_t*>(Xf) + ((size_t)q * 3 * 32 + lane) * 2 + reg;
      dst[0] = pack_bf16(h0, h1);
      dst[64] = pack_bf16(m0, m1);
      dst[128] = pack_bf16(l0, l1);
    } else {
      const float b0 = tf32_big(x0), b1 = tf32_big(x1);  // item = (ks * NT + nt) * 32 + lane
      reinterpret_cast<float4*>(Xf)[item] =
          make_float4(b0, b1, tf32_small(x0, b0), tf32_small(x1, b1));
    }
  }
}

// load and store in one step (the rare second panel of a tile)
template <typename T, int NT>
__device__ __forceinline__ void fill_panel(unsigned char* __restrict__ Xf,
                                           const float* __restrict__ X, size_t ld, int pc) {
  PanelRegs<T, NT> regs;
  panel_load<T, NT>(regs, X, ld, pc);
  panel_store<T, NT>(Xf, regs);
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
}

// acc += the lo, mid, hi products of one bf16 k-step, for every n-tile: a
// chain from zero on the tensor core, then one f32 add
template <int NT>
__device__ __forceinline__ void chain_bf16(float (&acc)[NT][4], const uint32_t (&a)[4],
                                           const uint2* __restrict__ xf, int lane) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const uint2 hi = xf[(nt * 3 + 0) * 32 + lane];
    const uint2 mid = xf[(nt * 3 + 1) * 32 + lane];
    const uint2 lo = xf[(nt * 3 + 2) * 32 + lane];
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    mma_bf16(d, a, lo.x, lo.y);
    mma_bf16(d, a, mid.x, mid.y);
    mma_bf16(d, a, hi.x, hi.y);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] += d[i];
  }
}

// acc += the three TF32 products of one tf32 k-step, for every n-tile (a
// chain from zero on the tensor core, then one f32 add); a holds the four f32
// entries of the A fragment
template <int NT>
__device__ __forceinline__ void chain_tf32(float (&acc)[NT][4], const float (&a)[4],
                                           const float4* __restrict__ xf, int lane) {
  uint32_t big[4], small[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float b = tf32_big(a[i]);
    big[i] = __float_as_uint(b);
    small[i] = __float_as_uint(tf32_small(a[i], b));
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float4 x = xf[nt * 32 + lane];  // (big0, big1, small0, small1)
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(d, small, __float_as_uint(x.x), __float_as_uint(x.y));
    mma_tf32(d, big, __float_as_uint(x.z), __float_as_uint(x.w));
    mma_tf32(d, big, __float_as_uint(x.x), __float_as_uint(x.y));
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] += d[i];
  }
}

// acc[rows 16w..16w+15 of the tile] += tile @ panel   (the direct product)
template <typename T, int NT>
__device__ __forceinline__ void direct_tile(float (&acc)[NT][4],
                                            const unsigned char* __restrict__ tile,
                                            const unsigned char* __restrict__ Xf, int warp,
                                            int lane) {
  using R = Route<T>;
  if constexpr (sizeof(T) == 2) {
    const int mi = lane >> 3;
    const int row = 16 * warp + (lane & 7) + 8 * (mi & 1);
    const uint32_t base = shared_addr(tile) + row * R::kRowBytes;
    const int sw = R::swizzle(row);
    const uint2* xf = reinterpret_cast<const uint2*>(Xf);
#pragma unroll 4
    for (int ks = 0; ks < kTile / 16; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, base + (((2 * ks + (mi >> 1)) ^ sw) << 4));
      chain_bf16<NT>(acc, a, xf + (size_t)ks * NT * 3 * 32, lane);
    }
  } else {
    const int g = lane >> 2, t = lane & 3;
    const int row = 16 * warp + g;
    const float* lo = reinterpret_cast<const float*>(tile) + (size_t)row * kTile;
    const float* hi = lo + 8 * kTile;  // row + 8: the same swizzle
    const int sw = R::swizzle(row);
    const float4* xf = reinterpret_cast<const float4*>(Xf);
#pragma unroll 4
    for (int ks = 0; ks < kTile / 8; ++ks) {
      const int col = ks * 8 + 2 * t;
      const int off = 4 * ((col >> 2) ^ sw) + (col & 3);
      const float2 u = *reinterpret_cast<const float2*>(lo + off);
      const float2 v = *reinterpret_cast<const float2*>(hi + off);
      const float a[4] = {u.x, v.x, u.y, v.y};
      chain_tf32<NT>(acc, a, xf + (size_t)ks * NT * 32, lane);
    }
  }
}

// acc[columns 16w..16w+15 of the tile] += tile^T @ panel   (the transposed
// product, over all kTile rows of the tile)
template <typename T, int NT>
__device__ __forceinline__ void transposed_tile(float (&acc)[NT][4],
                                                const unsigned char* __restrict__ tile,
                                                const unsigned char* __restrict__ Xf, int warp,
                                                int lane) {
  using R = Route<T>;
  if constexpr (sizeof(T) == 2) {
    const int mi = lane >> 3;
    const int row_in = (lane & 7) + 8 * (mi >> 1);  // row within the k-step
    const int chunk = 2 * warp + (mi & 1);
    const uint32_t base =
        shared_addr(tile) + row_in * R::kRowBytes + ((chunk ^ R::swizzle(row_in)) << 4);
    const uint2* xf = reinterpret_cast<const uint2*>(Xf);
#pragma unroll 4
    for (int ks = 0; ks < kTile / 16; ++ks) {
      uint32_t a[4];
      ldmatrix_x4_trans(a, base + ks * 16 * R::kRowBytes);  // 16 rows on: the same swizzle
      chain_bf16<NT>(acc, a, xf + (size_t)ks * NT * 3 * 32, lane);
    }
  } else {
    const int g = lane >> 2, t = lane & 3;
    const int col = 16 * warp + g;
    // rows 2t and 2t + 1 of the k-step; columns col and col + 8 (two chunks on)
    const float* r0 = reinterpret_cast<const float*>(tile) + (size_t)(2 * t) * kTile;
    const float* r1 = r0 + kTile;
    const int o0 = 4 * ((col >> 2) ^ R::swizzle(2 * t)) + (col & 3);
    const int o0b = 4 * (((col + 8) >> 2) ^ R::swizzle(2 * t)) + (col & 3);
    const int o1 = 4 * ((col >> 2) ^ R::swizzle(2 * t + 1)) + (col & 3);
    const int o1b = 4 * (((col + 8) >> 2) ^ R::swizzle(2 * t + 1)) + (col & 3);
    const float4* xf = reinterpret_cast<const float4*>(Xf);
#pragma unroll 4
    for (int ks = 0; ks < kTile / 8; ++ks) {
      const int step = ks * 8 * kTile;  // 8 rows on: the same swizzle
      const float a[4] = {r0[step + o0], r0[step + o0b], r1[step + o1], r1[step + o1b]};
      chain_tf32<NT>(acc, a, xf + (size_t)ks * NT * 32, lane);
    }
  }
}

// The warp's 16 rows of a (kTile, pc) f32 tile whose first row is `dst` (row
// stride ld) = acc, or += acc; rows >= rows and columns >= pc are masked.  A
// thread holds column pairs (2t, 2t + 1): `pairs` says that every pair is
// whole (pc even) and 8-byte aligned, and is then written as one float2.
template <int NT>
__device__ __forceinline__ void store_acc(float* __restrict__ dst, size_t ld,
                                          const float (&acc)[NT][4], int warp, int lane, int rows,
                                          int pc, bool add, bool pairs) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * warp + g + 8 * h;
      const int col = nt * 8 + 2 * t;
      if (row >= rows || col >= pc) continue;
      float* y = dst + (size_t)row * ld + col;
      float2 v = make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
      if (pairs) {
        float2* y2 = reinterpret_cast<float2*>(y);
        if (add) {
          const float2 old = *y2;
          v.x += old.x;
          v.y += old.y;
        }
        *y2 = v;
      } else {
        y[0] = add ? y[0] + v.x : v.x;
        if (col + 1 < pc) y[1] = add ? y[1] + v.y : v.y;
      }
    }
  }
}

// whether store_acc may write float2 pairs into a (.., pc) tile at `dst`
__device__ __forceinline__ bool pair_stores(const float* dst, size_t ld, int pc) {
  return (pc & 1) == 0 && (ld & 1) == 0 && (reinterpret_cast<uintptr_t>(dst) & 7) == 0;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
// block rows [range_begin(g), range_begin(g + 1)) belong to CTA g of G
__host__ __device__ inline int range_begin(int g, int G, int nbr) {
  return (int)(((long long)g * nbr) / G);
}

// What a launch needs to know of the current device, asked once per device
// and kernel instantiation: the SM count, and the kernel's shared-memory
// attributes set (dynamic size `bytes`, carve-out at its maximum).  T and NT
// name the instantiation (all of them share one function-pointer type), so
// each has its own record; internal linkage keeps the record private to the
// shared library it is compiled into.
constexpr int kMaxDevices = 64;

template <typename T, int NT, typename Kernel>
static cudaError_t configure_once(Kernel kernel, size_t bytes, int* sms) {
  static int sm_of_device[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sm_of_device[dev] == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    int count = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sm_of_device[dev] = count;
  }
  *sms = sm_of_device[dev];
  return cudaSuccess;
}

}  // namespace eigenex
