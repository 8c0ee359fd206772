// Row-compressed (CSR) SpMV of a symmetric operator stored with both
// triangles:  y[i] = sum_{j in row i} val[j] * x[col[j]].
//
// Replaces no TPU kernel.  The JAX package packs every symmetric operator
// into 128x128 blocks (half storage) because the TPU multiplies on a
// 128x128 matrix unit and streams only dense tiles well.  An operator whose
// nonzeros fill few of those blocks -- the L = 24 Heisenberg sector fills
// 0.41 % of its real blocks -- then moves about 39 times its own bytes a
// product: 5.27 GB of block slots for 35 M nonzeros.  This card multiplies
// the nonzeros on CUDA cores and gathers x from its 50 MB L2, so it needs no
// tiles: sparse/accelerate.py picks this storage whenever it moves fewer
// bytes than the block pack (sparse/sym_csr.py).
//
// Bound on this card: bytes.  A product reads rowptr ((n + 1) 4 bytes), col
// (4 bytes a nonzero) and val (2 or 4 bytes a nonzero) once, reads x and
// writes y once, and does 2 flops a nonzero: at L = 24 in bf16 221.7 MB of
// operator, 0.066 ms at 3.35 TB/s, plus 35 M gathers of x (10.8 MB, held in
// L2).  Design:
//
//   * Work split.  A fixed group of G lanes takes each row, and each lane
//     takes the row's entries l, l + G, l + 2G, ... in passes of kEntries =
//     4: the col and val loads of a pass are issued together (predicated past
//     the row's end), then the x gathers they address, so a lane keeps 4
//     loads in flight on each of the three streams.  G is 1, 2, 4, 8, 16 or
//     32: the smallest power of two with 4 G entries at least the operator's
//     mean row length, so that a row takes about one pass; the wrapper picks it
//     from the input (4 at the L = 24 mean of 13).  On the L = 24 sector this
//     ran at 0.097 ms against 0.154 ms for 8 lanes of 2 entries, and within
//     3-12 % of the best of 24 (G, entries) pairs on four operators of 3 to 70
//     entries a row (PERF.md).  The 32 lanes of a warp read 32 / G
//     neighbouring rows, which lie next to each other in col and val.
//   * Memory traffic.  rowptr, col and val are read once a product, with the
//     streaming (evict-first) hint, so that they do not push x out of L2; x
//     is read through the read-only path and stays in L2 for the gathers.
//   * Row sums.  Each lane sums its entries in order in one f32 register;
//     the group's G partials are summed by an xor butterfly of shuffles in a
//     fixed order, and the group's first lane writes y[i].
//
// No atomics and no scratch: every sum is in an order fixed by the operator
// (the row's entries in storage order, then the butterfly), so two runs on
// the same input are bit-equal, and a CUDA graph replay is bit-equal to an
// eager launch.  Precision rule of spmv_common.cuh: f32 or bf16 values
// (bf16 widened exactly to f32), f32 x, f32 FMAs, f32 y.
//
// Shapes taken: any n_rows >= 0, nnz < 2^31 (int32 rowptr and col).

#include "spmv_common.cuh"

namespace eigenex {
namespace csrv {

constexpr int kThreads = 256;  // threads a CTA: a multiple of every group size
constexpr int kEntries = 4;    // entries a lane loads in one pass

// One stored value, read with the streaming hint and widened to f32 (bf16 ->
// f32 is a 16-bit shift, exact)
template <typename T>
__device__ __forceinline__ float stream_value(const T* p);

template <>
__device__ __forceinline__ float stream_value<float>(const float* p) {
  return __ldcs(p);
}

template <>
__device__ __forceinline__ float stream_value<__nv_bfloat16>(const __nv_bfloat16* p) {
  const unsigned short bits = __ldcs(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
    csr_spmv_kernel(const int* __restrict__ rowptr, const int* __restrict__ col,
                    const T* __restrict__ val, const float* __restrict__ x,
                    float* __restrict__ y, int n_rows) {
  const long long row = ((long long)blockIdx.x * kThreads + threadIdx.x) / G;
  const int lane = threadIdx.x % G;
  // a group past the last row takes an empty range: every lane of the warp
  // reaches the shuffles below
  const bool live = row < n_rows;
  int j = 0, end = 0;
  if (live) {
    j = __ldcs(rowptr + row) + lane;
    end = __ldcs(rowptr + row + 1);
  }
  float acc = 0.f;
  for (; j < end; j += kEntries * G) {
    int c[kEntries];
    float v[kEntries];
#pragma unroll
    for (int e = 0; e < kEntries; ++e) {
      const bool in = j + e * G < end;
      c[e] = in ? __ldcs(col + j + e * G) : 0;
      v[e] = in ? stream_value<T>(val + j + e * G) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < kEntries; ++e)
      if (j + e * G < end) acc = fmaf(v[e], __ldg(x + c[e]), acc);
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o, G);
  if (live && lane == 0) y[row] = acc;
}

template <typename T, int G>
cudaError_t launch(const int* rowptr, const int* col, const void* val, const float* x,
                   float* y, int n_rows, cudaStream_t s) {
  const long long threads = (long long)n_rows * G;
  const long long grid = (threads + kThreads - 1) / kThreads;
  csr_spmv_kernel<T, G><<<(unsigned)grid, kThreads, 0, s>>>(
      rowptr, col, static_cast<const T*>(val), x, y, n_rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_group(const int* rowptr, const int* col, const void* val, const float* x,
                         float* y, int n_rows, int group, cudaStream_t s) {
  switch (group) {
    case 1: return launch<T, 1>(rowptr, col, val, x, y, n_rows, s);
    case 2: return launch<T, 2>(rowptr, col, val, x, y, n_rows, s);
    case 4: return launch<T, 4>(rowptr, col, val, x, y, n_rows, s);
    case 8: return launch<T, 8>(rowptr, col, val, x, y, n_rows, s);
    case 16: return launch<T, 16>(rowptr, col, val, x, y, n_rows, s);
    case 32: return launch<T, 32>(rowptr, col, val, x, y, n_rows, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace csrv
}  // namespace eigenex

// storage: 0 = float32 values, 1 = bfloat16 values; group: lanes a row (1, 2,
// 4, 8, 16 or 32).  Launches one kernel on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for another storage or group.
extern "C" int eigenex_csr_spmv(const int* rowptr, const int* col, const void* val,
                                const float* x, float* y, int n_rows, int group, int storage,
                                void* stream) {
  using namespace eigenex::csrv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows < 0) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  if (storage == 0) return (int)launch_group<float>(rowptr, col, val, x, y, n_rows, group, s);
  if (storage == 1)
    return (int)launch_group<__nv_bfloat16>(rowptr, col, val, x, y, n_rows, group, s);
  return (int)cudaErrorInvalidValue;
}
