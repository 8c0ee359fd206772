// General BSR-ELL SpMV:  y[r] = sum_k data[r, k] @ x[cols[r, k]].
//
// Replaces: _spmv_kernel / bsr_matvec_pallas in eigenex_tpu/ops/pallas_spmv.py
// (8 block rows per TPU grid program, x resident in on-chip memory, column
// ids prefetched as scalars).
//
// Bound on this card: bytes.  Every stored block is read once (4 or 2 bytes
// per entry for 2 flops); x is 1/bm of that and stays in L2.  The design
// therefore only has to keep enough 16-byte (f32) / 8-byte (bf16) loads in
// flight and never re-read a block: one CTA per block row, a warp per block
// row-of-entries, 16 rows in flight per lane, accumulators in registers
// across all kmax slots, one shuffle reduction per row at the end.  ELL
// padding slots (column 0, zero block) cannot be told from a real block at
// column 0 without reading them, so they are read and add zeros, as in the
// TPU kernel.
//
// Shapes taken: any nbr, any kmax >= 1, any bm, bn a multiple of 128.

#include "spmv_common.cuh"

namespace eigenex {

template <typename T>
__global__ void __launch_bounds__(kThreads)
bsr_spmv_kernel(const T* __restrict__ data, const int* __restrict__ cols,
                const float* __restrict__ x, float* __restrict__ y,
                int kmax, int bm, int bn) {
  const int r = blockIdx.x;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t block_elems = (size_t)bm * bn;
  const T* row_blocks = data + (size_t)r * kmax * block_elems;
  const int* row_cols = cols + (size_t)r * kmax;

  for (int i0 = 0; i0 < bm; i0 += kRowPass) {
    float acc[kRowsPerWarp];
#pragma unroll
    for (int t = 0; t < kRowsPerWarp; ++t) acc[t] = 0.f;

    for (int k = 0; k < kmax; ++k) {
      const T* blk = row_blocks + (size_t)k * block_elems;
      const float* xseg = x + (size_t)__ldg(row_cols + k) * bn;
      for (int q = 0; q < bn; q += kChunk) {
        const float4 xc = __ldg(reinterpret_cast<const float4*>(xseg + q + lane * kLane));
#pragma unroll
        for (int t = 0; t < kRowsPerWarp; ++t) {
          const int i = i0 + t * kWarps + w;
          if (i < bm) {
            const float4 d = load_block4<T>(blk + (size_t)i * bn + q + lane * kLane);
            acc[t] = dot4(d, xc, acc[t]);
          }
        }
      }
    }

#pragma unroll
    for (int t = 0; t < kRowsPerWarp; ++t) {
      const int i = i0 + t * kWarps + w;
      const float s = warp_sum(acc[t]);
      if (lane == 0 && i < bm) y[(size_t)r * bm + i] = s;
    }
  }
}

}  // namespace eigenex

// storage: 0 = float32 blocks, 1 = bfloat16 blocks.  Returns cudaGetLastError().
extern "C" int eigenex_bsr_spmv(const void* data, const int* cols, const float* x, float* y,
                                int nbr, int kmax, int bm, int bn, int storage,
                                void* stream) {
  using namespace eigenex;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nbr <= 0) return (int)cudaSuccess;
  if (storage == 0) {
    bsr_spmv_kernel<float><<<nbr, kThreads, 0, s>>>(
        static_cast<const float*>(data), cols, x, y, kmax, bm, bn);
  } else if (storage == 1) {
    bsr_spmv_kernel<__nv_bfloat16><<<nbr, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(data), cols, x, y, kmax, bm, bn);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
