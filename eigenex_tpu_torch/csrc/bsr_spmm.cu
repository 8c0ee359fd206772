// General BSR-ELL SpMM:  Y[r] = sum_k data[r, k] @ X[cols[r, k]]  for a dense
// (n, p) f32 right-hand side, X and Y row-major.
//
// Replaces: _spmm_kernel / bsr_matmat_pallas in eigenex_tpu/ops/pallas_spmv.py
// (block rows per TPU grid program, X resident on chip as (nbc, p, bn) slabs
// with p padded to 8).  Neither the slab layout nor the pad is kept: X and Y
// are the (n, p) arrays the solvers hold, and any p >= 1 is taken.
//
// Bound on this card: bytes for a few columns; at p = 16 the f32 FMA time is
// within a factor two of the streaming time (see spmm_common.cuh).  One CTA
// per block row; nothing carries between block rows and nothing is
// scattered.  Per slot the CTA loads the (bn, p) panel of X into shared
// memory, then stages the block in row panels and adds panel @ X into a
// (bm, p) accumulator in shared memory, which it writes to Y at the end: a
// block is read from device memory once, for all p columns.  ELL padding
// slots (column 0, zero block) cannot be told from a real block at column 0
// without reading them, so they are read and add zeros, as in the TPU kernel.
//
// Shapes taken: any nbr, any kmax >= 1, any bm, bn a multiple of 128, any
// p >= 1 (wider than 32 columns: in column chunks, each a launch).

#include "spmm_common.cuh"

namespace eigenex {

template <typename T>
__global__ void __launch_bounds__(kThreads)
bsr_spmm_kernel(const T* __restrict__ data, const int* __restrict__ cols,
                const float* __restrict__ X, float* __restrict__ Y, int kmax, int bm, int bn,
                int pc, size_t ldx, size_t ldy) {
  extern __shared__ __align__(16) float smem[];
  const int ps = padded_cols(pc);
  const int prows = panel_rows(bm, bn);
  float* As = smem;                     // (prows, bn) staged block rows, swizzled
  float* Xc = As + (size_t)prows * bn;  // (bn, ps) panel of X of the slot's block column
  float* Ys = Xc + (size_t)bn * ps;     // (bm, ps) this block row of Y

  const int r = blockIdx.x;
  const size_t block_elems = (size_t)bm * bn;
  zero_panel(Ys, bm * ps);

  for (int k = 0; k < kmax; ++k) {
    const int c = __ldg(cols + (size_t)r * kmax + k);
    const T* blk = data + ((size_t)r * kmax + k) * block_elems;
    __syncthreads();  // the previous slot's products have read Xc and As
    load_x_panel(Xc, X + (size_t)c * bn * ldx, bn, pc, ps, ldx);
    for (int i0 = 0; i0 < bm; i0 += prows) {
      const int rows = (bm - i0 < prows) ? (bm - i0) : prows;
      if (i0 > 0) __syncthreads();  // the previous panel's products have read As
      stage_panel<T>(As, blk + (size_t)i0 * bn, rows, bn);
      __syncthreads();
      direct_panel(As, Xc, Ys + (size_t)i0 * ps, rows, bn, ps);
    }
  }
  __syncthreads();
  store_panel(Y + (size_t)r * bm * ldy, Ys, bm, pc, ps, ldy);
}

static size_t bsr_spmm_shared_bytes(int bm, int bn, int pc) {
  const size_t ps = padded_cols(pc);
  return ((size_t)panel_rows(bm, bn) * bn + (size_t)bn * ps + (size_t)bm * ps) * sizeof(float);
}

template <typename T>
static cudaError_t bsr_spmm_launch(const void* data, const int* cols, const float* X, float* Y,
                                   int nbr, int kmax, int bm, int bn, int p, int chunk,
                                   cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(bsr_spmm_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bsr_spmm_shared_bytes(bm, bn, chunk));
  if (err != cudaSuccess) return err;
  for (int col0 = 0; col0 < p; col0 += chunk) {
    const int pc = (p - col0 < chunk) ? (p - col0) : chunk;
    bsr_spmm_kernel<T><<<nbr, kThreads, bsr_spmm_shared_bytes(bm, bn, pc), s>>>(
        static_cast<const T*>(data), cols, X + col0, Y + col0, kmax, bm, bn, pc, (size_t)p,
        (size_t)p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace eigenex

// X: (nbc * bn, p) f32 row-major, Y: (nbr * bm, p) f32 row-major.  storage:
// 0 = float32 blocks, 1 = bfloat16 blocks.  Launches on `stream`, one launch
// per chunk of at most 32 columns; returns the first CUDA error, or
// cudaErrorInvalidValue when not even 8 columns fit in shared memory.
extern "C" int eigenex_bsr_spmm(const void* data, const int* cols, const float* X, float* Y,
                                int nbr, int kmax, int bm, int bn, int p, int storage,
                                void* stream) {
  using namespace eigenex;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nbr <= 0 || p <= 0) return (int)cudaSuccess;
  int chunk = 0;  // widest column chunk whose panels fit
  for (int w = kMaxCols; w >= kColTile; w -= kColTile) {
    if (bsr_spmm_shared_bytes(bm, bn, w) <= (size_t)kMaxSharedBytes) {
      chunk = w;
      break;
    }
  }
  if (chunk == 0) return (int)cudaErrorInvalidValue;
  if (p < chunk) chunk = padded_cols(p);
  if (storage == 0)
    return (int)bsr_spmm_launch<float>(data, cols, X, Y, nbr, kmax, bm, bn, p, chunk, s);
  if (storage == 1)
    return (int)bsr_spmm_launch<__nv_bfloat16>(data, cols, X, Y, nbr, kmax, bm, bn, p, chunk, s);
  return (int)cudaErrorInvalidValue;
}
