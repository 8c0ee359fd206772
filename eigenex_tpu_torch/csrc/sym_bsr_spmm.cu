// Symmetric BSR SpMM on half storage:  Y = (D + U + U^T) X  for a dense
// (n, p) f32 right-hand side, X and Y row-major; D the diagonal blocks, U the
// strictly-upper blocks in ELL slots.
//
// Replaces, with ONE design, the three TPU kernels that
// sym_bsr_matmat_pallas (eigenex_tpu/ops/pallas_spmv.py) chooses between by
// on-chip memory size: _sym_spmm_kernel (X and Y panels resident, cross-row
// scatter), _sym_spmm_stream_kernel (banded, strip windows of X and a carry
// of Y between strips) and _sym_spmm_ring_kernel (far reach, slab rings).
// All three are correct only because a TPU grid runs its programs in order on
// one core.  CTAs run concurrently in no order, so the two-pass schedule of
// sym_bsr_spmv.cu is carried over to p columns:
//
//   pass 1, one CTA per block row r: for D_r and every real U[r,k] the CTA
//     stages the block in shared memory ONCE (read once from device memory,
//     for all p columns) and applies it twice -- the direct part
//     Y[r] = D_r X[r] + sum_k U[r,k] X[c_k], kept in a (b, p) accumulator in
//     shared memory and written to Y at the end, and the transposed partial
//     T[r,k] = U[r,k]^T X[r], written to an f32 scratch of shape
//     (nbr, ku, b, p) that the caller allocates;
//   pass 2, one CTA per block column c: Y[c] += sum of T[r,k] over the slots
//     whose column is c, walked in the fixed (r, k) order of the container's
//     column-sorted index of the real slots; (b, p) tiles are contiguous in
//     the scratch, so the walk is coalesced.
//
// No floating-point atomics and every sum in a fixed order: two runs on one
// input are bit-equal, for any reach, known or not.  A slot is real when its
// column lies strictly above the diagonal (c > r); ELL padding slots (column
// 0, zero block) are skipped in pass 1 -- not even read -- and are absent
// from the index.
//
// Bound on this card: see spmm_common.cuh.  Unlike the SpMV, the scratch is
// not small here: written once and read back once, it is about 4 p bytes per
// row of every real upper block, a tenth to a sixth of all bytes moved at
// p = 16.  It is neither input nor output of the function, so it is reported
// beside the bound, not inside it.
//
// Shapes taken: any nbr, any ku >= 1, square blocks with b a multiple of 128,
// any p >= 1 (wider than 32 columns: in column chunks, two launches each).

#include "spmm_common.cuh"

namespace eigenex {

template <typename T>
__global__ void __launch_bounds__(kThreads)
sym_bsr_spmm_pass1_kernel(const T* __restrict__ diag, const T* __restrict__ upper,
                          const int* __restrict__ cols, const float* __restrict__ X,
                          float* __restrict__ Y, float* __restrict__ tbuf, int ku, int b, int pc,
                          size_t ldx, size_t ldy) {
  extern __shared__ __align__(16) float smem[];
  const int ps = padded_cols(pc);
  const int prows = panel_rows(b, b);
  const size_t panel = (size_t)b * ps;
  float* As = smem;                    // (prows, b) staged block rows, swizzled
  float* Xr = As + (size_t)prows * b;  // (b, ps) X of this block row
  float* Xc = Xr + panel;              // (b, ps) X of the slot's block column
  float* Ys = Xc + panel;              // (b, ps) direct part of Y[r]
  float* Ts = Ys + panel;              // (b, ps) transposed partial of the slot

  const int r = blockIdx.x;
  const size_t block_elems = (size_t)b * b;
  load_x_panel(Xr, X + (size_t)r * b * ldx, b, pc, ps, ldx);
  zero_panel(Ys, b * ps);

  // slot -1 is the diagonal block; slots 0..ku-1 the upper blocks
  for (int s = -1; s < ku; ++s) {
    int c = r;
    const T* blk = diag + (size_t)r * block_elems;
    if (s >= 0) {
      c = __ldg(cols + (size_t)r * ku + s);
      if (c <= r) continue;  // padding slot: same decision in every thread of the CTA
      blk = upper + ((size_t)r * ku + s) * block_elems;
    }
    __syncthreads();  // the previous slot has read Xc, As and Ts; Xr and Ys are written
    const float* xin = Xr;
    if (s >= 0) {
      load_x_panel(Xc, X + (size_t)c * b * ldx, b, pc, ps, ldx);
      zero_panel(Ts, b * ps);
      xin = Xc;
    }
    for (int i0 = 0; i0 < b; i0 += prows) {
      const int rows = (b - i0 < prows) ? (b - i0) : prows;
      if (i0 > 0) __syncthreads();  // the previous panel's products have read As
      stage_panel<T>(As, blk + (size_t)i0 * b, rows, b);
      __syncthreads();
      direct_panel(As, xin, Ys + (size_t)i0 * ps, rows, b, ps);
      if (s >= 0) transposed_panel(As, Xr + (size_t)i0 * ps, Ts, rows, b, ps);
    }
    if (s >= 0) {
      __syncthreads();
      store_panel(tbuf + ((size_t)r * ku + s) * b * pc, Ts, b, pc, ps, (size_t)pc);
    }
  }
  __syncthreads();
  store_panel(Y + (size_t)r * b * ldy, Ys, b, pc, ps, ldy);
}

__global__ void __launch_bounds__(kThreads)
sym_bsr_spmm_pass2_kernel(const int* __restrict__ col_ptr, const int* __restrict__ slot_ids,
                          const float* __restrict__ tbuf, float* __restrict__ Y, int b, int pc,
                          size_t ldy) {
  const int c = blockIdx.x;
  const int beg = __ldg(col_ptr + c);
  const int end = __ldg(col_ptr + c + 1);
  if (beg == end) return;
  const int tile = b * pc;
  for (int e = threadIdx.x; e < tile; e += kThreads) {
    const int row = e / pc;
    const int col = e - row * pc;
    float* y = Y + ((size_t)c * b + row) * ldy + col;
    float acc = *y;
    for (int s = beg; s < end; ++s) acc += tbuf[(size_t)__ldg(slot_ids + s) * tile + e];
    *y = acc;
  }
}

static size_t sym_bsr_spmm_shared_bytes(int b, int pc) {
  return ((size_t)panel_rows(b, b) * b + 4 * (size_t)b * padded_cols(pc)) * sizeof(float);
}

template <typename T>
static cudaError_t sym_bsr_spmm_launch(const void* diag, const void* upper, const int* cols,
                                       const int* col_ptr, const int* slot_ids, const float* X,
                                       float* Y, float* tbuf, int nbr, int ku, int b, int p,
                                       int chunk, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(sym_bsr_spmm_pass1_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)sym_bsr_spmm_shared_bytes(b, chunk));
  if (err != cudaSuccess) return err;
  for (int col0 = 0; col0 < p; col0 += chunk) {
    const int pc = (p - col0 < chunk) ? (p - col0) : chunk;
    sym_bsr_spmm_pass1_kernel<T><<<nbr, kThreads, sym_bsr_spmm_shared_bytes(b, pc), s>>>(
        static_cast<const T*>(diag), static_cast<const T*>(upper), cols, X + col0, Y + col0,
        tbuf, ku, b, pc, (size_t)p, (size_t)p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    sym_bsr_spmm_pass2_kernel<<<nbr, kThreads, 0, s>>>(col_ptr, slot_ids, tbuf, Y + col0, b, pc,
                                                       (size_t)p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace eigenex

// X, Y: (nbr * b, p) f32 row-major.  tbuf: f32 scratch of at least
// nbr * ku * b * min(p, 32) entries.  storage: 0 = float32 blocks,
// 1 = bfloat16 blocks.  Launches pass 1 then pass 2 on `stream`, once per
// chunk of at most 32 columns; returns the first CUDA error, or
// cudaErrorInvalidValue when not even 8 columns fit in shared memory.
extern "C" int eigenex_sym_bsr_spmm(const void* diag, const void* upper, const int* cols,
                                    const int* col_ptr, const int* slot_ids, const float* X,
                                    float* Y, float* tbuf, int nbr, int ku, int b, int p,
                                    int storage, void* stream) {
  using namespace eigenex;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nbr <= 0 || p <= 0) return (int)cudaSuccess;
  int chunk = 0;  // widest column chunk whose panels fit
  for (int w = kMaxCols; w >= kColTile; w -= kColTile) {
    if (sym_bsr_spmm_shared_bytes(b, w) <= (size_t)kMaxSharedBytes) {
      chunk = w;
      break;
    }
  }
  if (chunk == 0) return (int)cudaErrorInvalidValue;
  if (p < chunk) chunk = padded_cols(p);
  if (storage == 0)
    return (int)sym_bsr_spmm_launch<float>(diag, upper, cols, col_ptr, slot_ids, X, Y, tbuf, nbr,
                                           ku, b, p, chunk, s);
  if (storage == 1)
    return (int)sym_bsr_spmm_launch<__nv_bfloat16>(diag, upper, cols, col_ptr, slot_ids, X, Y,
                                                   tbuf, nbr, ku, b, p, chunk, s);
  return (int)cudaErrorInvalidValue;
}
