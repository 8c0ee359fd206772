// Symmetric BSR SpMV on half storage:  y = (D + U + U^T) x, with D the
// diagonal blocks and U the strictly-upper blocks in ELL slots.
//
// Replaces, with ONE design, the three TPU kernels that
// sym_bsr_matvec_pallas (eigenex_tpu/ops/pallas_spmv.py) chooses between by
// on-chip memory size: _sym_spmv_stream_kernel (banded, carry buffer between
// strips), _sym_spmv_kernel (whole x and y resident, cross-row scatter) and
// _sym_spmv_ring_kernel (far reach, x and y in modular rings).  All three
// are correct only because a TPU grid runs its programs in order on one
// core; CTAs here run concurrently in no order, so the scatter
// y[c] += U[r,k]^T x[r] is split off into a second pass:
//
//   pass 1, one CTA per block row r: reads D_r and every real U[r,k] ONCE
//     and uses each loaded register twice -- for the direct part
//     y[r] = D_r x_r + sum_k U[r,k] x[c_k], written to y, and for the
//     transposed partial t[r,k,:] = U[r,k]^T x_r, written to an f32 scratch
//     of shape (nbr, ku, b) that the caller allocates;
//   pass 2, one CTA per block column c: y[c] += sum of t[r,k,:] over the
//     slots whose column is c, walked in the fixed (r, k) order of a
//     column-sorted index of the real slots that the container builds once.
//
// That keeps the three properties the storage exists for: each stored block
// is read once and applied twice; no floating-point atomics, every sum in a
// fixed order, so two runs are bit-equal; and any reach works, known or not,
// because nothing depends on how far c_k is from r.  It was preferred to an
// even-strips-then-odd-strips schedule (strip >= reach) because that one
// loses its parallelism exactly where the reach is large.
//
// Bound on this card: bytes.  The blocks dominate: (1 + ku) n b itemsize
// bytes against 2 ku n 4 bytes of scratch written and read back, under 2% at
// b = 128 in bf16.  A slot is real when its column lies strictly above the
// diagonal (c > r); ELL padding slots (column 0, zero block) are skipped in
// pass 1 -- they are not even read -- and are absent from the index, so they
// are never added into block column 0.
//
// Shapes taken: any nbr, any ku >= 1, square blocks with b a multiple of 128.

#include "spmv_common.cuh"

namespace eigenex {

template <typename T>
__global__ void __launch_bounds__(kThreads)
sym_bsr_pass1_kernel(const T* __restrict__ diag, const T* __restrict__ upper,
                     const int* __restrict__ cols, const float* __restrict__ x,
                     float* __restrict__ y, float* __restrict__ tbuf, int ku, int b) {
  // per-warp partial of the transposed product over one 128-column chunk
  __shared__ __align__(16) float tpart[kWarps][kChunk];

  const int r = blockIdx.x;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t block_elems = (size_t)b * b;
  const float* xrow = x + (size_t)r * b;

  for (int i0 = 0; i0 < b; i0 += kRowPass) {
    float acc[kRowsPerWarp];  // direct part, rows owned by this warp
    float xr[kRowsPerWarp];   // x_r at those rows (uniform across the warp)
#pragma unroll
    for (int t = 0; t < kRowsPerWarp; ++t) {
      const int i = i0 + t * kWarps + w;
      acc[t] = 0.f;
      xr[t] = (i < b) ? __ldg(xrow + i) : 0.f;
    }

    // slot -1 is the diagonal block; slots 0..ku-1 the upper blocks
    for (int s = -1; s < ku; ++s) {
      int c = r;
      const T* blk = diag + (size_t)r * block_elems;
      if (s >= 0) {
        c = __ldg(cols + (size_t)r * ku + s);
        if (c <= r) continue;  // padding slot: same decision in every thread of the CTA
        blk = upper + ((size_t)r * ku + s) * block_elems;
      }
      const float* xseg = x + (size_t)c * b;
      for (int q = 0; q < b; q += kChunk) {
        const float4 xc = __ldg(reinterpret_cast<const float4*>(xseg + q + lane * kLane));
        float4 tacc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int t = 0; t < kRowsPerWarp; ++t) {
          const int i = i0 + t * kWarps + w;
          if (i < b) {
            const float4 d = load_block4<T>(blk + (size_t)i * b + q + lane * kLane);
            acc[t] = dot4(d, xc, acc[t]);
            tacc.x = fmaf(d.x, xr[t], tacc.x);
            tacc.y = fmaf(d.y, xr[t], tacc.y);
            tacc.z = fmaf(d.z, xr[t], tacc.z);
            tacc.w = fmaf(d.w, xr[t], tacc.w);
          }
        }
        if (s >= 0) {
          *reinterpret_cast<float4*>(&tpart[w][lane * kLane]) = tacc;
          __syncthreads();
          if (threadIdx.x < kChunk) {
            float sum = 0.f;
#pragma unroll
            for (int ww = 0; ww < kWarps; ++ww) sum += tpart[ww][threadIdx.x];
            float* dst = tbuf + ((size_t)r * ku + s) * b + q + threadIdx.x;
            // a later row pass (b > 128) adds to what the first one wrote;
            // the same thread owns the address in every pass
            *dst = (i0 == 0) ? sum : (*dst + sum);
          }
          __syncthreads();
        }
      }
    }

#pragma unroll
    for (int t = 0; t < kRowsPerWarp; ++t) {
      const int i = i0 + t * kWarps + w;
      const float sum = warp_sum(acc[t]);
      if (lane == 0 && i < b) y[(size_t)r * b + i] = sum;
    }
  }
}

__global__ void sym_bsr_pass2_kernel(const int* __restrict__ col_ptr,
                                     const int* __restrict__ slot_ids,
                                     const float* __restrict__ tbuf, float* __restrict__ y,
                                     int b) {
  const int c = blockIdx.x;
  const int beg = __ldg(col_ptr + c);
  const int end = __ldg(col_ptr + c + 1);
  if (beg == end) return;
  for (int j = threadIdx.x; j < b; j += blockDim.x) {
    float acc = y[(size_t)c * b + j];
    for (int s = beg; s < end; ++s) acc += tbuf[(size_t)__ldg(slot_ids + s) * b + j];
    y[(size_t)c * b + j] = acc;
  }
}

}  // namespace eigenex

// storage: 0 = float32 blocks, 1 = bfloat16 blocks.  tbuf: (nbr, ku, b) f32
// scratch.  Launches pass 1 then pass 2 on `stream`; returns cudaGetLastError().
extern "C" int eigenex_sym_bsr_spmv(const void* diag, const void* upper, const int* cols,
                                    const int* col_ptr, const int* slot_ids, const float* x,
                                    float* y, float* tbuf, int nbr, int ku, int b,
                                    int storage, void* stream) {
  using namespace eigenex;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nbr <= 0) return (int)cudaSuccess;
  if (storage == 0) {
    sym_bsr_pass1_kernel<float><<<nbr, kThreads, 0, s>>>(
        static_cast<const float*>(diag), static_cast<const float*>(upper), cols, x, y, tbuf,
        ku, b);
  } else if (storage == 1) {
    sym_bsr_pass1_kernel<__nv_bfloat16><<<nbr, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(diag), static_cast<const __nv_bfloat16*>(upper),
        cols, x, y, tbuf, ku, b);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sym_bsr_pass2_kernel<<<nbr, kChunk, 0, s>>>(col_ptr, slot_ids, tbuf, y, b);
  return (int)cudaGetLastError();
}
