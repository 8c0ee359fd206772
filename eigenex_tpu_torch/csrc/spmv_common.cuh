// Shared pieces of the block-sparse SpMV kernels (sm_90a, plain C ABI): the
// precision rule below for both, and the body of bsr_spmv.cu.
// (sym_bsr_spmv.cu has a design of its own, described in its head.)
//
// Both kernels stream every block once with 16-byte loads, many in
// flight a lane, which is what hides the latency of device memory: they do
// 2-4 flops per byte they stream and are bound by bytes, far below the FMA
// rate.  (Each kernel's head gives its work decomposition.)
//
// Precision rule (replaces _dot_mode/_sdot of eigenex_tpu/ops/pallas_spmv.py):
// blocks are stored as f32 or bf16, x and every accumulator are f32, and
// the products are plain f32 FMAs on CUDA cores.  A bf16 block widened to
// f32 in registers is exact, so bf16 storage costs nothing in accuracy;
// the hi/mid/lo split of x in the TPU kernels exists only because its
// matrix unit multiplies in bf16.  The SpMV kernels use no tensor-core path.
// The rule for every kernel: no product of x in one TF32 or bf16 pass -- that
// brings back the ~1e-3 floor that stalls Lanczos; the SpMM kernels do use
// the tensor cores, compensated to f32 grade (spmm_common.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace eigenex {

constexpr int kWarps = 8;                        // warps per CTA
constexpr int kThreads = kWarps * 32;            // threads per CTA
constexpr int kLane = 4;                         // elements per lane per load
constexpr int kChunk = 32 * kLane;               // columns per warp-wide load

// Four consecutive stored elements, widened to f32.  Block data is read
// exactly once per matvec, so it is loaded with the streaming hint and
// leaves the caches to x.
template <typename T>
__device__ __forceinline__ float4 load_block4(const T* p);

template <>
__device__ __forceinline__ float4 load_block4<float>(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}

template <>
__device__ __forceinline__ float4 load_block4<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 raw = __ldcs(reinterpret_cast<const uint2*>(p));
  float4 v;  // bf16 -> f32 is a 16-bit shift; little endian: element 0 is the low half
  v.x = __uint_as_float(raw.x << 16);
  v.y = __uint_as_float(raw.x & 0xffff0000u);
  v.z = __uint_as_float(raw.y << 16);
  v.w = __uint_as_float(raw.y & 0xffff0000u);
  return v;
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
  return acc;
}

// Butterfly sum over the 32 lanes: a fixed order, the same value in every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace eigenex
