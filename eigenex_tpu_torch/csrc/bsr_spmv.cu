// General BSR-ELL SpMV:  y[r] = sum_k data[r, k] @ x[cols[r, k]].
//
// Replaces: _spmv_kernel / bsr_matvec_pallas in eigenex_tpu/ops/pallas_spmv.py
// (8 block rows per TPU grid program, x resident in on-chip memory, column
// ids prefetched as scalars).
//
// Bound on this card: bytes.  Every stored block is read once (4 or 2 bytes
// per entry for 2 flops); x is 1/bm of that and stays in L2.  ELL padding
// slots (column 0, zero block) cannot be told from a real block at column 0
// without reading them, so they are read and add zeros, as in the TPU kernel.
// The design keeps many 16-byte loads in flight whatever the block shape,
// and never re-reads a block:
//
//   * Units of work.  A unit is one row group of one block row: kGroup rows
//     (16 for f32 blocks, 32 for bf16), over every slot and every 128-column
//     chunk of the row.  A step is one (slot, chunk) of the unit: each lane
//     issues kLoads = 16 loads of 16 bytes, one for each of its rows, and one
//     float4 load of x through the read-only path (x stays in L2), then
//     multiplies.  f32: the 32 lanes cover a row's 128 columns; bf16: 16
//     lanes cover a row and the two half-warps take rows 16 apart.  So a
//     32-row block keeps 16 loads a lane in flight, as a 128-row one does
//     (the design before this one gave a warp whole rows i % 8 of a block: 4
//     loads a lane at bm = 32).
//   * Persistent grid: as many CTAs of 8 warps as fit on the SMs at once
//     (the occupancy of this kernel, asked once a device), walking the units
//     in order, a CTA at a time.
//   * Few units (a boundary piece of one block row, a narrow shard): a unit's
//     steps are split over S = 2, 4 or 8 warps of one CTA (step j to warp
//     j % S), so that the card holds about one wave of warps.  Their partial
//     rows meet in shared memory and are added in warp order.
//   * Row sums: each lane ends a unit with 16 partial sums, one for each row,
//     summed over the lanes of a row by a butterfly reduce-scatter (15 or 16
//     shuffles, after which each row's sum sits on its own lane), not by a
//     full butterfly a row (80 shuffles).
//
// No atomics.  Every sum has a fixed order for a given shape (registers
// over steps in order, the butterfly, the S partials in warp order), so two
// runs on the same input are bit-equal.  S depends on the shape and the
// card only.
//
// Shapes taken: any nbr >= 1, any kmax >= 1, any bm >= 1, bn a multiple of 128.

#include "spmv_common.cuh"

#include <atomic>

namespace eigenex {

constexpr int kLoads = 16;         // 16-byte block loads a lane keeps in flight in a step
constexpr int kMaxDevices = 64;

template <typename T> struct Rows;  // how the lanes of a warp cover a 128-column chunk
template <> struct Rows<float> {
  static constexpr int kLanesPerRow = 32;   // 4 f32 entries a lane
  static constexpr int kGroup = kLoads;     // rows of a unit
};
template <> struct Rows<__nv_bfloat16> {
  static constexpr int kLanesPerRow = 16;   // 8 bf16 entries a lane
  static constexpr int kGroup = 2 * kLoads;
};

// Four bf16 entries (two 32-bit words), widened to f32: a 16-bit shift;
// little endian, so element 0 is the low half.
__device__ __forceinline__ float4 widen_bf16x4(unsigned a, unsigned b) {
  return make_float4(__uint_as_float(a << 16), __uint_as_float(a & 0xffff0000u),
                     __uint_as_float(b << 16), __uint_as_float(b & 0xffff0000u));
}

// One halving of the butterfly reduce-scatter: V values a lane become V/2,
// each summed with the partner lane (lane ^ OFF); the lane keeps the upper
// half of the indices when its OFF bit is set.  One value is added on one
// lane only, in a fixed order.
template <int V, int OFF>
__device__ __forceinline__ void fold(float (&v)[kLoads], int lane) {
  const bool upper = lane & OFF;
#pragma unroll
  for (int j = 0; j < V / 2; ++j) {
    const float send = upper ? v[j] : v[j + V / 2];
    const float keep = upper ? v[j + V / 2] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// The 16 row sums of a warp's unit, one a lane; returns the lane's row in
// the unit, or -1 for a lane that holds a copy.  f32: v[t] is row t over
// all 32 lanes; afterwards lanes 2j and 2j+1 hold row j.  bf16: v[t] is row
// 16 h + t over the 16 lanes of half-warp h; afterwards lane l holds row l.
template <typename T>
__device__ __forceinline__ int reduce_rows(float (&v)[kLoads], int lane) {
  if constexpr (Rows<T>::kLanesPerRow == 32) {
    fold<16, 16>(v, lane);
    fold<8, 8>(v, lane);
    fold<4, 4>(v, lane);
    fold<2, 2>(v, lane);
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
    return (lane & 1) ? -1 : lane >> 1;
  } else {
    fold<16, 8>(v, lane);
    fold<8, 4>(v, lane);
    fold<4, 2>(v, lane);
    fold<2, 1>(v, lane);
    return lane;
  }
}

// One step of a unit: slot k, columns [q, q + 128) of rows row0 .. of the
// lane's half-warp (rows beyond bm are not read).
template <typename T>
__device__ __forceinline__ void step(const T* __restrict__ blk, const float* __restrict__ xseg,
                                     int row0, int bm, int bn, int q, int lane,
                                     float (&acc)[kLoads]) {
  if constexpr (Rows<T>::kLanesPerRow == 32) {
    const int c = q + lane * 4;
    const float4 xc = __ldg(reinterpret_cast<const float4*>(xseg + c));
    float4 d[kLoads];
#pragma unroll
    for (int t = 0; t < kLoads; ++t)
      if (row0 + t < bm) d[t] = load_block4<float>(blk + (size_t)(row0 + t) * bn + c);
#pragma unroll
    for (int t = 0; t < kLoads; ++t)
      if (row0 + t < bm) acc[t] = dot4(d[t], xc, acc[t]);
  } else {
    const int c = q + (lane & 15) * 8;
    const float4 x0 = __ldg(reinterpret_cast<const float4*>(xseg + c));
    const float4 x1 = __ldg(reinterpret_cast<const float4*>(xseg + c + 4));
    uint4 raw[kLoads];
#pragma unroll
    for (int t = 0; t < kLoads; ++t)
      if (row0 + t < bm)
        raw[t] = __ldcs(reinterpret_cast<const uint4*>(blk + (size_t)(row0 + t) * bn + c));
#pragma unroll
    for (int t = 0; t < kLoads; ++t)
      if (row0 + t < bm)
        acc[t] = dot4(widen_bf16x4(raw[t].z, raw[t].w), x1,
                      dot4(widen_bf16x4(raw[t].x, raw[t].y), x0, acc[t]));
  }
}

// split: warps a unit (1, 2, 4 or 8); a CTA takes kWarps / split units at a time.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
bsr_spmv_kernel(const T* __restrict__ data, const int* __restrict__ cols,
                const float* __restrict__ x, float* __restrict__ y,
                int nbr, int kmax, int bm, int bn, int groups, int split) {
  constexpr int G = Rows<T>::kGroup;
  __shared__ float part[kWarps][32];
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int half = Rows<T>::kLanesPerRow == 32 ? 0 : lane >> 4;
  const int per_cta = kWarps / split;
  const int s = w % split;
  const int chunks = bn / kChunk;
  const int steps = kmax * chunks;
  const long long units = (long long)nbr * groups;
  const size_t block_elems = (size_t)bm * bn;

  for (long long base = (long long)blockIdx.x * per_cta; base < units;
       base += (long long)gridDim.x * per_cta) {
    const long long u = base + w / split;
    float acc[kLoads];
#pragma unroll
    for (int t = 0; t < kLoads; ++t) acc[t] = 0.f;
    int r = 0, g0 = 0;
    if (u < units) {
      r = (int)(u / groups);
      g0 = (int)(u % groups) * G;
      const T* row_blocks = data + (size_t)r * kmax * block_elems;
      const int* row_cols = cols + (size_t)r * kmax;
      const int row0 = g0 + half * kLoads;
      for (int j = s; j < steps; j += split) {
        const int k = j / chunks;
        const int q = (j - k * chunks) * kChunk;
        step<T>(row_blocks + (size_t)k * block_elems, x + (size_t)__ldg(row_cols + k) * bn,
                row0, bm, bn, q, lane, acc);
      }
    }
    const int mine = reduce_rows<T>(acc, lane);
    if (split == 1) {
      if (u < units && mine >= 0 && g0 + mine < bm) y[(size_t)r * bm + g0 + mine] = acc[0];
      continue;
    }
    // partial rows of the unit's split warps, added in warp order
    if (mine >= 0) part[w][mine] = acc[0];
    __syncthreads();
    if (s == 0 && u < units && mine >= 0 && g0 + mine < bm) {
      float sum = part[w][mine];
      for (int o = 1; o < split; ++o) sum += part[w + o][mine];
      y[(size_t)r * bm + g0 + mine] = sum;
    }
    __syncthreads();
  }
}

struct Occupancy {
  std::atomic<int> sms{0};
  std::atomic<int> ctas{0};
};

// SMs and CTAs an SM of kernel<T> on the current device, asked once.
template <typename T>
cudaError_t occupancy(int& sms, int& ctas) {
  static Occupancy seen[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  Occupancy& o = seen[dev < kMaxDevices ? dev : kMaxDevices - 1];
  sms = o.sms.load();
  ctas = o.ctas.load();
  if (sms > 0 && ctas > 0 && dev < kMaxDevices) return cudaSuccess;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, bsr_spmv_kernel<T>, kThreads, 0);
  if (e != cudaSuccess) return e;
  if (ctas < 1) ctas = 1;
  o.sms.store(sms);
  o.ctas.store(ctas);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* data, const int* cols, const float* x, float* y, int nbr,
                   int kmax, int bm, int bn, cudaStream_t s) {
  int sms = 0, ctas = 0;
  cudaError_t e = occupancy<T>(sms, ctas);
  if (e != cudaSuccess) return e;
  const int groups = (bm + Rows<T>::kGroup - 1) / Rows<T>::kGroup;
  const long long units = (long long)nbr * groups;
  const long long resident = (long long)sms * ctas * kWarps;  // warps the card holds at once
  const int steps = kmax * (bn / kChunk);
  int split = 1;
  while (split < kWarps && 2 * split <= steps && units * 2 * split <= resident) split *= 2;
  const long long per_cta = kWarps / split;
  const long long wanted = (units + per_cta - 1) / per_cta;
  const int grid = (int)(wanted < (long long)sms * ctas ? wanted : (long long)sms * ctas);
  bsr_spmv_kernel<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(data), cols, x, y, nbr,
                                               kmax, bm, bn, groups, split);
  return cudaGetLastError();
}

}  // namespace eigenex

// storage: 0 = float32 blocks, 1 = bfloat16 blocks.  Returns a cudaError_t.
extern "C" int eigenex_bsr_spmv(const void* data, const int* cols, const float* x, float* y,
                                int nbr, int kmax, int bm, int bn, int storage,
                                void* stream) {
  using namespace eigenex;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nbr <= 0) return (int)cudaSuccess;
  if (storage == 0) return (int)launch<float>(data, cols, x, y, nbr, kmax, bm, bn, s);
  if (storage == 1) return (int)launch<__nv_bfloat16>(data, cols, x, y, nbr, kmax, bm, bn, s);
  return (int)cudaErrorInvalidValue;
}
