// Symmetric BSR SpMV on half storage:  y = (D + U + U^T) x, with D the
// diagonal blocks and U the strictly-upper blocks in ELL slots.
//
// Replaces, with ONE design, the three TPU kernels that
// sym_bsr_matvec_pallas (eigenex_tpu/ops/pallas_spmv.py) chooses between by
// on-chip memory size: _sym_spmv_stream_kernel (banded, carry buffer between
// strips), _sym_spmv_kernel (whole x and y resident, cross-row scatter) and
// _sym_spmv_ring_kernel (far reach, x and y in modular rings), and their
// precision rule _dot_mode/_sdot (see spmv_common.cuh: f32 FMAs on blocks
// widened exactly in registers, x never rounded).  All three are correct only
// because a TPU grid runs its programs in order on one core; here warps run
// concurrently in no order.
//
// Bound on this card: bytes.  A stored entry costs 4 (f32) or 2 (bf16) bytes
// and does 4 flops (it is applied twice), about 2 flops a byte in bf16: the
// FMAs take under a fifth of the instruction rate at 3.35 TB/s, so the only aim is
// to keep device memory busy.  Design:
//
//   * Units of work.  A unit is a row tile of kRows = 128 rows of one block
//     row r: those rows of D_r and of every real U[r,k].  Each unit belongs to
//     ONE warp.  The grid is persistent (SMs x 2 CTAs an SM, four warps a CTA):
//     warp g of G takes unit g, and after each unit the next one in order
//     from a ticket counter, so the warps sweep the block rows in order and
//     rows with more real slots (more bytes) do not leave other warps idle
//     at the end.  Tiles of 128 rows split 256- and 384-wide blocks.  Not
//     64: that doubles the partials, and at 3 CTAs an SM (168 registers) the
//     kernel spills and measured slower.
//   * 16-byte loads, 16 in flight a lane.  f32: a lane loads 4 entries and
//     the 32 lanes cover one row of a 128-column chunk; bf16: a lane loads 8
//     entries, 16 lanes cover a row and the two half-warps take rows 32
//     apart.  A batch is 16 loads a lane (256 bytes; 8 KB a warp) requested
//     together, then used.  Blocks are read with the streaming hint, once.
//     210 (f32) and 254 (bf16) registers a thread, no spills: eight warps an
//     SM, 64 KB of loads in flight.
//   * Both products from the same registers, no barrier.  A lane owns fixed
//     columns of the chunk and a fixed set of rows, so
//       - the transposed partial t = U[r,k]^T x_r over the unit's rows is
//         summed by its owner lane in registers (bf16: plus one xor-16
//         shuffle between the half-warps), then written to an f32 scratch
//         tbuf[slot, row tile, :];
//       - the direct part: each lane's 16 row partials of a batch are summed
//         over the lanes of a row by a butterfly reduce-scatter (15-16
//         shuffles a batch, after which every lane holds one row) and kept
//         in registers over every slot and chunk of the unit; y is written
//         once a unit.
//     x_r is one float4 a lane, handed to the rows by shuffles.  The warp
//     never waits on another warp and the CTA never synchronises.
//   * Pass 2, a second kernel: one warp a block column c that receives
//     partials adds them into y[c] in the fixed order of the column index
//     (slot_ids order, then row tiles in order), eight loads in flight a
//     lane, so a column with many partials is a few round trips and not one
//     per partial.  With the direct part of y it moves (b / 128) ku n 4
//     bytes of scratch twice: 1.5 % of the blocks' bytes at b = 128, ku = 1
//     in bf16.
//     Not folded into pass 1 (the last of the warps that write a column's
//     partials adds them): there the fold's dependent loads stall a
//     streaming warp, which measured slower in every regime (PERF.md).
//
// No floating-point atomics (the one atomic is the integer ticket); every sum
// (the reduce-scatter, the registers over slots and chunks, pass 2) is in an
// order fixed by the operator and not by the grid, so two runs are bit-equal.
// Each stored block is read from device memory once and applied twice.  A
// slot is real when its column lies strictly above the diagonal (c > r); ELL
// padding slots (column 0, zero block) are never read, have no partial and
// are never added into block column 0 (the column index leaves them out).
// Any reach works, known or not: nothing depends on how far c is from r.
//
// Memory the caller allocates once per operator and keeps between launches:
// tbuf, f32 (nbr, ku, b / 128, b); ticket, one int, zero before the first
// launch and zero again after every launch that ran to its end.
//
// Shapes taken: any nbr, any ku >= 1, square blocks with b a multiple of 128.

#include "spmv_common.cuh"

namespace eigenex {
namespace symv {

constexpr int kRows = 128;      // rows of a unit
constexpr int kLoads = 16;      // 16-byte loads in flight a lane (a batch)
constexpr int kCtaWarps = 4;    // warps a CTA
constexpr int kCtaThreads = 32 * kCtaWarps;
constexpr int kCtasPerSm = 2;   // what __launch_bounds__ asks for: 8 warps an SM, <= 255 registers
constexpr unsigned kFull = 0xffffffffu;

// Per storage type: entries a lane loads (16 bytes) and lanes a row.
template <typename T>
struct Lanes;
template <>
struct Lanes<float> {
  static constexpr int kPer = 4;
  static constexpr int kRowLanes = 32;
};
template <>
struct Lanes<__nv_bfloat16> {
  static constexpr int kPer = 8;
  static constexpr int kRowLanes = 16;
};

// 16 bytes of stored entries, widened to f32 (bf16 -> f32 is a 16-bit shift,
// exact; little endian: the first entry is the low half)
template <typename T>
__device__ __forceinline__ void widen(const uint4 raw, float (&v)[Lanes<T>::kPer]) {
  if constexpr (sizeof(T) == 4) {
    v[0] = __uint_as_float(raw.x);
    v[1] = __uint_as_float(raw.y);
    v[2] = __uint_as_float(raw.z);
    v[3] = __uint_as_float(raw.w);
  } else {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ float component(const float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Butterfly reduce-scatter over the W lanes of a row (W = 16 or 32, offsets
// below W only): v[0..N) are this lane's partials of N rows.  Each step at
// offset O halves the rows a lane holds (the bit O of the lane picks the
// upper half); once one is left it is summed plainly.  Afterwards v[0] holds
// the whole sum of row rs_row<W>(lane); with W = 32 lanes l and l ^ 1 hold
// the same row, bit-equal (a + b == b + a).  (With N = kLoads rows and W
// lanes, W / N lanes hold each row.)
template <int O, int N>
__device__ __forceinline__ void reduce_scatter(float (&v)[kLoads], int lane) {
  if constexpr (O >= 1) {
    if constexpr (N > 1) {
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = up ? v[i] : v[i + N / 2];
        const float keep = up ? v[i + N / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(kFull, send, O);
      }
      reduce_scatter<O / 2, N / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], O);
      reduce_scatter<O / 2, 1>(v, lane);
    }
  }
}

template <int W>
__device__ __forceinline__ int rs_row(int lane) {
  return (lane / (W / kLoads)) % kLoads;
}

template <typename T>
__global__ void __launch_bounds__(kCtaThreads, kCtasPerSm)
sym_bsr_spmv_kernel(const T* __restrict__ diag, const T* __restrict__ upper,
                    const int* __restrict__ cols, int* ticket, const float* __restrict__ x,
                    float* __restrict__ y, float* __restrict__ tbuf, int nbr, int ku, int b) {
  using L = Lanes<T>;
  constexpr int kPer = L::kPer;
  constexpr int W = L::kRowLanes;
  constexpr int kGroupRows = kRows * W / 32;  // rows of a unit one row group takes
  constexpr int kBatches = kGroupRows / kLoads;
  static_assert(kGroupRows % kLoads == 0 && kLoads % 4 == 0, "batches of whole float4s of x_r");
  static_assert(kLoads <= W, "the reduce-scatter leaves one row a lane");
  static_assert(kRows == 4 * 32, "x_r: one float4 a lane");

  const int lane = threadIdx.x & 31;
  const int grp = lane / W;  // row group: always 0 in f32, the half-warp in bf16
  const int gl = lane % W;   // the lane's kPer columns of a 128-column chunk
  const int nrt = b / kRows;
  const int units = nbr * nrt;
  const int G = gridDim.x * kCtaWarps;
  const size_t bb = (size_t)b * b;

  // warp g takes unit g, then the next unit of the ticket after each one
  for (int u = blockIdx.x * kCtaWarps + (threadIdx.x >> 5); u < units;) {
    const int r = u / nrt;
    const int rt = u - r * nrt;
    const int row0 = rt * kRows;  // the unit's first row within block row r
    // x at the unit's rows: lane l holds rows 4l .. 4l + 3
    const float4 xr4 = __ldg(reinterpret_cast<const float4*>(x + (size_t)r * b + row0) + lane);
    // the block row's column ids: lane s holds slot s
    const int cl = lane < ku ? __ldg(cols + (size_t)r * ku + lane) : 0;
    float yacc[kBatches];
#pragma unroll
    for (int bt = 0; bt < kBatches; ++bt) yacc[bt] = 0.f;

    // slot -1 is the diagonal block; slots 0..ku-1 the upper blocks
    for (int s = -1; s < ku; ++s) {
      int c = r;
      const T* blk = diag + (size_t)r * bb;
      if (s >= 0) {
        c = s < 32 ? __shfl_sync(kFull, cl, s) : __ldg(cols + (size_t)r * ku + s);
        if (c <= r) continue;  // padding slot: the same decision in every lane
        blk = upper + ((size_t)r * ku + s) * bb;
      }
      blk += (size_t)row0 * b;
      const float* xc = x + (size_t)c * b;
      for (int q = 0; q < b; q += 128) {
        float xv[kPer];  // x_c at the lane's columns
#pragma unroll
        for (int i = 0; i < kPer; i += 4) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(xc + q + gl * kPer + i));
          xv[i] = v.x;
          xv[i + 1] = v.y;
          xv[i + 2] = v.z;
          xv[i + 3] = v.w;
        }
        float tacc[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) tacc[i] = 0.f;
        const T* base = blk + (size_t)(grp * kGroupRows) * b + q + gl * kPer;

#pragma unroll
        for (int bt = 0; bt < kBatches; ++bt) {
          uint4 raw[kLoads];
#pragma unroll
          for (int j = 0; j < kLoads; ++j)
            raw[j] = __ldcs(reinterpret_cast<const uint4*>(base + (size_t)(bt * kLoads + j) * b));
          float part[kLoads];
#pragma unroll
          for (int j = 0; j < kLoads; ++j) {
            float v[kPer];
            widen<T>(raw[j], v);
            const int row = grp * kGroupRows + bt * kLoads + j;  // row % 4 == j % 4
            const float xr = __shfl_sync(kFull, component(xr4, j & 3), row >> 2);
            float acc = 0.f;
#pragma unroll
            for (int i = 0; i < kPer; ++i) {
              acc = fmaf(v[i], xv[i], acc);
              tacc[i] = fmaf(v[i], xr, tacc[i]);
            }
            part[j] = acc;
          }
          reduce_scatter<W / 2, kLoads>(part, lane);
          yacc[bt] += part[0];
        }

        if (s >= 0) {
          if constexpr (W == 16) {  // the two half-warps' rows: one sum, bit-equal in both
#pragma unroll
            for (int i = 0; i < kPer; ++i) tacc[i] += __shfl_xor_sync(kFull, tacc[i], 16);
          }
          float* t = tbuf + ((((size_t)r * ku + s) * nrt + rt) * b) + q + gl * kPer;
          if constexpr (W == 16) {  // half-warp h writes entries 4h .. 4h + 3 of the lane's 8
            *reinterpret_cast<float4*>(t + 4 * grp) =
                grp ? make_float4(tacc[4], tacc[5], tacc[6], tacc[7])
                    : make_float4(tacc[0], tacc[1], tacc[2], tacc[3]);
          } else {
            *reinterpret_cast<float4*>(t) = make_float4(tacc[0], tacc[1], tacc[2], tacc[3]);
          }
        }
      }
    }

    // the unit's rows of y: the direct part (pass 2 adds the partials)
    float* yr = y + (size_t)r * b + row0 + grp * kGroupRows + rs_row<W>(lane);
#pragma unroll
    for (int bt = 0; bt < kBatches; ++bt)
      if (lane % (W / kLoads) == 0) yr[bt * kLoads] = yacc[bt];

    // Every unit a warp finishes is followed by one ticket; the units take
    // tickets 0 .. units - 1 between them, tickets 0 .. units - G - 1 name
    // units G .. units - 1 and the rest end a warp.  The last ticket resets
    // the counter for the next launch.
    int tk = 0;
    if (lane == 0) {
      tk = atomicAdd(ticket, 1);
      if (tk == units - 1) *ticket = 0;
    }
    u = G + __shfl_sync(kFull, tk, 0);
  }
}

constexpr int kFoldLoads = 8;  // partials in flight a lane in pass 2

// Pass 2: warp c adds the partials of block column c into y[c] in the order
// of the column index, kFoldLoads of them requested at a time.
__global__ void __launch_bounds__(kCtaThreads)
sym_bsr_spmv_fold_kernel(const int* __restrict__ col_ptr, const int* __restrict__ slot_ids,
                         const float* __restrict__ tbuf, float* __restrict__ y, int nbr, int b) {
  const int c = blockIdx.x * kCtaWarps + (threadIdx.x >> 5);
  if (c >= nbr) return;
  const int lane = threadIdx.x & 31;
  const int beg = __ldg(col_ptr + c), end = __ldg(col_ptr + c + 1);
  const int nrt = b / kRows;
  const int n = (end - beg) * nrt;  // partial k: slot beg + k / nrt, row tile k % nrt
  if (n == 0) return;
  float* yc = y + (size_t)c * b;
  for (int j = 4 * lane; j < b; j += 128) {
    float4 acc = *reinterpret_cast<const float4*>(yc + j);
    for (int k0 = 0; k0 < n; k0 += kFoldLoads) {
      float4 p[kFoldLoads];
#pragma unroll
      for (int i = 0; i < kFoldLoads; ++i) {
        const int k = k0 + i;
        if (k < n) {
          const int e = k / nrt;
          const size_t slot = (size_t)__ldg(slot_ids + beg + e);
          p[i] = __ldg(reinterpret_cast<const float4*>(tbuf + (slot * nrt + (k - e * nrt)) * b + j));
        }
      }
#pragma unroll
      for (int i = 0; i < kFoldLoads; ++i) {
        if (k0 + i < n) {
          acc.x += p[i].x;
          acc.y += p[i].y;
          acc.z += p[i].z;
          acc.w += p[i].w;
        }
      }
    }
    *reinterpret_cast<float4*>(yc + j) = acc;
  }
}

// CTAs the kernel instantiation keeps resident on an SM and the SM count of
// the current device, asked once per device and instantiation
constexpr int kMaxDevices = 64;

template <typename T>
static cudaError_t resident_ctas(int* ctas) {
  static int of_device[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (of_device[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sym_bsr_spmv_kernel<T>,
                                                        kCtaThreads, 0);
    if (err != cudaSuccess) return err;
    of_device[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *ctas = of_device[dev];
  return cudaSuccess;
}

template <typename T>
static cudaError_t launch(const void* diag, const void* upper, const int* cols,
                          const int* col_ptr, const int* slot_ids, int* ticket, const float* x,
                          float* y, float* tbuf, int nbr, int ku, int b, cudaStream_t s) {
  int ctas = 0;
  cudaError_t err = resident_ctas<T>(&ctas);
  if (err != cudaSuccess) return err;
  const long long units = (long long)nbr * (b / kRows);
  const long long wanted = (units + kCtaWarps - 1) / kCtaWarps;
  const int grid = wanted < ctas ? (int)wanted : ctas;
  sym_bsr_spmv_kernel<T><<<grid, kCtaThreads, 0, s>>>(
      static_cast<const T*>(diag), static_cast<const T*>(upper), cols, ticket, x, y, tbuf, nbr,
      ku, b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sym_bsr_spmv_fold_kernel<<<(nbr + kCtaWarps - 1) / kCtaWarps, kCtaThreads, 0, s>>>(
      col_ptr, slot_ids, tbuf, y, nbr, b);
  return cudaGetLastError();
}

}  // namespace symv
}  // namespace eigenex

// storage: 0 = float32 blocks, 1 = bfloat16 blocks.  col_ptr, slot_ids: the
// column index of the real upper slots; ticket, tbuf: see the head of this
// file.  Launches pass 1 then pass 2 on `stream`; returns cudaGetLastError(),
// or cudaErrorInvalidValue for a block side that is not a multiple of 128.
extern "C" int eigenex_sym_bsr_spmv(const void* diag, const void* upper, const int* cols,
                                    const int* col_ptr, const int* slot_ids, int* ticket,
                                    const float* x, float* y, float* tbuf, int nbr, int ku, int b,
                                    int storage, void* stream) {
  using namespace eigenex::symv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nbr <= 0) return (int)cudaSuccess;
  if (b <= 0 || b % 128 || ku < 1) return (int)cudaErrorInvalidValue;
  if (storage == 0)
    return (int)launch<float>(diag, upper, cols, col_ptr, slot_ids, ticket, x, y, tbuf, nbr, ku,
                              b, s);
  if (storage == 1)
    return (int)launch<__nv_bfloat16>(diag, upper, cols, col_ptr, slot_ids, ticket, x, y, tbuf,
                                      nbr, ku, b, s);
  return (int)cudaErrorInvalidValue;
}
