// General BSR-ELL SpMM:  Y[r] = sum_k data[r, k] @ X[cols[r, k]]  for a dense
// (n, p) f32 right-hand side, X and Y row-major.
//
// Replaces: _spmm_kernel / bsr_matmat_pallas in eigenex_tpu/ops/pallas_spmv.py
// (block rows per TPU grid program, X resident on chip as (nbc, p, bn) slabs
// with p padded to 8).  Neither the slab layout nor the pad is kept: X and Y
// are the (n, p) arrays the solvers hold, and any p >= 1 is taken.
//
// Bound on this card: bytes (see spmm_common.cuh, which holds the ring of
// staged tiles, the fragment layouts, the precision rule and the
// shared-memory budget).  Persistent CTAs, each on a contiguous range of
// block rows; nothing carries between block rows and nothing is scattered.
// Tile order inside a block row: for each row tile ti of 128 rows (the last
// one ragged: bm = 8 and bm = 320 are taken; only its real rows are copied
// and stored, and warps that own no real row skip the products), every slot
// over its column tiles tj.  Y[r, ti] stays in registers over that whole
// group and is written once.  A block is read from device memory once, for
// all p columns.  ELL padding slots (column 0, zero block) cannot be told
// from a real block at column 0 without reading them, so they are read and
// add zeros, as in the TPU kernel.
// Shared memory: ring of 2 tiles + one X panel; bf16 2 CTAs an SM up to 16
// columns, f32 1.
//
// Shapes taken: any nbr, any kmax >= 1, any bm, bn a multiple of 128, any
// p >= 1 (wider than 32 columns: in column chunks, each a launch).

#include "spmm_common.cuh"

namespace eigenex {

// One step of the walk over a CTA's block rows: block row r, row tile ti,
// slot s, column tile tj, block column c.  The walk is arithmetic, so the
// column id of a step is requested two steps before its panel is.
struct BsrStep {
  int r, ti, s, tj, c;
};

__device__ __forceinline__ void bsr_advance(BsrStep& t, int kmax, int mts, int nts) {
  if (++t.tj < nts) return;
  t.tj = 0;
  if (++t.s < kmax) return;
  t.s = 0;
  if (++t.ti < mts) return;
  t.ti = 0;
  ++t.r;
}

__device__ __forceinline__ void bsr_request_column(BsrStep& t, const int* __restrict__ cols,
                                                   int kmax, int r_end) {
  t.c = 0;
  if (t.r < r_end) t.c = load_early(cols + (size_t)t.r * kmax + t.s);
}

template <typename T>
__device__ __forceinline__ void bsr_stage(uint32_t dst, const BsrStep& t,
                                          const T* __restrict__ data, int kmax, int bm, int bn) {
  const T* src = data + ((size_t)t.r * kmax + t.s) * bm * bn + (size_t)t.ti * kTile * bn +
                 (size_t)t.tj * kTile;
  const int rows = bm - t.ti * kTile;
  stage_tile<T>(dst, src, rows < kTile ? rows : kTile, bn);
}

__device__ __forceinline__ const float* bsr_panel_source(const BsrStep& t,
                                                         const float* __restrict__ X, int bn,
                                                         size_t ldx) {
  return X + ((size_t)t.c * bn + (size_t)t.tj * kTile) * ldx;
}

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, ctas_per_sm<T, NT>())
bsr_spmm_kernel(const T* __restrict__ data, const int* __restrict__ cols,
                const float* __restrict__ X, float* __restrict__ Y, int nbr, int kmax, int bm,
                int bn, int pc, size_t ldx, size_t ldy) {
  using R = Route<T>;
  constexpr int NS = kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* Xd = smem + (size_t)NS * R::kTileBytes;  // panel of X the tile multiplies
  const uint32_t ring = shared_addr(smem);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mts = (bm + kTile - 1) / kTile, nts = bn / kTile;
  const bool y_pairs = pair_stores(Y, ldy, pc);
  const int r_end = range_begin(blockIdx.x + 1, gridDim.x, nbr);
  // q[0] is multiplied; q[1] has its panel requested; q[1..NS-1] are being
  // copied; q[NS] has its column id requested
  BsrStep q[NS + 1];
  q[0] = BsrStep{range_begin(blockIdx.x, gridDim.x, nbr), 0, 0, 0, 0};
  if (q[0].r >= r_end) return;
  bsr_request_column(q[0], cols, kmax, r_end);
#pragma unroll
  for (int i = 1; i <= NS; ++i) {
    q[i] = q[i - 1];
    bsr_advance(q[i], kmax, mts, nts);
    bsr_request_column(q[i], cols, kmax, r_end);
  }
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (q[i].r < r_end) bsr_stage<T>(ring + i * R::kTileBytes, q[i], data, kmax, bm, bn);
    cp_async_commit();
  }
  PanelRegs<T, NT> regs;  // the panel of q[0], requested one step ahead
  panel_load<T, NT>(regs, bsr_panel_source(q[0], X, bn, ldx), ldx, pc);

  float yacc[NT][4];
  bool first = true;  // q[0] opens a group (r, ti)
  int slot = 0;       // ring slot of q[0]
  while (q[0].r < r_end) {
    const BsrStep cur = q[0];
    // the slot freed by the previous step takes the tile NS - 1 steps ahead
    if (q[NS - 1].r < r_end)
      bsr_stage<T>(ring + (slot == 0 ? NS - 1 : slot - 1) * R::kTileBytes, q[NS - 1], data, kmax,
                   bm, bn);
    cp_async_commit();
    BsrStep after = q[NS];
    bsr_advance(after, kmax, mts, nts);
    bsr_request_column(after, cols, kmax, r_end);
    const bool last = q[1].r != cur.r || q[1].ti != cur.ti;

    // this step's panel out of the registers, the next one's into them
    if (first) zero_acc<NT>(yacc);
    panel_store<T, NT>(Xd, regs);
    if (q[1].r < r_end) panel_load<T, NT>(regs, bsr_panel_source(q[1], X, bn, ldx), ldx, pc);
    cp_async_wait<NS - 1>();
    __syncthreads();  // the tile and the panel are visible to every warp

    const int rows = bm - cur.ti * kTile;  // real rows of this row tile (may exceed kTile)
    if (16 * warp < rows)
      direct_tile<T, NT>(yacc, smem + (size_t)slot * R::kTileBytes, Xd, warp, lane);
    if (last)
      store_acc<NT>(Y + ((size_t)cur.r * bm + (size_t)cur.ti * kTile) * ldy, ldy, yacc, warp, lane,
                    rows, pc, false, y_pairs);
    __syncthreads();  // every warp has read the slot and the panel
#pragma unroll
    for (int i = 0; i < NS; ++i) q[i] = q[i + 1];
    q[NS] = after;
    slot = slot + 1 == NS ? 0 : slot + 1;
    first = last;
  }
  cp_async_wait<0>();
}

template <typename T, int NT>
static cudaError_t bsr_spmm_launch_nt(const T* data, const int* cols, const float* X, float* Y,
                                      int nbr, int kmax, int bm, int bn, int pc, size_t ld,
                                      cudaStream_t s) {
  constexpr int ctas = ctas_per_sm<T, NT>();
  constexpr size_t bytes = shared_bytes<T, NT, 1>();
  static_assert(bytes <= (size_t)(ctas == 2 ? kTwoCtaSharedBytes : kMaxSharedBytes),
                "ring and panels exceed the shared memory of the CTAs an SM compiled for");
  auto kernel = bsr_spmm_kernel<T, NT>;
  int sms = 0;
  cudaError_t err = configure_once<T, NT>(kernel, bytes, &sms);
  if (err != cudaSuccess) return err;
  const int grid = nbr < sms * ctas ? nbr : sms * ctas;
  kernel<<<grid, kThreads, bytes, s>>>(data, cols, X, Y, nbr, kmax, bm, bn, pc, ld, ld);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t bsr_spmm_launch(const void* data, const int* cols, const float* X, float* Y,
                                   int nbr, int kmax, int bm, int bn, int p, cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  const T* d = static_cast<const T*>(data);
  for (int col0 = 0; col0 < p && err == cudaSuccess; col0 += kMaxCols) {
    const int pc = (p - col0 < kMaxCols) ? (p - col0) : kMaxCols;
    const float* Xc = X + col0;
    float* Yc = Y + col0;
    switch ((pc + 7) / 8) {
      case 1:
        err = bsr_spmm_launch_nt<T, 1>(d, cols, Xc, Yc, nbr, kmax, bm, bn, pc, (size_t)p, s);
        break;
      case 2:
        err = bsr_spmm_launch_nt<T, 2>(d, cols, Xc, Yc, nbr, kmax, bm, bn, pc, (size_t)p, s);
        break;
      case 3:
        err = bsr_spmm_launch_nt<T, 3>(d, cols, Xc, Yc, nbr, kmax, bm, bn, pc, (size_t)p, s);
        break;
      default:
        err = bsr_spmm_launch_nt<T, 4>(d, cols, Xc, Yc, nbr, kmax, bm, bn, pc, (size_t)p, s);
    }
  }
  return err;
}

}  // namespace eigenex

// X: (nbc * bn, p) f32 row-major, Y: (nbr * bm, p) f32 row-major.  storage:
// 0 = float32 blocks, 1 = bfloat16 blocks.  Launches on `stream`, one launch
// per chunk of at most 32 columns; returns the first CUDA error, or
// cudaErrorInvalidValue for a block width that is not a multiple of 128.
extern "C" int eigenex_bsr_spmm(const void* data, const int* cols, const float* X, float* Y,
                                int nbr, int kmax, int bm, int bn, int p, int storage,
                                void* stream) {
  using namespace eigenex;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nbr <= 0 || p <= 0) return (int)cudaSuccess;
  if (bm < 1 || bn <= 0 || bn % kTile || kmax < 1) return (int)cudaErrorInvalidValue;
  if (storage == 0) return (int)bsr_spmm_launch<float>(data, cols, X, Y, nbr, kmax, bm, bn, p, s);
  if (storage == 1)
    return (int)bsr_spmm_launch<__nv_bfloat16>(data, cols, X, Y, nbr, kmax, bm, bn, p, s);
  return (int)cudaErrorInvalidValue;
}
