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
//   pass 1, persistent CTAs, each on a contiguous range of block rows: for
//     D_r and every real U[r,k] each 128x128 tile is staged in shared memory
//     ONCE (read once from device memory, for all p columns) and applied
//     twice from there on the tensor cores -- the direct part
//     Y[r] = D_r X[r] + sum_k U[r,k] X[c_k], kept in registers over all slots
//     of the block row and written to Y once, and the transposed partial
//     T[r,k] = U[r,k]^T X[r], kept in registers over the tile and written to
//     an f32 scratch of shape (nbr, ku, b, p) that the caller allocates;
//   pass 2, one CTA per block column c: Y[c] += sum of T[r,k] over the slots
//     whose column is c, walked in the fixed (r, k) order of the container's
//     column-sorted index of the real slots; (b, p) tiles are contiguous in
//     the scratch, so the walk is coalesced.
//
// No floating-point atomics and every sum in a fixed order that does not
// depend on the grid: two runs on one input are bit-equal, for any reach,
// known or not.  A slot is real when its column lies strictly above the
// diagonal (c > r); ELL padding slots (column 0, zero block) are skipped in
// pass 1 -- not even read -- and are absent from the index.
//
// Bound on this card: bytes (see spmm_common.cuh, which also holds the ring,
// the fragment layouts, the precision rule and the shared-memory budget).
// The scratch is not small here: written once and read back once, it is
// about 4 p bytes per row of every real upper block, a tenth to a sixth of
// all bytes moved at p = 16.  It is neither input nor output of the function,
// so it is reported beside the bound, not inside it.
//
// Tile order inside a block row r: for each row tile ti of 128 rows, the
// diagonal block then the real slots in slot order, each over its column
// tiles tj.  Y[r, ti] stays in registers over that whole group.  With
// b = 128 a slot's partial is complete after its one tile; with wider blocks
// the row tiles ti > 0 add to what ti = 0 stored (the same thread, in order).
// Registers, shared memory and CTAs an SM: see spmm_common.cuh; pass 1 holds
// two panels (X[c, tj] and X[r, ti]), pass 2 takes 32 registers.
//
// Shapes taken: any nbr, any ku >= 1, square blocks with b a multiple of 128,
// any p >= 1 (wider than 32 columns: in column chunks, two launches each).

#include "spmm_common.cuh"

namespace eigenex {

// One step of the walk over a CTA's block rows: block row r, row tile ti,
// slot s (-1 = the diagonal block), column tile tj, block column c.  The walk
// is arithmetic -- it does not depend on the column ids -- so the column id of
// a step can be requested two steps before it is needed.  A step whose slot is
// padding (c <= r) copies nothing and multiplies nothing.
struct SymStep {
  int r, ti, s, tj, c;
};

__device__ __forceinline__ void sym_advance(SymStep& t, int ku, int nts) {
  if (++t.tj < nts) return;
  t.tj = 0;
  if (++t.s < ku) return;
  t.s = -1;
  if (++t.ti < nts) return;
  t.ti = 0;
  ++t.r;
}

// request the step's column id (the block row itself for the diagonal block)
__device__ __forceinline__ void sym_request_column(SymStep& t, const int* __restrict__ cols,
                                                   int ku, int r_end) {
  t.c = t.r;
  if (t.r < r_end && t.s >= 0) t.c = load_early(cols + (size_t)t.r * ku + t.s);
}

__device__ __forceinline__ bool sym_real(const SymStep& t, int r_end) {
  return t.r < r_end && (t.s < 0 || t.c > t.r);
}

template <typename T>
__device__ __forceinline__ const T* sym_tile_source(const SymStep& t, const T* __restrict__ diag,
                                                    const T* __restrict__ upper, int ku, int b) {
  const size_t block_elems = (size_t)b * b;
  const T* blk = t.s < 0 ? diag + (size_t)t.r * block_elems
                         : upper + ((size_t)t.r * ku + t.s) * block_elems;
  return blk + (size_t)t.ti * kTile * b + (size_t)t.tj * kTile;
}

// the panel a step's direct product multiplies: X[r, ti] itself on the
// diagonal tile of the diagonal block, else X[c, tj]
__device__ __forceinline__ bool sym_own_panel(const SymStep& t) {
  return t.s < 0 && t.tj == t.ti;
}

__device__ __forceinline__ const float* sym_panel_source(const SymStep& t,
                                                         const float* __restrict__ X, int b,
                                                         size_t ldx) {
  return sym_own_panel(t) ? X + ((size_t)t.r * b + (size_t)t.ti * kTile) * ldx
                          : X + ((size_t)t.c * b + (size_t)t.tj * kTile) * ldx;
}

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, ctas_per_sm<T, NT>())
sym_bsr_spmm_pass1_kernel(const T* __restrict__ diag, const T* __restrict__ upper,
                          const int* __restrict__ cols, const float* __restrict__ X,
                          float* __restrict__ Y, float* __restrict__ tbuf, int nbr, int ku, int b,
                          int pc, size_t ldx, size_t ldy) {
  using R = Route<T>;
  constexpr int NS = kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* Xd = smem + (size_t)NS * R::kTileBytes;  // panel of the direct product
  unsigned char* Xr = Xd + NT * R::kPanelBytesPerNT;      // panel of X[r, ti]
  const uint32_t ring = shared_addr(smem);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nts = b / kTile;
  const bool y_pairs = pair_stores(Y, ldy, pc), t_pairs = pair_stores(tbuf, (size_t)pc, pc);
  const int r_end = range_begin(blockIdx.x + 1, gridDim.x, nbr);
  // q[0] is multiplied; q[1] has its panel requested; q[1..NS-1] are being
  // copied; q[NS] has its column id requested
  SymStep q[NS + 1];
  q[0] = SymStep{range_begin(blockIdx.x, gridDim.x, nbr), 0, -1, 0, 0};
  q[0].c = q[0].r;
  if (q[0].r >= r_end) return;
#pragma unroll
  for (int i = 1; i <= NS; ++i) {
    q[i] = q[i - 1];
    sym_advance(q[i], ku, nts);
    sym_request_column(q[i], cols, ku, r_end);
  }
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (sym_real(q[i], r_end))
      stage_tile<T>(ring + i * R::kTileBytes, sym_tile_source(q[i], diag, upper, ku, b), kTile, b);
    cp_async_commit();
  }
  PanelRegs<T, NT> regs;  // the panel of q[0], requested one step ahead
  panel_load<T, NT>(regs, sym_panel_source(q[0], X, b, ldx), ldx, pc);

  float yacc[NT][4];
  bool first = true;  // q[0] opens a group (r, ti)
  int slot = 0;       // ring slot of q[0]
  while (q[0].r < r_end) {
    const SymStep cur = q[0];
    const bool real = sym_real(cur, r_end), next_real = sym_real(q[1], r_end);
    // the slot freed by the previous step takes the tile NS - 1 steps ahead
    if (sym_real(q[NS - 1], r_end))
      stage_tile<T>(ring + (slot == 0 ? NS - 1 : slot - 1) * R::kTileBytes,
                    sym_tile_source(q[NS - 1], diag, upper, ku, b), kTile, b);
    cp_async_commit();
    SymStep after = q[NS];
    sym_advance(after, ku, nts);
    sym_request_column(after, cols, ku, r_end);
    const bool last = q[1].r != cur.r || q[1].ti != cur.ti;

    // this step's panel out of the registers, the next one's into them
    const bool own = sym_own_panel(cur);
    if (first) {
      zero_acc<NT>(yacc);
      if (!own)  // blocks wider than a tile: the group opens off the diagonal tile
        fill_panel<T, NT>(Xr, X + ((size_t)cur.r * b + (size_t)cur.ti * kTile) * ldx, ldx, pc);
    }
    if (real) panel_store<T, NT>(own ? Xr : Xd, regs);
    if (next_real) panel_load<T, NT>(regs, sym_panel_source(q[1], X, b, ldx), ldx, pc);
    cp_async_wait<NS - 1>();
    __syncthreads();  // the tile and the panels are visible to every warp

    if (real) {
      const unsigned char* tile = smem + (size_t)slot * R::kTileBytes;
      direct_tile<T, NT>(yacc, tile, own ? Xr : Xd, warp, lane);
      if (cur.s >= 0) {
        float tacc[NT][4];
        zero_acc<NT>(tacc);
        transposed_tile<T, NT>(tacc, tile, Xr, warp, lane);
        store_acc<NT>(tbuf + (((size_t)cur.r * ku + cur.s) * b + (size_t)cur.tj * kTile) * pc,
                      (size_t)pc, tacc, warp, lane, kTile, pc, cur.ti > 0, t_pairs);
      }
    }
    if (last)
      store_acc<NT>(Y + ((size_t)cur.r * b + (size_t)cur.ti * kTile) * ldy, ldy, yacc, warp, lane,
                    kTile, pc, false, y_pairs);
    __syncthreads();  // every warp has read the slot and the panels
#pragma unroll
    for (int i = 0; i < NS; ++i) q[i] = q[i + 1];
    q[NS] = after;
    slot = slot + 1 == NS ? 0 : slot + 1;
    first = last;
  }
  cp_async_wait<0>();
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

template <typename T, int NT>
static cudaError_t sym_bsr_spmm_launch_nt(const T* diag, const T* upper, const int* cols,
                                          const int* col_ptr, const int* slot_ids, const float* X,
                                          float* Y, float* tbuf, int nbr, int ku, int b, int pc,
                                          size_t ld, cudaStream_t s) {
  constexpr int ctas = ctas_per_sm<T, NT>();
  constexpr size_t bytes = shared_bytes<T, NT, 2>();
  static_assert(bytes <= (size_t)(ctas == 2 ? kTwoCtaSharedBytes : kMaxSharedBytes),
                "ring and panels exceed the shared memory of the CTAs an SM compiled for");
  auto kernel = sym_bsr_spmm_pass1_kernel<T, NT>;
  int sms = 0;
  cudaError_t err = configure_once<T, NT>(kernel, bytes, &sms);
  if (err != cudaSuccess) return err;
  const int grid = nbr < sms * ctas ? nbr : sms * ctas;
  kernel<<<grid, kThreads, bytes, s>>>(diag, upper, cols, X, Y, tbuf, nbr, ku, b, pc, ld, ld);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sym_bsr_spmm_pass2_kernel<<<nbr, kThreads, 0, s>>>(col_ptr, slot_ids, tbuf, Y, b, pc, ld);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t sym_bsr_spmm_launch(const void* diag, const void* upper, const int* cols,
                                       const int* col_ptr, const int* slot_ids, const float* X,
                                       float* Y, float* tbuf, int nbr, int ku, int b, int p,
                                       cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  const T* d = static_cast<const T*>(diag);
  const T* u = static_cast<const T*>(upper);
  for (int col0 = 0; col0 < p && err == cudaSuccess; col0 += kMaxCols) {
    const int pc = (p - col0 < kMaxCols) ? (p - col0) : kMaxCols;
    const float* Xc = X + col0;
    float* Yc = Y + col0;
    switch ((pc + 7) / 8) {
      case 1:
        err = sym_bsr_spmm_launch_nt<T, 1>(d, u, cols, col_ptr, slot_ids, Xc, Yc, tbuf, nbr, ku, b,
                                           pc, (size_t)p, s);
        break;
      case 2:
        err = sym_bsr_spmm_launch_nt<T, 2>(d, u, cols, col_ptr, slot_ids, Xc, Yc, tbuf, nbr, ku, b,
                                           pc, (size_t)p, s);
        break;
      case 3:
        err = sym_bsr_spmm_launch_nt<T, 3>(d, u, cols, col_ptr, slot_ids, Xc, Yc, tbuf, nbr, ku, b,
                                           pc, (size_t)p, s);
        break;
      default:
        err = sym_bsr_spmm_launch_nt<T, 4>(d, u, cols, col_ptr, slot_ids, Xc, Yc, tbuf, nbr, ku, b,
                                           pc, (size_t)p, s);
    }
  }
  return err;
}

}  // namespace eigenex

// X, Y: (nbr * b, p) f32 row-major.  tbuf: f32 scratch of at least
// nbr * ku * b * min(p, 32) entries.  storage: 0 = float32 blocks,
// 1 = bfloat16 blocks.  Launches pass 1 then pass 2 on `stream`, once per
// chunk of at most 32 columns; returns the first CUDA error, or
// cudaErrorInvalidValue for a block side that is not a multiple of 128.
extern "C" int eigenex_sym_bsr_spmm(const void* diag, const void* upper, const int* cols,
                                    const int* col_ptr, const int* slot_ids, const float* X,
                                    float* Y, float* tbuf, int nbr, int ku, int b, int p,
                                    int storage, void* stream) {
  using namespace eigenex;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nbr <= 0 || p <= 0) return (int)cudaSuccess;
  if (b <= 0 || b % kTile || ku < 1) return (int)cudaErrorInvalidValue;
  if (storage == 0)
    return (int)sym_bsr_spmm_launch<float>(diag, upper, cols, col_ptr, slot_ids, X, Y, tbuf, nbr,
                                           ku, b, p, s);
  if (storage == 1)
    return (int)sym_bsr_spmm_launch<__nv_bfloat16>(diag, upper, cols, col_ptr, slot_ids, X, Y,
                                                   tbuf, nbr, ku, b, p, s);
  return (int)cudaErrorInvalidValue;
}
