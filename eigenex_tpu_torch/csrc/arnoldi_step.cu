// The tail of one Arnoldi step, after the CGS2 projection and the norm:
// the step's flags, the Hessenberg column and the next basis row, in one
// launch.
//
// Replaces no Pallas kernel: on the TPU the tail is part of the jitted
// chunk (eigenex_tpu/solvers/arnoldi.py, _arnoldi_chunk_body), which XLA
// fuses.  In eager PyTorch the same tail is about 40 launches of scalar and
// elementwise ops a step (the flags, the guards, the selections that keep
// NaNs out, the masked writes), which in a replayed chunk graph cost more
// than the step's SpMV.  Here they are one launch.
//
// Bound on this card: launch latency.  The work is one read of w (n values),
// one write of the basis row and kh + 2 reads of the coefficients.  Every
// block reads the step's old flags, the residue and the coefficients and
// takes the same decision; block 0 alone writes the Hessenberg column and
// the new flags, into tensors that no block reads (the caller's fresh
// outputs), so no block waits for another.
//
// The arithmetic is the plain version's (ops/arnoldi_step.py,
// step_tail_plain): the row is w / residue with an IEEE division, the
// column the coefficients as they are, so the two agree bit for bit.
// Real f32 and f64 only; the wrapper takes the plain version otherwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace eigenex {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
arnoldi_step_kernel(const T* __restrict__ w, const T* __restrict__ c,
                    const T* __restrict__ residue_now, T* __restrict__ v_next,
                    T* __restrict__ h, int ldh, const int64_t* __restrict__ k,
                    const bool* __restrict__ breakdown, const T* __restrict__ residue_prev,
                    const bool* __restrict__ failed, int64_t* __restrict__ k_out,
                    bool* __restrict__ breakdown_out, T* __restrict__ residue_out,
                    bool* __restrict__ failed_out, int n, int kh, int m, T thr) {
  bool finite = true;
  for (int i = threadIdx.x; i <= kh; i += blockDim.x) finite = finite && isfinite(c[i]);
  finite = __syncthreads_and(finite);
  const T res = *residue_now;
  const bool active = !(*breakdown || *failed);
  const bool failed_now = !(isfinite(res) && finite);
  const bool broke = !failed_now && res <= thr;
  const bool ok = !(broke || failed_now);
  const T safe = ok ? res : T(1);

  if (active) {
    const int stride = gridDim.x * blockDim.x;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
      v_next[i] = ok ? w[i] / safe : T(0);
  }
  if (blockIdx.x != 0) return;
  if (active) {
    for (int i = threadIdx.x; i <= m; i += blockDim.x) {
      T v = i <= kh ? c[i] : (i == kh + 1 && ok ? res : T(0));
      h[(size_t)i * ldh] = failed_now ? T(0) : v;
    }
  }
  if (threadIdx.x == 0) {
    const bool advance = active && !failed_now;
    *k_out = *k + (advance ? 1 : 0);
    *breakdown_out = *breakdown || (active && broke);
    *residue_out = advance ? res : *residue_prev;
    *failed_out = *failed || (active && failed_now);
  }
}

template <typename T>
cudaError_t launch(const void* w, const void* c, const void* residue_now, void* v_next,
                   void* h, int ldh, const int64_t* k, const bool* breakdown,
                   const void* residue_prev, const bool* failed, int64_t* k_out,
                   bool* breakdown_out, void* residue_out, bool* failed_out, int n, int kh,
                   int m, double thr, cudaStream_t stream) {
  const int needed = n > 0 ? (n + kThreads - 1) / kThreads : 1;
  const int blocks = needed < 1024 ? needed : 1024;
  arnoldi_step_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(w), static_cast<const T*>(c), static_cast<const T*>(residue_now),
      static_cast<T*>(v_next), static_cast<T*>(h), ldh, k, breakdown,
      static_cast<const T*>(residue_prev), failed, k_out, breakdown_out,
      static_cast<T*>(residue_out), failed_out, n, kh, m, static_cast<T>(thr));
  return cudaGetLastError();
}

}  // namespace eigenex

// dtype: 0 f32, 1 f64.  h points at the step's column, H[0, kh]; ldh is H's
// row stride in elements.
extern "C" int eigenex_arnoldi_step(const void* w, const void* c, const void* residue_now,
                                    void* v_next, void* h, int ldh, const void* k,
                                    const void* breakdown, const void* residue_prev,
                                    const void* failed, void* k_out, void* breakdown_out,
                                    void* residue_out, void* failed_out, int n, int kh, int m,
                                    double thr, int dtype, void* stream) {
  using namespace eigenex;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* k_in = static_cast<const int64_t*>(k);
  const auto* b_in = static_cast<const bool*>(breakdown);
  const auto* f_in = static_cast<const bool*>(failed);
  auto* k_o = static_cast<int64_t*>(k_out);
  auto* b_o = static_cast<bool*>(breakdown_out);
  auto* f_o = static_cast<bool*>(failed_out);
  if (dtype == 0)
    return (int)launch<float>(w, c, residue_now, v_next, h, ldh, k_in, b_in, residue_prev, f_in,
                              k_o, b_o, residue_out, f_o, n, kh, m, thr, s);
  if (dtype == 1)
    return (int)launch<double>(w, c, residue_now, v_next, h, ldh, k_in, b_in, residue_prev, f_in,
                               k_o, b_o, residue_out, f_o, n, kh, m, thr, s);
  return (int)cudaErrorInvalidValue;
}
