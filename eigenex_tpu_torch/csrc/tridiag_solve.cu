// Tridiagonal solve with many right-hand sides, through cuSPARSE gtsv2.
//
// Counterpart of lax.linalg.tridiagonal_solve, which the JAX package's
// eigenex_tpu/solvers/direct.py calls for its shift-invert operator.  That
// is an XLA primitive, not a Pallas kernel: on a GPU, XLA lowers it to this
// same cuSPARSE routine (gtsv2, with partial pivoting).  So this file binds
// the library and writes no kernel of its own.
//
// Conventions, those of gtsv2 and of tridiagonal_solve alike: the three
// bands have length m, dl[0] = 0 and du[m-1] = 0; B is column-major, ldb = m,
// and is overwritten with the solution.  The caller asks for the workspace
// size once (eigenex_tridiag_buffer_size) and allocates it on the device.
// One cuSPARSE handle per device is made at first use and kept; each call
// binds it to the caller's stream.
//
// dtype: 0 = float32 (gtsv2 S), 1 = float64 (gtsv2 D).  Every entry returns
// 0, a cusparseStatus_t (1..), or 1000 + a cudaError_t.

#include <cuda_runtime.h>
#include <cusparse.h>

namespace {

constexpr int kMaxDevices = 64;
cusparseHandle_t g_handles[kMaxDevices] = {};

int handle_for(cudaStream_t stream, cusparseHandle_t* out) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return 1000 + (int)e;
  if (device < 0 || device >= kMaxDevices) return 1000 + (int)cudaErrorInvalidDevice;
  if (g_handles[device] == nullptr) {
    cusparseStatus_t s = cusparseCreate(&g_handles[device]);
    if (s != CUSPARSE_STATUS_SUCCESS) {
      g_handles[device] = nullptr;
      return (int)s;
    }
  }
  cusparseStatus_t s = cusparseSetStream(g_handles[device], stream);
  if (s != CUSPARSE_STATUS_SUCCESS) return (int)s;
  *out = g_handles[device];
  return 0;
}

int after(cusparseStatus_t s) {
  if (s != CUSPARSE_STATUS_SUCCESS) return (int)s;
  cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : 1000 + (int)e;
}

}  // namespace

extern "C" int eigenex_tridiag_buffer_size(int dtype, int m, int ncols, const void* dl,
                                           const void* d, const void* du, const void* B,
                                           void* stream, size_t* bytes) {
  cusparseHandle_t h;
  int code = handle_for(static_cast<cudaStream_t>(stream), &h);
  if (code) return code;
  if (dtype == 0) {
    return after(cusparseSgtsv2_bufferSizeExt(
        h, m, ncols, static_cast<const float*>(dl), static_cast<const float*>(d),
        static_cast<const float*>(du), static_cast<const float*>(B), m, bytes));
  }
  if (dtype == 1) {
    return after(cusparseDgtsv2_bufferSizeExt(
        h, m, ncols, static_cast<const double*>(dl), static_cast<const double*>(d),
        static_cast<const double*>(du), static_cast<const double*>(B), m, bytes));
  }
  return 1000 + (int)cudaErrorInvalidValue;
}

extern "C" int eigenex_tridiag_solve(int dtype, int m, int ncols, const void* dl, const void* d,
                                     const void* du, void* B, void* buffer, void* stream) {
  cusparseHandle_t h;
  int code = handle_for(static_cast<cudaStream_t>(stream), &h);
  if (code) return code;
  if (dtype == 0) {
    return after(cusparseSgtsv2(h, m, ncols, static_cast<const float*>(dl),
                                static_cast<const float*>(d), static_cast<const float*>(du),
                                static_cast<float*>(B), m, buffer));
  }
  if (dtype == 1) {
    return after(cusparseDgtsv2(h, m, ncols, static_cast<const double*>(dl),
                                static_cast<const double*>(d), static_cast<const double*>(du),
                                static_cast<double*>(B), m, buffer));
  }
  return 1000 + (int)cudaErrorInvalidValue;
}
