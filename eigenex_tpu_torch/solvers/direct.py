"""Direct (factorization-free) shift-invert operators for tridiagonal
matrices.

Counterpart of ``eigenex_tpu/solvers/direct.py``.  Shift-invert Lanczos
needs (A - sigma I)^-1 x per matvec.  For a tridiagonal A that system
solves exactly in one pass, so sigma-targeted pairs of e.g. the 1D
Laplacian (BASELINE config 1, whose low end is clustered at relative gaps
~1e-7) converge in a handful of outer steps with no inner tolerance.

The JAX package solves with ``lax.linalg.tridiagonal_solve``, an XLA
primitive (no Pallas kernel).  PyTorch has no counterpart, so the port
calls the same routines XLA lowers it to:

- **on the card**, cuSPARSE ``gtsv2`` (``csrc/tridiag_solve.cu``, built
  by :func:`eigenex_tpu_torch.ops.cuda_spmv.build_kernels` with
  ``-lcusparse`` and loaded with ``ctypes``).  The workspace is sized once
  for each number of right-hand sides and kept on the operator; ``matmat``
  solves all p columns in one call on a (p, n) contiguous copy (gtsv2
  takes B column-major and overwrites it).  No step leaves the device.
  f32 and f64 bands; other dtypes raise.
- **on the CPU**, LAPACK ``{s,d,c,z}gtsv`` through scipy on the host
  arrays.

Both pivot (partial pivoting), as ``tridiagonal_solve`` does.  The bands
follow its convention: ``dl[0] = 0``, ``du[-1] = 0``; bands of length
n - 1 are accepted and padded.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.operators import LinearOperator
from ..utils.device import resolve_device
from ..utils.exceptions import EigenexError
from ..utils.tolerance import as_torch_dtype

__all__ = [
    "tridiagonal_operator",
    "tridiagonal_shift_invert_operator",
    "gtsv2_calls",
    "reset_gtsv2_calls",
]

#: gtsv2 dtype codes of ``csrc/tridiag_solve.cu``
_GTSV2_DTYPE = {torch.float32: 0, torch.float64: 1}
_calls = {"gtsv2": 0}
_lib: list = []


def gtsv2_calls() -> int:
    """cuSPARSE ``gtsv2`` calls since the last reset (one per matvec or
    matmat of a shift-invert operator on the card)."""
    return _calls["gtsv2"]


def reset_gtsv2_calls() -> None:
    _calls["gtsv2"] = 0


def _as_bands(dl, d, du, dtype, device):
    def band(b):
        b = b if isinstance(b, torch.Tensor) else torch.as_tensor(np.asarray(b))
        return b.to(device=device, dtype=dtype)

    d = band(d)
    n = d.shape[0]
    dl = torch.zeros((n,), dtype=dtype, device=device) if dl is None else band(dl)
    du = torch.zeros((n,), dtype=dtype, device=device) if du is None else band(du)
    zero = torch.zeros((1,), dtype=dtype, device=device)
    if tuple(dl.shape) == (n - 1,):  # accept length n-1 off-diagonals
        dl = torch.cat([zero, dl])
    if tuple(du.shape) == (n - 1,):
        du = torch.cat([du, zero])
    if tuple(dl.shape) != (n,) or tuple(du.shape) != (n,):
        raise EigenexError("tridiagonal bands must have length n or n-1")
    # tridiagonal_solve convention: dl[0] == 0, du[-1] == 0
    dl = dl.clone()
    du = du.clone()
    dl[0] = 0
    du[-1] = 0
    return dl.contiguous(), d.contiguous(), du.contiguous()


def _band_dtype(d, dtype) -> torch.dtype:
    if dtype is not None:
        return as_torch_dtype(dtype)
    if isinstance(d, torch.Tensor):
        return d.dtype
    return as_torch_dtype(np.asarray(d).dtype)


def _tridiag_matvec(p, x):
    dl, d, du = p
    y = d * x
    y[:-1] += du[:-1] * x[1:]
    y[1:] += dl[1:] * x[:-1]
    return y


def _tridiag_matmat(p, X):
    dl, d, du = p
    return _tridiag_matvec((dl[:, None], d[:, None], du[:, None]), X)


def tridiagonal_operator(dl, d, du, dtype=None, device=None) -> LinearOperator:
    """Matrix-free tridiagonal operator from its bands.

    dl: sub-diagonal (length n, dl[0] ignored, or length n-1); d: diagonal
    (n,); du: super-diagonal (length n, du[-1] ignored, or length n-1).
    ``device=None`` means the card."""
    dtype = _band_dtype(d, dtype)
    device = resolve_device(device)
    bands = _as_bands(dl, d, du, dtype, device)
    n = bands[1].shape[0]
    return LinearOperator(_tridiag_matvec, bands, (n, n), dtype, device,
                          matmat_fn=_tridiag_matmat)


# ---------------------------------------------------------------------------
# the solve
# ---------------------------------------------------------------------------
def _gtsv2():
    """(buffer_size, solve) C entries of ``csrc/tridiag_solve.cu``, built and
    loaded at first use."""
    if not _lib:
        from ..ops.cuda_spmv import build_kernels

        lib = ctypes.CDLL(str(build_kernels(["tridiag_solve"])["tridiag_solve"]))
        P, I = ctypes.c_void_p, ctypes.c_int
        size = lib.eigenex_tridiag_buffer_size
        size.argtypes = [I, I, I, P, P, P, P, P, ctypes.POINTER(ctypes.c_size_t)]
        size.restype = I
        solve = lib.eigenex_tridiag_solve
        solve.argtypes = [I, I, I, P, P, P, P, P, P]
        solve.restype = I
        _lib.extend([size, solve])
    return _lib


def _check(code: int, what: str) -> None:
    if code >= 1000:
        raise EigenexError(f"{what}: CUDA error {code - 1000}")
    if code:
        raise EigenexError(f"{what}: cuSPARSE status {code}")


class _ShiftedBands:
    """(dl, d - sigma, du) and, on the card, the gtsv2 workspace for each
    number of right-hand sides met so far."""

    def __init__(self, dl, ds, du):
        self.dl, self.ds, self.du = dl, ds, du
        self.workspace: dict[int, torch.Tensor] = {}

    def solve(self, B: torch.Tensor) -> torch.Tensor:
        """(A - sigma I)^-1 B for B of shape (n,) or (n, p)."""
        if B.device != self.ds.device:
            raise EigenexError(
                f"tridiagonal solve: B is on {B.device}, the bands on {self.ds.device}")
        if B.dtype != self.ds.dtype:
            raise EigenexError(f"tridiagonal solve: B is {B.dtype}, the bands {self.ds.dtype}")
        if B.is_cuda:
            return self._solve_card(B)
        return self._solve_host(B)

    def _solve_host(self, B):
        from scipy.linalg import lapack

        dl, ds, du = (t.numpy() for t in (self.dl, self.ds, self.du))
        b = B.numpy()
        (gtsv,) = lapack.get_lapack_funcs(("gtsv",), (ds, b))
        _, _, _, x, info = gtsv(dl[1:], ds, du[:-1], b)
        if info > 0:
            raise EigenexError(f"tridiagonal solve: exactly singular at row {info - 1}")
        if info < 0:
            raise EigenexError(f"tridiagonal solve: LAPACK gtsv argument {-info} is illegal")
        return torch.from_numpy(np.ascontiguousarray(x))

    def _solve_card(self, B):
        if self.ds.dtype not in _GTSV2_DTYPE:
            raise EigenexError(
                f"tridiagonal solve on the card: bands of {self.ds.dtype} (gtsv2 route: "
                "float32 or float64)")
        n = self.ds.shape[0]
        if n < 3:
            raise EigenexError("tridiagonal solve on the card: gtsv2 needs n >= 3")
        vector = B.ndim == 1
        # gtsv2 takes B column-major (ldb = n) and overwrites it: the (p, n)
        # row-major copy is exactly that layout
        Bt = (B[None, :] if vector else B.T).contiguous()
        if Bt.data_ptr() == B.data_ptr():
            Bt = Bt.clone()
        p = Bt.shape[0]
        size, solve = _gtsv2()
        code_dtype = _GTSV2_DTYPE[self.ds.dtype]
        stream = torch.cuda.current_stream(self.ds.device).cuda_stream
        args = (code_dtype, n, p, self.dl.data_ptr(), self.ds.data_ptr(), self.du.data_ptr())
        work = self.workspace.get(p)
        with torch.cuda.device(self.ds.device):
            if work is None:
                nbytes = ctypes.c_size_t(0)
                _check(size(*args, Bt.data_ptr(), stream, ctypes.byref(nbytes)),
                       "gtsv2_bufferSizeExt")
                work = torch.empty(max(int(nbytes.value), 1), dtype=torch.uint8,
                                   device=self.ds.device)
                self.workspace[p] = work
            _check(solve(*args, Bt.data_ptr(), work.data_ptr(), stream), "gtsv2")
        _calls["gtsv2"] += 1
        return Bt[0] if vector else Bt.T


def _tridiag_si_matvec(p, x):
    return p.solve(x)


def _tridiag_si_matmat(p, X):
    return p.solve(X)


def tridiagonal_shift_invert_operator(dl, d, du, sigma, dtype=None,
                                      device=None) -> LinearOperator:
    """(A - sigma I)^-1 for a tridiagonal A, solved exactly per matvec --
    no inner iteration, no inner tolerance.  Eigenvalues theta of the
    returned operator map back as lambda = sigma + 1/theta; the pairs
    nearest sigma are the most dominant.  On the card each matvec and each
    matmat is one cuSPARSE ``gtsv2`` call; on the CPU, one LAPACK
    ``gtsv``.  ``device=None`` means the card."""
    dtype = _band_dtype(d, dtype)
    device = resolve_device(device)
    dl, d, du = _as_bands(dl, d, du, dtype, device)
    ds = d - torch.as_tensor(sigma, dtype=dtype, device=device)
    n = d.shape[0]
    return LinearOperator(_tridiag_si_matvec, _ShiftedBands(dl, ds, du), (n, n), dtype,
                          device, matmat_fn=_tridiag_si_matmat)
