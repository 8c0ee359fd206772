"""Square operator in row-compressed (CSR) storage: symmetric/Hermitian,
or general.

No counterpart in ``eigenex_tpu``: the JAX package packs every symmetric
operator into 128x128 half-storage blocks (:mod:`.sym_bsr`) and every
general one into 32x128 BSR-ELL blocks (:mod:`.bsr`), which a TPU's matrix
unit needs.  On the card, an operator whose nonzeros fill few of those
blocks moves far fewer bytes a product stored by rows: every stored entry
(both triangles of a symmetric operator), int32 row pointers and column
ids, values in the storage dtype.
:func:`~eigenex_tpu_torch.sparse.accelerate.accelerate` picks this storage
on CUDA when its bytes are fewer than the block pack's slots, and
:meth:`~eigenex_tpu_torch.sparse.accelerate.AcceleratedOperator.block_matrix`
packs the blocks on first need for the routes that take only blocks (the
mesh, the block filters).

On a CUDA tensor with f32 or bf16 values :meth:`SymCSRMatrix.matvec`
launches ``csr_spmv`` of :mod:`eigenex_tpu_torch.ops.cuda_spmv`; on the CPU,
and for f64/complex values, the plain gather + ``index_add_`` version runs,
which is also the kernel's oracle.  A product reads every stored entry once
and sums no transposed partials.  A Hermitian container (``hermitian``
True) is its own adjoint; a general one (``hermitian`` False) multiplies
A^H by the same product on its transposed storage
(:meth:`SymCSRMatrix.kernel_adjoint`), made on first need and cached.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.operators import LinearOperator
from ..utils.exceptions import EigenexError
from ..utils.tolerance import accumulation_dtype
from .sym_bsr import SymBSRMatrix

__all__ = ["SymCSRMatrix", "sym_csr_from_triplets"]


@dataclasses.dataclass(frozen=True)
class SymCSRMatrix:
    """Square operator in CSR: row ``i`` holds ``col[rowptr[i]:rowptr[i+1]]``
    (ascending) and the values beside them.  ``hermitian``: the operator is
    symmetric (real) / Hermitian (complex), both triangles stored, and is its
    own adjoint; False for a general operator.  Every constructor states it:
    the field has no default.  Immutable container of tensors."""

    rowptr: torch.Tensor  # (n + 1,) int32
    col: torch.Tensor  # (nnz,) int32, ascending within a row
    val: torch.Tensor  # (nnz,) storage dtype
    shape: tuple[int, int]
    hermitian: bool

    @property
    def nnz(self) -> int:
        return int(self.val.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.val.dtype

    @property
    def device(self) -> torch.device:
        return self.val.device

    @property
    def _acc_dtype(self) -> torch.dtype:
        return accumulation_dtype(self.dtype)

    def to(self, device) -> "SymCSRMatrix":
        return dataclasses.replace(self, rowptr=self.rowptr.to(device), col=self.col.to(device),
                                   val=self.val.to(device))

    def astype(self, dtype) -> "SymCSRMatrix":
        return dataclasses.replace(self, val=self.val.to(dtype))

    def row_ids(self) -> torch.Tensor:
        """The (nnz,) int64 row of each stored entry, for the plain product:
        built once on first use and cached."""
        cached = self.__dict__.get("_row_ids")
        if cached is None:
            cached = self._expanded_rows()
            object.__setattr__(self, "_row_ids", cached)
        return cached

    def _expanded_rows(self) -> torch.Tensor:
        counts = (self.rowptr[1:] - self.rowptr[:-1]).long()
        rows = torch.arange(self.shape[0], device=self.device)
        return torch.repeat_interleave(rows, counts, output_size=self.nnz)

    #: what a kernel keeps on this container between calls (its checked launch
    #: arguments), made once per key and cached, as on the block containers
    kernel_workspace = SymBSRMatrix.kernel_workspace

    def triplets(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(rows, cols, vals) host arrays of the stored entries, row-major:
        int64 indices, values in the storage dtype (bf16 lifted to f32,
        exact: numpy has no bf16)."""
        rowptr = self.rowptr.cpu().numpy().astype(np.int64)
        rows = np.repeat(np.arange(self.shape[0], dtype=np.int64), np.diff(rowptr))
        val = self.val.cpu()
        if val.dtype == torch.bfloat16:
            val = val.to(torch.float32)
        return rows, self.col.cpu().numpy().astype(np.int64), val.numpy()

    # -- compute ---------------------------------------------------------
    def _plain_matvec(self, x: torch.Tensor) -> torch.Tensor:
        from ..ops.cuda_spmv import csr_spmv_plain

        return csr_spmv_plain(self, x)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        from ..ops import cuda_spmv

        if self.val.is_cuda and cuda_spmv.kernel_storage(self.dtype):
            return cuda_spmv.csr_spmv(self, x)
        return self._plain_matvec(x)

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        """A @ X for an (n, p) panel: one product a column (on the card one
        launch of the SpMV kernel each; there is no row-compressed SpMM)."""
        return torch.stack([self.matvec(X[:, j]) for j in range(X.shape[1])], dim=1)

    def rmatvec(self, x: torch.Tensor) -> torch.Tensor:
        """A^H @ x: the same product on :meth:`kernel_adjoint`."""
        return self.kernel_adjoint().matvec(x)

    def kernel_adjoint(self) -> "SymCSRMatrix":
        """A^H in the same storage: the container itself when it is
        Hermitian; else its transpose (conjugated for complex values), sorted
        row-major on the container's device from the stored entries once and
        cached."""
        if self.hermitian:
            return self
        cached = self.__dict__.get("_kernel_adjoint")
        if cached is None:
            m, n = self.shape
            rows, col = self._expanded_rows(), self.col.long()
            order = torch.argsort(col * m + rows, stable=True)  # by column, then row
            rowptr = torch.zeros(n + 1, dtype=torch.int32, device=self.device)
            rowptr[1:] = torch.cumsum(torch.bincount(col, minlength=n), 0)
            val = self.val[order]
            cached = SymCSRMatrix(rowptr, rows[order].to(torch.int32),
                                  val.conj().resolve_conj() if val.is_complex() else val,
                                  (n, m), hermitian=False)
            object.__setattr__(self, "_kernel_adjoint", cached)
        return cached

    def as_linear_operator(self) -> LinearOperator:
        """Capturable into the CUDA graph of a Krylov chunk where the product
        is a kernel launch (CUDA values in a kernel storage)."""
        from ..ops import cuda_spmv

        return LinearOperator(
            _csr_matvec, self, self.shape, self._acc_dtype, self.device,
            rmatvec_fn=_csr_rmatvec, matmat_fn=_csr_matmat,
            capturable=self.val.is_cuda and cuda_spmv.kernel_storage(self.dtype),
        )

    # -- spectral-range estimation ---------------------------------------
    def gershgorin_discs(self):
        """Per-row Gershgorin (center, radius): the diagonal entry and the
        row's other absolute values (every stored entry of the row: both
        triangles of a Hermitian container)."""
        acc = self._acc_dtype
        rows = self.row_ids()
        val = self.val.to(acc)
        on_diag = self.col.long() == rows
        centers = torch.zeros(self.shape[0], dtype=acc, device=self.device)
        centers.index_add_(0, rows[on_diag], val[on_diag])
        row_abs = torch.zeros(self.shape[0], dtype=val.abs().dtype, device=self.device)
        row_abs.index_add_(0, rows, val.abs())
        return centers, row_abs - centers.abs()

    def estimate_eigenvalue_range(self):
        """[min, max] eigenvalue bounds from the Gershgorin discs (cf.
        estimateEigenvalueRange triplets_matrix.hpp:512-540)."""
        centers, radii = self.gershgorin_discs()
        re = centers.real if centers.is_complex() else centers
        return (re - radii).min(), (re + radii).max()

    def to_dense(self) -> torch.Tensor:
        d = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        d.index_put_((self.row_ids(), self.col.long()), self.val, accumulate=True)
        return d


def _csr_matvec(p, x):
    return p.matvec(x)


def _csr_rmatvec(p, x):
    return p.rmatvec(x)


def _csr_matmat(p, X):
    return p.matmat(X)


def sym_csr_from_triplets(rows, cols, vals, n: int, dtype: torch.dtype, device,
                          order=None, *, hermitian: bool) -> SymCSRMatrix:
    """CSR of duplicate-free host triplets of an n x n operator (of BOTH
    triangles where it is ``hermitian``): ``order`` argsorts them row-major
    (by row, then column; ``np.lexsort`` when None).  Values are cast on the host to ``dtype``
    through f32 -- as the native packers round to bf16 -- and the three arrays
    reach ``device`` in one copy each."""
    rows = np.asarray(rows)
    if len(rows) >= 2 ** 31:
        raise EigenexError(f"{len(rows)} entries do not fit the int32 indices of CSR storage")
    if order is None:
        order = np.lexsort((cols, rows))
    rowptr = np.zeros(n + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=n), out=rowptr[1:])
    col = np.asarray(cols).astype(np.int32)[order]
    vals = np.asarray(vals)
    if dtype in (torch.bfloat16, torch.float16, torch.float32) and not np.iscomplexobj(vals):
        vals = vals.astype(np.float32)
    val = torch.from_numpy(np.ascontiguousarray(vals[order])).to(dtype)
    return SymCSRMatrix(torch.from_numpy(rowptr).to(device), torch.from_numpy(col).to(device),
                        val.to(device), (n, n), hermitian)
