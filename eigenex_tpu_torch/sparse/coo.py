"""COO (triplet) sparse matrix.

Counterpart of ``eigenex_tpu/sparse/coo.py``: a mutable host-side
accumulator (:class:`COOBuilder`, the analog of the reference's
appendTriplet/setFromDenseMatrix/shrink, triplets_matrix.hpp:139-296)
producing an immutable container of tensors (:class:`COOMatrix`) whose
SpMV is a vectorised gather-multiply-``index_add_`` instead of the
reference's serial scatter loop (triplets_matrix.hpp:314-318).

The COO path is dtype-generic (f32/f64/complex) and is the slow,
general route; the fast route is the block containers
(:mod:`eigenex_tpu_torch.sparse.bsr`, :mod:`eigenex_tpu_torch.sparse.sym_bsr`)
with the CUDA kernels of :mod:`eigenex_tpu_torch.ops.cuda_spmv`.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch

from .. import native
from ..core.operators import LinearOperator
from ..utils.device import resolve_device
from ..utils.exceptions import EigenexError

__all__ = ["COOBuilder", "COOMatrix", "coo_from_dense", "coo_identity"]


class COOBuilder:
    """Host-side mutable triplet accumulator (cf. TripletsMatrix's mutable
    surface: resize :98, fitSize :120, appendTriplet :139,
    setIdentity :180, shrink :238)."""

    def __init__(self, rows: int = 0, cols: int = 0, dtype=np.float64):
        self.rows = int(rows)
        self.cols = int(cols)
        self.dtype = np.dtype(dtype)
        self._r: list = []
        self._c: list = []
        self._v: list = []

    def resize(self, rows: int, cols: int) -> "COOBuilder":
        self.rows, self.cols = int(rows), int(cols)
        return self

    def fit_size(self) -> "COOBuilder":
        """Shrink-wrap dims to the largest appended index + 1
        (cf. fitSize triplets_matrix.hpp:120-137)."""
        if self._r:
            self.rows = max(self.rows, int(np.max(self._r)) + 1)
            self.cols = max(self.cols, int(np.max(self._c)) + 1)
        return self

    def append(self, row: int, col: int, value) -> "COOBuilder":
        """cf. appendTriplet triplets_matrix.hpp:139-155 (range-checked)."""
        if not (0 <= row < self.rows and 0 <= col < self.cols):
            raise EigenexError(
                f"triplet ({row},{col}) out of range for {self.rows}x{self.cols}"
            )
        self._r.append(int(row))
        self._c.append(int(col))
        self._v.append(value)
        return self

    def extend(self, rows: Iterable[int], cols: Iterable[int], values) -> "COOBuilder":
        r = np.asarray(list(rows), np.int32)
        c = np.asarray(list(cols), np.int32)
        v = np.asarray(list(values))
        if r.size and (r.min() < 0 or r.max() >= self.rows or c.min() < 0 or c.max() >= self.cols):
            raise EigenexError("triplet indices out of range")
        self._r.extend(r.tolist())
        self._c.extend(c.tolist())
        self._v.extend(v.tolist())
        return self

    def set_identity(self, n: int | None = None) -> "COOBuilder":
        """cf. setIdentity triplets_matrix.hpp:180-192."""
        if n is not None:
            self.resize(n, n)
        n = min(self.rows, self.cols)
        self._r, self._c = list(range(n)), list(range(n))
        self._v = [1] * n
        return self

    def build(self, threshold: float = 0.0, device=None) -> "COOMatrix":
        """Sort row-major, merge duplicate entries, drop |v| <= threshold
        (the ``shrink`` pipeline triplets_matrix.hpp:194-296), then freeze
        to tensors on ``device`` (the card unless told otherwise).  f64
        triplets go through the native ``coo_shrink`` where the library
        is available, as in the JAX package."""
        r = np.asarray(self._r, np.int32)
        c = np.asarray(self._c, np.int32)
        v = np.asarray(self._v, self.dtype)
        if v.dtype == np.float64 and r.size and native.native_available():
            r64, c64, v = native.coo_shrink(r, c, v, self.cols, threshold)
            r, c = r64.astype(np.int32), c64.astype(np.int32)
        else:
            r, c, v = _shrink(r, c, v, self.rows, self.cols, threshold)
        return _coo_on(r, c, v, (self.rows, self.cols), resolve_device(device))


def _coo_on(r, c, v, shape, device) -> "COOMatrix":
    return COOMatrix(
        torch.as_tensor(np.ascontiguousarray(r, np.int32)).to(device),
        torch.as_tensor(np.ascontiguousarray(c, np.int32)).to(device),
        torch.as_tensor(np.ascontiguousarray(v)).to(device),
        (int(shape[0]), int(shape[1])),
    )


def _shrink(r, c, v, rows, cols, threshold):
    """Sort, merge duplicates, drop small entries (the ``shrink`` pipeline,
    triplets_matrix.hpp:194-296).  Entries come out sorted row-major."""
    if r.size == 0:
        return r, c, v
    flat = r.astype(np.int64) * cols + c
    order = np.argsort(flat, kind="stable")
    v, flat = v[order], flat[order]
    uniq, inv = np.unique(flat, return_inverse=True)
    merged = np.zeros(uniq.shape, v.dtype)
    np.add.at(merged, inv, v)
    keep = np.abs(merged) > threshold
    uniq, merged = uniq[keep], merged[keep]
    return (uniq // cols).astype(np.int32), (uniq % cols).astype(np.int32), merged


@dataclasses.dataclass(frozen=True)
class COOMatrix:
    """Immutable COO operator container.

    SpMV is ``index_add_(row, val * x[col])`` -- the vectorised
    replacement for the serial scatter ``out[row] += in[col]*v``
    (triplets_matrix.hpp:314-318).
    """

    row: torch.Tensor  # (nnz,) int32
    col: torch.Tensor  # (nnz,) int32
    val: torch.Tensor  # (nnz,)
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.val.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.val.dtype

    @property
    def device(self) -> torch.device:
        return self.val.device

    def to(self, device) -> "COOMatrix":
        return COOMatrix(self.row.to(device), self.col.to(device), self.val.to(device), self.shape)

    # -- transforms (return new containers on this container's device) ----
    def _resorted(self, row, col, val, shape) -> "COOMatrix":
        """Host arrays re-sorted row-major (``lexsort``), the invariant of
        :meth:`build`'s output, back on this container's device."""
        order = np.lexsort((col, row))
        return _coo_on(row[order], col[order], val[order], shape, self.device)

    def transpose(self) -> "COOMatrix":
        """cf. transpose triplets_matrix.hpp:386-404 (re-sorted row-major)."""
        r, c, v = self._host()
        return self._resorted(c, r, v, (self.shape[1], self.shape[0]))

    def adjoint(self) -> "COOMatrix":
        """cf. adjoint triplets_matrix.hpp:406-421 (re-sorted row-major)."""
        r, c, v = self._host()
        return self._resorted(c, r, np.conj(v), (self.shape[1], self.shape[0]))

    @property
    def T(self) -> "COOMatrix":
        return self.transpose()

    @property
    def H(self) -> "COOMatrix":
        return self.adjoint()

    def scalar_multiple(self, c) -> "COOMatrix":
        """cf. scalarMultiple triplets_matrix.hpp:423-434"""
        return COOMatrix(self.row, self.col, self.val * c, self.shape)

    def __mul__(self, c) -> "COOMatrix":
        return self.scalar_multiple(c)

    __rmul__ = __mul__

    def __add__(self, other: "COOMatrix") -> "COOMatrix":
        """Entry-append + merge (cf. operator+ triplets_matrix.hpp:566-571):
        the values promoted as ``np.promote_types`` does, duplicates summed
        and explicit zeros dropped by :func:`_shrink`."""
        if self.shape != other.shape:
            raise EigenexError(f"shape mismatch: {self.shape} vs {other.shape}")
        (r1, c1, v1), (r2, c2, v2) = self._host(), other._host()
        dt = np.promote_types(v1.dtype, v2.dtype)
        r, c, v = _shrink(np.concatenate([r1, r2]), np.concatenate([c1, c2]),
                          np.concatenate([v1.astype(dt), v2.astype(dt)]),
                          self.shape[0], self.shape[1], 0.0)
        return _coo_on(r, c, v, self.shape, self.device)

    def __sub__(self, other: "COOMatrix") -> "COOMatrix":
        return self + other.scalar_multiple(-1)

    # -- compute ---------------------------------------------------------
    def _index64(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(row, col) as int64, the index type of gathers and ``index_add_``:
        converted once per container, at its first product, and kept beside
        the int32 fields (a conversion per call would move as many bytes
        as the product itself)."""
        cached = self.__dict__.get("_idx64")
        if cached is None:
            cached = (self.row.long(), self.col.long())
            object.__setattr__(self, "_idx64", cached)
        return cached

    def _scatter(self, contrib, index, size):
        out = torch.zeros((size,) + tuple(contrib.shape[1:]), dtype=contrib.dtype,
                          device=contrib.device)
        return out.index_add_(0, index, contrib)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x (cf. operate triplets_matrix.hpp:324-329)."""
        row, col = self._index64()
        return self._scatter(self.val * x[col], row, self.shape[0])

    def rmatvec(self, x: torch.Tensor) -> torch.Tensor:
        row, col = self._index64()
        return self._scatter(self.val.conj() * x[row], col, self.shape[1])

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        """Dense-RHS SpMM (cf. triplets_matrix.hpp:359-371)."""
        row, col = self._index64()
        return self._scatter(self.val[:, None] * X[col], row, self.shape[0])

    def diagonal(self) -> torch.Tensor:
        """Main diagonal as a dense (n,) vector (duplicate triplets sum,
        matching the SpMV semantics) -- feeds the Jacobi preconditioner
        (:func:`eigenex_tpu_torch.solvers.precond.jacobi_preconditioner`)."""
        n = min(self.shape)
        on_diag = (self.row == self.col) & (self.row < n)
        return self._scatter(self.val[on_diag], self._index64()[0][on_diag], n)

    # -- host views ------------------------------------------------------
    def _host(self):
        return (
            self.row.cpu().numpy(),
            self.col.cpu().numpy(),
            self.val.cpu().numpy(),
        )

    def to_dense(self) -> np.ndarray:
        """Dense HOST array (cf. makeDenseMatrix triplets_matrix.hpp:436-443);
        duplicate triplets sum, matching the SpMV semantics."""
        r, c, v = self._host()
        d = np.zeros(self.shape, v.dtype)
        np.add.at(d, (r, c), v)
        return d

    def to_scipy(self):
        """scipy.sparse.coo_matrix view (cf. makeSparseMatrix
        triplets_matrix.hpp:445-450)."""
        import scipy.sparse as sp

        r, c, v = self._host()
        return sp.coo_matrix((v, (r, c)), shape=self.shape)

    def as_linear_operator(self) -> LinearOperator:
        """The solver bridge (cf. makeMatMulFunction triplets_matrix.hpp:373-380)."""
        return LinearOperator(
            _container_matvec,
            self,
            self.shape,
            self.dtype,
            self.device,
            rmatvec_fn=_container_rmatvec,
            matmat_fn=_container_matmat,
        )

    # -- norms (cf. l1norm/l2norm/linorm triplets_matrix.hpp:452-481) ----
    def l1norm(self) -> torch.Tensor:
        """max column sum of |v|, a 0-d tensor on this container's device"""
        return self._scatter(self.val.abs(), self._index64()[1], self.shape[1]).max()

    def l2norm(self) -> torch.Tensor:
        """Frobenius norm (the reference's l2norm :462-470)"""
        return torch.sqrt(torch.sum(self.val.abs() ** 2))

    def linorm(self) -> torch.Tensor:
        """max row sum of |v|"""
        return self._scatter(self.val.abs(), self._index64()[0], self.shape[0]).max()

    # -- spectral-range estimation ---------------------------------------
    def gershgorin_discs(self):
        """Per-row (center, radius) of the Gershgorin discs
        (cf. makeGershgorinDiscs triplets_matrix.hpp:486-510)."""
        if self.shape[0] != self.shape[1]:
            raise EigenexError("Gershgorin discs require a square matrix")
        diag_mask = self.row == self.col
        row = self._index64()[0]
        zero = torch.zeros((), dtype=self.val.dtype, device=self.device)
        centers = self._scatter(torch.where(diag_mask, self.val, zero), row, self.shape[0])
        absv = self.val.abs()
        radii = self._scatter(
            torch.where(diag_mask, torch.zeros_like(absv), absv), row, self.shape[0]
        )
        return centers, radii

    def estimate_eigenvalue_range(self):
        """[min, max] real-eigenvalue bounds from the Gershgorin discs
        (cf. estimateEigenvalueRange triplets_matrix.hpp:512-540)."""
        centers, radii = self.gershgorin_discs()
        re = centers.real if centers.is_complex() else centers
        return (re - radii).min(), (re + radii).max()


def _container_matvec(p, x):
    return p.matvec(x)


def _container_rmatvec(p, x):
    return p.rmatvec(x)


def _container_matmat(p, X):
    return p.matmat(X)


def coo_from_dense(A, threshold: float = 0.0, device=None) -> COOMatrix:
    """cf. setFromDenseMatrix triplets_matrix.hpp:157-178."""
    A = np.asarray(A)
    r, c = np.nonzero(np.abs(A) > threshold)
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    return _coo_on(r, c, A[r, c], A.shape, resolve_device(device))


def coo_identity(n: int, dtype=np.float64, device=None) -> COOMatrix:
    idx = np.arange(n, dtype=np.int32)
    return _coo_on(idx, idx, np.ones((n,), dtype), (n, n), resolve_device(device))
