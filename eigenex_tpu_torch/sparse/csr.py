"""CSR sparse matrix.

Counterpart of ``eigenex_tpu/sparse/csr.py``.  The reference only has
COO (triplets_matrix.hpp); CSR is part of the capability surface
mandated by BASELINE.json ("CSR/COO/BSR storage").  The row-pointer
array does not help a gather-multiply-``index_add_`` product, so
:class:`CSRMatrix` stores the expanded row ids alongside ``indptr``:
``indptr`` serves construction, slicing and interop, and every product
goes through the container's COO view (built once, with its int64
indices), as the JAX package's compute path is COO's segment-sum.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.operators import LinearOperator
from ..utils.exceptions import EigenexError
from .coo import COOMatrix, _container_matmat, _container_matvec, _container_rmatvec

__all__ = ["CSRMatrix", "csr_from_coo", "csr_from_dense"]


@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    indptr: torch.Tensor  # (m+1,) int32
    indices: torch.Tensor  # (nnz,) int32 column ids, row-sorted
    data: torch.Tensor  # (nnz,)
    row_ids: torch.Tensor  # (nnz,) int32 expanded row ids (compute path)
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.data.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def to(self, device) -> "CSRMatrix":
        return CSRMatrix(self.indptr.to(device), self.indices.to(device), self.data.to(device),
                         self.row_ids.to(device), self.shape)

    def to_coo(self) -> COOMatrix:
        """The COO view on the same tensors, built once and kept (with the
        int64 indices its products convert once)."""
        coo = self.__dict__.get("_coo")
        if coo is None:
            coo = COOMatrix(self.row_ids, self.indices, self.data, self.shape)
            object.__setattr__(self, "_coo", coo)
        return coo

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.to_coo().matvec(x)

    def rmatvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.to_coo().rmatvec(x)

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        return self.to_coo().matmat(X)

    def to_dense(self) -> np.ndarray:
        """Dense HOST array, as :meth:`COOMatrix.to_dense`."""
        return self.to_coo().to_dense()

    def to_scipy(self):
        """scipy.sparse.csr_matrix view (cf. makeSparseMatrix
        triplets_matrix.hpp:445-450)."""
        import scipy.sparse as sp

        return sp.csr_matrix(
            (self.data.cpu().numpy(), self.indices.cpu().numpy(), self.indptr.cpu().numpy()),
            shape=self.shape,
        )

    # -- spectral-range estimation ---------------------------------------
    def gershgorin_discs(self):
        """Per-row Gershgorin (center, radius) -- CSR twin of the COO/BSR
        implementations (makeGershgorinDiscs triplets_matrix.hpp:486-510)."""
        if self.shape[0] != self.shape[1]:
            raise EigenexError("Gershgorin discs require a square matrix")
        return self.to_coo().gershgorin_discs()

    def estimate_eigenvalue_range(self):
        """[min, max] real-eigenvalue bounds from the Gershgorin discs
        (cf. estimateEigenvalueRange triplets_matrix.hpp:512-540)."""
        return self.to_coo().estimate_eigenvalue_range()

    def as_linear_operator(self) -> LinearOperator:
        return LinearOperator(
            _container_matvec,
            self,
            self.shape,
            self.dtype,
            self.device,
            rmatvec_fn=_container_rmatvec,
            matmat_fn=_container_matmat,
        )


def csr_from_coo(coo: COOMatrix, device=None) -> CSRMatrix:
    """Sort the triplets row-major (host ``lexsort``) and build the row
    pointers; the tensors land where ``coo`` lives unless ``device`` says
    otherwise."""
    r, c, v = coo._host()
    order = np.lexsort((c, r))
    r, c, v = r[order], c[order], v[order]
    indptr = np.zeros(coo.shape[0] + 1, np.int32)
    indptr[1:] = np.cumsum(np.bincount(r, minlength=coo.shape[0]))
    device = coo.device if device is None else torch.device(device)

    def on(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device)

    return CSRMatrix(on(indptr), on(c.astype(np.int32)), on(v), on(r.astype(np.int32)),
                     coo.shape)


def csr_from_dense(A, threshold: float = 0.0, device=None) -> CSRMatrix:
    """``device``: the card unless told otherwise."""
    from .coo import coo_from_dense

    return csr_from_coo(coo_from_dense(A, threshold, device))
