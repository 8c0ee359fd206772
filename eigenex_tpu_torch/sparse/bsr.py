"""BSR (block-sparse row) matrix in ELLPACK-padded layout.

Counterpart of ``eigenex_tpu/sparse/bsr.py`` with the same layout, so
packed operators move between the two packages as plain arrays:

- ``data``:       (n_block_rows, k_max, bm, bn) dense block stack
- ``block_cols``: (n_block_rows, k_max) int32 column-block ids
  (padding slots point at block-column 0 with all-zero data, so no
  masking is needed in the inner loop)

SpMV is gather + batched small matmul over static shapes.  On a CUDA
tensor with f32 or bf16 storage :meth:`BSRMatrix.matvec` and
:meth:`BSRMatrix.matmat` launch the hand-written kernels of
:mod:`eigenex_tpu_torch.ops.cuda_spmv`; on the CPU, and for f64/complex
storage, they take the plain gather + einsum versions, which are also
the kernels' oracles.  The route is decided by
``tensor.is_cuda`` and the storage dtype, never by a failed launch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import native
from ..core.operators import LinearOperator
from ..utils.device import resolve_device
from ..utils.exceptions import EigenexError
from ..utils.tolerance import accumulation_dtype, as_torch_dtype

__all__ = ["BSRMatrix", "bsr_from_coo_arrays", "bsr_from_dense"]


@dataclasses.dataclass(frozen=True)
class BSRMatrix:
    """ELL-padded block-sparse-row matrix (immutable container of tensors)."""

    data: torch.Tensor  # (nbr, kmax, bm, bn)
    block_cols: torch.Tensor  # (nbr, kmax) int32
    shape: tuple[int, int]

    @property
    def block_shape(self) -> tuple[int, int]:
        return (self.data.shape[2], self.data.shape[3])

    @property
    def n_block_rows(self) -> int:
        return self.data.shape[0]

    @property
    def n_block_cols(self) -> int:
        return self.shape[1] // self.block_shape[1]

    @property
    def k_max(self) -> int:
        return self.data.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def nnz(self) -> int:
        """Stored (padded) entries -- the work the device actually does."""
        return int(self.data.numel())

    @property
    def _acc_dtype(self) -> torch.dtype:
        return accumulation_dtype(self.dtype)

    def astype(self, dtype) -> "BSRMatrix":
        """Recast stored blocks (e.g. to bfloat16, halving SpMV traffic)."""
        return BSRMatrix(self.data.to(as_torch_dtype(dtype)), self.block_cols, self.shape)

    def to(self, device) -> "BSRMatrix":
        return BSRMatrix(self.data.to(device), self.block_cols.to(device), self.shape)

    def _plain_matvec(self, x: torch.Tensor) -> torch.Tensor:
        from ..ops.cuda_spmv import bsr_spmv_plain

        return bsr_spmv_plain(self, x)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x.  CUDA + f32/bf16 storage: the hand-written kernel;
        otherwise gather + batched block matmul."""
        from ..ops import cuda_spmv

        if self.data.is_cuda and cuda_spmv.kernel_storage(self.dtype):
            return cuda_spmv.bsr_spmv(self, x)
        return self._plain_matvec(x)

    def _plain_matmat(self, X: torch.Tensor) -> torch.Tensor:
        from ..ops.cuda_spmv import bsr_spmm_plain

        return bsr_spmm_plain(self, X)

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        """A @ X for an (n, p) panel.  CUDA + f32/bf16 storage: the
        hand-written SpMM kernel (or an error, never the plain version);
        otherwise gather + block-batched matmuls.  The JAX package keeps
        this product on its plain einsum even on a TPU and reaches its
        SpMM kernel only through ``bsr_matmat_pallas``; the results are
        the same."""
        from ..ops import cuda_spmv

        if self.data.is_cuda and cuda_spmv.kernel_storage(self.dtype):
            return cuda_spmv.bsr_spmm(self, X)
        return self._plain_matmat(X)

    def rmatvec(self, x: torch.Tensor) -> torch.Tensor:
        """A^H @ x, through :meth:`kernel_adjoint` (so on CUDA tensors the
        same kernel as :meth:`matvec`)."""
        return self.kernel_adjoint().matvec(x)

    def kernel_adjoint(self) -> "BSRMatrix":
        """A^H as a container of the SAME block shape, built once on the
        host from the stored entries and cached.  The block transpose of
        :meth:`adjoint` turns (bm, bn) blocks into (bn, bm); the SpMV kernel
        needs a block width that is a multiple of 128, which a (32, 128)
        general pack would lose.  Where the transposed shape does not tile
        by (bm, bn), this is :meth:`adjoint`."""
        cached = self.__dict__.get("_kernel_adjoint")
        if cached is not None:
            return cached
        bm, bn = self.block_shape
        m, n = self.shape
        if n % bm or m % bn:
            adj = self.adjoint()
        else:
            data = self.data.to(self._acc_dtype).cpu().numpy()
            rb, kk, ii, jj = np.nonzero(data)
            rows = rb * bm + ii
            cols = self.block_cols.cpu().numpy()[rb, kk].astype(np.int64) * bn + jj
            vals = data[rb, kk, ii, jj]
            packed, block_cols, _ = _pack_bsr_host(
                cols, rows, np.conj(vals) if np.iscomplexobj(vals) else vals, (n, m), (bm, bn))
            adj = BSRMatrix(torch.as_tensor(packed).to(self.dtype).to(self.device),
                            torch.as_tensor(block_cols).to(self.device), (n, m))
        object.__setattr__(self, "_kernel_adjoint", adj)
        return adj

    def as_linear_operator(self) -> LinearOperator:
        """Capturable into the CUDA graph of a Krylov chunk where the product
        is a kernel launch (CUDA blocks in a kernel storage)."""
        from ..ops import cuda_spmv

        return LinearOperator(
            _container_matvec, self, self.shape, self._acc_dtype, self.device,
            rmatvec_fn=_container_rmatvec, matmat_fn=_container_matmat,
            capturable=self.data.is_cuda and cuda_spmv.kernel_storage(self.dtype),
        )

    def to_dense(self) -> torch.Tensor:
        bm, bn = self.block_shape
        nbr, kmax = self.block_cols.shape
        d = torch.zeros((nbr * self.n_block_cols, bm, bn), dtype=self.dtype, device=self.device)
        rows = torch.arange(nbr, device=self.device).repeat_interleave(kmax)
        flat = rows * self.n_block_cols + self.block_cols.reshape(-1).long()
        d.index_add_(0, flat, self.data.reshape(nbr * kmax, bm, bn))
        d = d.reshape(nbr, self.n_block_cols, bm, bn)
        return d.permute(0, 2, 1, 3).reshape(self.shape)

    def scalar_multiple(self, c) -> "BSRMatrix":
        return BSRMatrix(self.data * c, self.block_cols, self.shape)

    def transpose(self) -> "BSRMatrix":
        """A^T as a new BSR-ELL container (host-side repack: block (r, c)
        becomes block^T at (c, r) -- cf. TripletsMatrix::transpose
        triplets_matrix.hpp:386-404)."""
        store = self.dtype
        data = self.data.to(self._acc_dtype).cpu().numpy()
        cols = self.block_cols.cpu().numpy()
        nbr, kmax, bm, bn = data.shape
        nbc = self.n_block_cols
        nz = data.reshape(nbr, kmax, -1).any(axis=2)
        rr, kk = np.nonzero(nz)
        cc = cols[rr, kk].astype(np.int64)
        order = np.lexsort((rr, cc))  # by new row (old col), then old row
        rr, kk, cc = rr[order], kk[order], cc[order]
        counts = np.bincount(cc, minlength=nbc)
        width = max(int(counts.max(initial=0)), 1)
        start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(len(cc)) - start[cc]
        out_d = np.zeros((nbc, width, bn, bm), data.dtype)
        out_c = np.zeros((nbc, width), np.int32)
        out_d[cc, slot] = data[rr, kk].transpose(0, 2, 1)
        out_c[cc, slot] = rr
        return BSRMatrix(
            torch.as_tensor(out_d).to(store).to(self.device),
            torch.as_tensor(out_c).to(self.device),
            (self.shape[1], self.shape[0]),
        )

    def adjoint(self) -> "BSRMatrix":
        """A^H (cf. TripletsMatrix::adjoint triplets_matrix.hpp:406-421)."""
        t = self.transpose()
        if self.dtype.is_complex:
            return BSRMatrix(t.data.conj().resolve_conj(), t.block_cols, t.shape)
        return t

    # -- spectral-range estimation ---------------------------------------
    def gershgorin_discs(self):
        """Per-row (center, radius) of the Gershgorin discs on the block
        data (the block analog of makeGershgorinDiscs,
        triplets_matrix.hpp:486-510): center = the diagonal entry,
        radius = sum_{j != i} |a_ij| over the padded block row (padding
        blocks are zero, so they contribute nothing)."""
        bm, bn = self.block_shape
        if self.shape[0] != self.shape[1] or bm != bn:
            raise EigenexError("Gershgorin discs require a square matrix with square blocks")
        nbr = self.n_block_rows
        data = self.data.to(self._acc_dtype)
        row_abs = data.abs().sum(dim=(1, 3)).reshape(-1)  # (nbr*bm,)
        is_diag = (
            self.block_cols == torch.arange(nbr, device=self.device)[:, None]
        ).to(data.dtype)
        dblk = torch.einsum("rkij,rk->rij", data, is_diag)
        centers = torch.diagonal(dblk, dim1=1, dim2=2).reshape(-1)
        radii = row_abs - centers.abs()
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


def _pack_bsr_host(row, col, val, shape, block_shape):
    """(data, block_cols, (m, n)) numpy arrays of the padded BSR-ELL
    layout from host triplets (duplicates sum)."""
    bm, bn = block_shape
    m = -(-shape[0] // bm) * bm
    n = -(-shape[1] // bn) * bn
    nbr, nbc = m // bm, n // bn
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    br, bc = row // bm, col // bn
    ir, ic = row % bm, col % bn
    # group triplets by (block_row, block_col)
    key = br * nbc + bc
    uniq_key, block_of_triplet = np.unique(key, return_inverse=True)
    ubr, ubc = uniq_key // nbc, uniq_key % nbc
    # slot index of each unique block within its block row (uniq_key is
    # sorted by block row, then block column)
    k_per_row = np.bincount(ubr, minlength=nbr)
    kmax = max(int(k_per_row.max(initial=0)), 1)
    first = np.concatenate([[0], np.cumsum(k_per_row)[:-1]])
    slot = np.arange(len(uniq_key)) - first[ubr]
    data = np.zeros((nbr, kmax, bm, bn), val.dtype)
    block_cols = np.zeros((nbr, kmax), np.int32)
    np.add.at(data, (ubr[block_of_triplet], slot[block_of_triplet], ir, ic), val)
    block_cols[ubr, slot] = ubc
    return data, block_cols, (m, n)


def bsr_from_coo_arrays(
    row: np.ndarray,
    col: np.ndarray,
    val: np.ndarray,
    shape: tuple[int, int],
    block_shape: tuple[int, int],
    dtype=None,
    device=None,
) -> BSRMatrix:
    """Pack host COO triplets into the padded BSR-ELL layout.

    Rows/cols beyond a block-shape multiple are zero-padded (the extra
    rows/cols are structurally zero, harmless for SpMV and Krylov use).
    ``dtype`` is a numpy dtype for the packed values; the tensors land on
    ``device`` (the card unless told otherwise).  f32 and f64 values go
    through the native packer where the library is available, as in the
    JAX package: it accumulates in f64 and fills a block row's slots in the
    order its blocks first occur, the numpy packer in column order.
    """
    val = np.asarray(val, dtype)
    if val.dtype in (np.float32, np.float64) and native.native_available():
        data, block_cols, padded = native.bsr_pack(
            row, col, val.astype(np.float64), shape, block_shape)
        data = data.astype(val.dtype)
    else:
        data, block_cols, padded = _pack_bsr_host(row, col, val, shape, block_shape)
    device = resolve_device(device)
    return BSRMatrix(
        torch.as_tensor(data).to(device), torch.as_tensor(block_cols).to(device), padded
    )


def bsr_from_dense(A, block_shape: tuple[int, int], threshold: float = 0.0,
                   device=None) -> BSRMatrix:
    A = np.asarray(A)
    r, c = np.nonzero(np.abs(A) > threshold)
    return bsr_from_coo_arrays(r, c, A[r, c], A.shape, block_shape, device=device)
