"""Symmetric/Hermitian BSR matrix -- half-traffic SpMV storage.

Counterpart of ``eigenex_tpu/sparse/sym_bsr.py`` with the same layout.
SpMV is bound by the bytes of block data it streams, and the flagship
Lanczos matvec is always Hermitian.  Storing only the diagonal blocks
plus the strictly-UPPER block triangle and applying each off-diagonal
block twice (y[r] += B x[c], y[c] += B^H x[r]) halves the bytes streamed
per matvec.

On a CUDA tensor with f32 or bf16 storage :meth:`SymBSRMatrix.matvec`
and :meth:`SymBSRMatrix.matmat` launch the kernels of
:mod:`eigenex_tpu_torch.ops.cuda_spmv`; they add the transposed partials
per block column in the order of a column-sorted index of the real upper
slots, which :meth:`SymBSRMatrix.column_index` builds once and caches, and
the SpMV kernel keeps its scratch and a counter on the container
(:meth:`SymBSRMatrix.kernel_workspace`).  On the CPU,
and for f64/complex storage, the plain gather + einsum + ``index_add_``
versions run; they are also the kernels' oracles.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.operators import LinearOperator
from ..utils.device import resolve_device
from ..utils.exceptions import EigenexError
from ..utils.tolerance import accumulation_dtype, as_torch_dtype
from .bsr import BSRMatrix

__all__ = ["SymBSRMatrix", "sym_bsr_from_bsr"]


@dataclasses.dataclass(frozen=True)
class SymBSRMatrix:
    """Symmetric (real) / Hermitian (complex) block matrix: diagonal
    blocks + strictly-upper BSR-ELL.  Immutable container of tensors."""

    diag_data: torch.Tensor  # (nbr, bm, bm)
    upper_data: torch.Tensor  # (nbr, ku, bm, bm) -- blocks at (r, cols[r,k] > r)
    upper_cols: torch.Tensor  # (nbr, ku) int32; padding slots: col 0, zero data
    shape: tuple[int, int]
    #: max (col - row) over stored upper blocks, in BLOCK units -- the band
    #: reach.  -1 = unknown.  The CUDA kernel takes any reach, known or
    #: not; the field is kept because packed operators carry it across
    #: packages and the distributed layer will need it.
    band_reach: int = -1

    @property
    def block_shape(self) -> tuple[int, int]:
        return (self.diag_data.shape[1], self.diag_data.shape[2])

    @property
    def n_block_rows(self) -> int:
        return self.diag_data.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.upper_data.dtype

    @property
    def device(self) -> torch.device:
        return self.upper_data.device

    @property
    def nnz_stored(self) -> int:
        """Stored (padded) entries -- about half the applied nnz."""
        return int(self.diag_data.numel()) + int(self.upper_data.numel())

    @property
    def nnz_applied(self) -> int:
        """Entries the matvec effectively applies (both triangles)."""
        return int(self.diag_data.numel()) + 2 * int(self.upper_data.numel())

    @property
    def _acc_dtype(self) -> torch.dtype:
        return accumulation_dtype(self.dtype)

    def astype(self, dtype) -> "SymBSRMatrix":
        dtype = as_torch_dtype(dtype)
        return SymBSRMatrix(
            self.diag_data.to(dtype), self.upper_data.to(dtype), self.upper_cols,
            self.shape, self.band_reach,
        )

    def to(self, device) -> "SymBSRMatrix":
        return SymBSRMatrix(
            self.diag_data.to(device), self.upper_data.to(device),
            self.upper_cols.to(device), self.shape, self.band_reach,
        )

    # -- the column index of the transposed partials ----------------------
    def column_index(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``(col_ptr, slot_ids)`` -- a column-sorted index of the REAL
        upper slots, built once on first use and cached.

        ``slot_ids[col_ptr[c]:col_ptr[c+1]]`` lists the flat slot numbers
        ``r * ku + k`` of every stored block whose block column is ``c``,
        in ascending (r, k) order; that fixed order is what makes the
        kernel's transpose pass deterministic.  A slot is real when its
        column lies strictly above the diagonal (``cols[r, k] > r``);
        ELL padding slots (column 0, zero block) are left out, so they
        are neither read nor added into block column 0.  The plain version
        applies every slot as stored, so the two agree only on a canonical
        container: a slot at or below the diagonal that holds a non-zero
        block raises :class:`EigenexError` here instead of being skipped.
        Both tensors are int32 and live on the container's device.
        """
        cached = getattr(self, "_column_index", None)
        if cached is not None:
            return cached
        cols = self.upper_cols.cpu().numpy().astype(np.int64)
        nbr, ku = cols.shape
        rows = np.arange(nbr, dtype=np.int64)[:, None]
        if cols.size and (cols.min() < 0 or cols.max() >= nbr):
            raise EigenexError("SymBSRMatrix: upper_cols holds a block column outside the matrix")
        pad_ids = torch.as_tensor(np.flatnonzero(cols <= rows)).to(self.device)
        flat = self.upper_data.reshape(nbr * ku, -1)
        stray = torch.zeros((), dtype=torch.bool, device=self.device)
        for chunk in pad_ids.split(1024):  # bounded scratch; one sync after the loop
            stray |= (flat[chunk] != 0).any()
        if bool(stray):
            raise EigenexError(
                "SymBSRMatrix: a slot of upper_cols at or below the diagonal holds a "
                "non-zero block; only strictly-upper blocks may be stored "
                "(padding slots: column 0, zero block)"
            )
        rr, kk = np.nonzero(cols > rows)  # row-major: ascending (r, k)
        cc = cols[rr, kk]
        order = np.argsort(cc, kind="stable")  # stable: keeps (r, k) order per column
        slot_ids = (rr * ku + kk)[order].astype(np.int32)
        col_ptr = np.zeros(nbr + 1, np.int32)
        np.cumsum(np.bincount(cc, minlength=nbr), out=col_ptr[1:])
        index = (
            torch.as_tensor(col_ptr).to(self.device),
            torch.as_tensor(slot_ids).to(self.device),
        )
        object.__setattr__(self, "_column_index", index)
        return index

    def kernel_workspace(self, key, make):
        """Buffers a kernel keeps on this container between calls (scratch,
        counters, launch arguments): made once per ``key`` by ``make()``
        and cached, as :meth:`column_index` is."""
        cache = self.__dict__.get("_kernel_workspaces")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_kernel_workspaces", cache)
        found = cache.get(key)
        if found is None:
            found = cache[key] = make()
        return found

    # -- compute ---------------------------------------------------------
    def _plain_matvec(self, x: torch.Tensor) -> torch.Tensor:
        """Gather + batched einsum + scatter-add -- oracle and CPU path."""
        from ..ops.cuda_spmv import sym_bsr_spmv_plain

        return sym_bsr_spmv_plain(self, x)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        from ..ops import cuda_spmv

        if self.upper_data.is_cuda and cuda_spmv.kernel_storage(self.dtype):
            return cuda_spmv.sym_bsr_spmv(self, x)
        return self._plain_matvec(x)

    def _plain_matmat(self, X: torch.Tensor) -> torch.Tensor:
        from ..ops.cuda_spmv import sym_bsr_spmm_plain

        return sym_bsr_spmm_plain(self, X)

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        """A @ X for an (n, p) panel.  CUDA + f32/bf16 storage: the
        two-pass SpMM kernel (or an error, never the plain version);
        otherwise gather + batched einsum + ``index_add_``."""
        from ..ops import cuda_spmv

        if self.upper_data.is_cuda and cuda_spmv.kernel_storage(self.dtype):
            return cuda_spmv.sym_bsr_spmm(self, X)
        return self._plain_matmat(X)

    def as_linear_operator(self) -> LinearOperator:
        """Capturable into the CUDA graph of a Krylov chunk where the product
        is a kernel launch (CUDA blocks in a kernel storage)."""
        from ..ops import cuda_spmv

        return LinearOperator(
            _sym_matvec, self, self.shape, self._acc_dtype, self.device,
            rmatvec_fn=_sym_matvec,  # Hermitian: A == A^H
            matmat_fn=_sym_matmat,
            capturable=self.upper_data.is_cuda and cuda_spmv.kernel_storage(self.dtype),
        )

    # -- spectral-range estimation ---------------------------------------
    def gershgorin_discs(self):
        """Per-row Gershgorin (center, radius) on half-storage: the
        strictly-upper blocks contribute their row sums to their own rows
        AND their column sums to the mirror rows (the |B^H| contribution
        of the lower triangle that is never stored).  Block analog of
        makeGershgorinDiscs (triplets_matrix.hpp:486-510)."""
        acc = self._acc_dtype
        diag = self.diag_data.to(acc)
        au = self.upper_data.to(acc).abs()  # (nbr, ku, bm, bn)
        row_abs = diag.abs().sum(dim=2) + au.sum(dim=(1, 3))  # (nbr, bm)
        # mirror: |B^H| row sums = |B| column sums, scattered to block c
        # (padding slots: col 0, zero blocks -- add nothing)
        col_contrib = au.sum(dim=2)  # (nbr, ku, bn)
        row_abs = row_abs.index_add(
            0, self.upper_cols.long().reshape(-1), col_contrib.reshape(-1, col_contrib.shape[-1])
        )
        centers = torch.diagonal(diag, dim1=1, dim2=2)  # (nbr, bm)
        radii = row_abs - centers.abs()
        return centers.reshape(-1), radii.reshape(-1)

    def estimate_eigenvalue_range(self):
        """[min, max] eigenvalue bounds from the Gershgorin discs (cf.
        estimateEigenvalueRange triplets_matrix.hpp:512-540)."""
        centers, radii = self.gershgorin_discs()
        re = centers.real if centers.is_complex() else centers
        return (re - radii).min(), (re + radii).max()

    def to_dense(self) -> torch.Tensor:
        bm, bn = self.block_shape
        nbr = self.n_block_rows
        nbc = self.shape[1] // bn
        ku = self.upper_cols.shape[1]
        d = torch.zeros((nbr * nbc, bm, bn), dtype=self.dtype, device=self.device)
        rows = torch.arange(nbr, device=self.device)
        d.index_add_(0, rows * nbc + rows, self.diag_data)
        rr = rows.repeat_interleave(ku)
        cc = self.upper_cols.reshape(-1).long()
        up = self.upper_data.reshape(nbr * ku, bm, bn)
        d.index_add_(0, rr * nbc + cc, up)
        upH = up.transpose(1, 2)
        if up.is_complex():
            upH = upH.conj()
        d.index_add_(0, cc * nbc + rr, upH.contiguous())
        return d.reshape(nbr, nbc, bm, bn).permute(0, 2, 1, 3).reshape(self.shape)


def _sym_matvec(p, x):
    return p.matvec(x)


def _sym_matmat(p, X):
    return p.matmat(X)


def sym_bsr_from_bsr(bsr: BSRMatrix, *, check: bool = False, atol: float = 0.0,
                     device=None) -> SymBSRMatrix:
    """Pack a full-storage BSR matrix into symmetric (diag + upper)
    storage.  The strictly-LOWER blocks are dropped -- the matvec
    reconstructs them as the (conjugate) transposes of the upper blocks,
    so the input must actually be symmetric/Hermitian (``check=True``
    verifies each dropped block against its mirror).

    The pack runs on the host; the result lands on ``device``, which
    defaults to the device of ``bsr``."""
    if bsr.shape[0] != bsr.shape[1]:
        raise EigenexError("symmetric storage requires a square matrix")
    bm, bn = bsr.block_shape
    if bm != bn:
        raise EigenexError("symmetric storage requires square blocks")
    device = bsr.device if device is None else resolve_device(device)
    store = bsr.dtype
    # numpy has no bfloat16: lift low-precision storage to f32 for the
    # host pass (exact) and cast back at the end
    data = bsr.data.to(bsr._acc_dtype).cpu().numpy()
    cols = bsr.block_cols.cpu().numpy()
    nbr, kmax = cols.shape
    rows = np.arange(nbr)[:, None]  # (nbr, 1)

    nz = data.reshape(nbr, kmax, -1).any(axis=2)  # (nbr, kmax)
    is_diag = nz & (cols == rows)
    is_upper = nz & (cols > rows)

    # diagonal: sum the (usually single) on-diagonal slot per row
    diag = np.einsum("rkij,rk->rij", data, is_diag.astype(data.dtype))

    if check:
        herm = np.iscomplexobj(data)
        lower: dict[tuple, np.ndarray] = {}
        for r, k in zip(*np.where(nz & (cols < rows))):
            lower[(int(r), int(cols[r, k]))] = data[r, k]
        upper_keys = set()
        for r, k in zip(*np.where(is_upper)):
            c = int(cols[r, k])
            upper_keys.add((int(r), c))
            mirror = lower.get((c, int(r)))
            mirror = 0 if mirror is None else mirror
            want = data[r, k].conj().T if herm else data[r, k].T
            if not np.allclose(mirror, want, atol=atol, rtol=0):
                raise EigenexError(
                    f"matrix is not symmetric at block ({r}, {c}); "
                    "sym_bsr_from_bsr would silently change it"
                )
        # the dropped blocks are the LOWER ones -- each must have an upper
        # mirror, else e.g. a lower-triangle-only store would silently
        # become diagonal-only
        for (r, c) in lower:
            if (c, r) not in upper_keys:
                raise EigenexError(
                    f"lower block ({r}, {c}) has no upper mirror -- the "
                    "matrix is not symmetric (or is stored lower-triangle-"
                    "only, which sym_bsr_from_bsr does not accept)"
                )
        dsym = np.conj(np.swapaxes(diag, 1, 2)) if herm else np.swapaxes(diag, 1, 2)
        bad = np.where(~np.isclose(diag, dsym, atol=atol, rtol=0).all(axis=(1, 2)))[0]
        if bad.size:
            raise EigenexError(f"diagonal block {int(bad[0])} is not symmetric")

    # pack the upper slots left (stable argsort floats is_upper slots to
    # the front of each row) -- vectorised: no per-block-row Python loop
    ku = max(int(is_upper.sum(axis=1).max(initial=0)), 1)
    order = np.argsort(~is_upper, axis=1, kind="stable")[:, :ku]  # (nbr, ku)
    valid = np.take_along_axis(is_upper, order, axis=1)
    ud = np.take_along_axis(data, order[:, :, None, None], axis=1).copy()
    ud[~valid] = 0
    uc = np.where(valid, np.take_along_axis(cols, order, axis=1), 0).astype(np.int32)
    # band reach (block units): max col - row over REAL upper slots
    # (padding slots point at col 0 and would give a negative reach)
    reach = int((np.where(valid, uc, 0) - rows).max(initial=0))
    return SymBSRMatrix(
        torch.as_tensor(diag).to(store).to(device),
        torch.as_tensor(ud).to(store).to(device),
        torch.as_tensor(uc).to(device),
        bsr.shape,
        max(reach, 0),
    )
