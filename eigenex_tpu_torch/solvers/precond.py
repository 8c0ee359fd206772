"""Preconditioner constructors for the block/iterative solvers.

Counterpart of ``eigenex_tpu/solvers/precond.py``.  The reference has no
preconditioning anywhere (its solvers consume a bare ``MatMulFunction``,
lanczos.hpp:116); preconditioners feed
:func:`~eigenex_tpu_torch.solvers.lobpcg.lobpcg` (``preconditioner=``)
and ``eigsh(..., preconditioner=)``.  The constructors return plain
callables on (n,) vectors or (n, b) blocks of torch tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.exceptions import EigenexError

__all__ = ["jacobi_preconditioner"]


def _extract_diagonal(A, device=None) -> torch.Tensor:
    """The (n,) diagonal of a sparse container (on the container's
    device), of a dense square matrix, or a diagonal given as a vector
    (tensors stay where they are; host arrays go to ``device``, the card
    unless told otherwise)."""
    from ..sparse.bsr import BSRMatrix
    from ..sparse.coo import COOMatrix
    from ..sparse.sym_bsr import SymBSRMatrix
    from ..sparse.sym_csr import SymCSRMatrix

    if isinstance(A, COOMatrix):
        return A.diagonal()
    if isinstance(A, SymCSRMatrix):
        return A.gershgorin_discs()[0]
    if isinstance(A, BSRMatrix):
        nbr, kmax, bm, bn = A.data.shape
        if bm != bn:
            raise EigenexError("Jacobi preconditioner needs square blocks")
        # entries (i, i) of every slot that sits on the block diagonal
        on_diag = A.block_cols == torch.arange(nbr, device=A.device)[:, None]
        d = torch.diagonal(A.data.to(A._acc_dtype), dim1=2, dim2=3)  # (nbr, kmax, bm)
        return (d * on_diag[:, :, None].to(d.dtype)).sum(dim=1).reshape(-1)
    if isinstance(A, SymBSRMatrix):
        d = torch.diagonal(A.diag_data.to(A._acc_dtype), dim1=1, dim2=2)  # (nbr, bm)
        return d.reshape(-1)[: A.shape[0]]
    if not isinstance(A, torch.Tensor):
        A = torch.as_tensor(np.asarray(A)).to(resolve_device(device))
    if A.ndim == 1:
        return A  # already a diagonal vector
    if A.ndim == 2 and A.shape[0] == A.shape[1]:
        return torch.diagonal(A)
    raise EigenexError(
        f"cannot extract a diagonal from operand of shape {tuple(A.shape)}"
    )


def jacobi_preconditioner(A, *, sigma=0.0, floor: float = 1e-30, device=None):
    """``T(r) ~ (diag(A) - sigma)^-1 r`` -- the diagonal (Jacobi)
    preconditioner.

    ``A``: a sparse container (COO/BSR/SymBSR), a dense square matrix, or
    directly the (n,) diagonal vector.  ``sigma`` shifts the diagonal.
    Entries with ``|d - sigma| <= floor`` are passed through unscaled (a
    zero diagonal carries no curvature information).  The returned
    callable accepts a vector or an (n, b) block -- the LOBPCG
    residual-block contract.  It lives where ``A`` lives; ``device``
    places a host operand (the card unless told otherwise).
    """
    d = _extract_diagonal(A, device) - sigma
    mag = d.abs()
    keep = mag > floor
    inv = torch.where(keep, 1.0 / torch.where(keep, d, torch.ones_like(d)), torch.ones_like(d))

    def apply(r):
        r = torch.as_tensor(r).to(inv.device)
        return r * (inv[:, None] if r.ndim == 2 else inv)

    return apply
