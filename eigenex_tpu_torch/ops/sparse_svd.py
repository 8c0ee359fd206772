"""Truncated SVD via Lanczos on the Gram operator.

Counterpart of ``eigenex_tpu/ops/sparse_svd.py``, BASELINE config 4
("truncated SVD of a rank-4 tensor via Lanczos on the Gram matrix,
einsum-built operator").  The Gram operator G = M^H M is a matrix-free
:class:`~eigenex_tpu_torch.core.operators.LinearOperator` whose matvec is
two products (G is never formed); the top-``rank`` eigenpairs come from
:class:`~eigenex_tpu_torch.solvers.lanczos.LanczosEigenSolver` tracking
the largest Ritz values, and the other factor is recovered as
U = M V Sigma^-1.  The result is a
:class:`~eigenex_tpu_torch.ops.tensor_svd.TensorSVDResult` with the same
storage convention (V conjugated).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.operators import LinearOperator
from ..solvers.lanczos import LanczosEigenSolver, LanczosOptions
from ..utils.exceptions import EigenexError
from ..utils.precision import highest_f32_matmul
from .tensor_svd import TensorSVDResult, _split

__all__ = ["truncated_svd_via_lanczos", "gram_operator"]


def _gram_matvec(m, x):
    # G x = M^H (M x): two products, G never materialized
    return m.conj().T @ (m @ x)


def gram_operator(m, device=None) -> LinearOperator:
    """The Gram operator G = M^H M of a matrix.  A tensor stays where it
    lives unless ``device`` says otherwise; a host array goes to ``device``
    (the card by default)."""
    if isinstance(m, torch.Tensor):
        m = m if device is None else m.to(device)
    else:
        from ..utils.device import resolve_device

        m = torch.as_tensor(np.asarray(m)).to(resolve_device(device))
    return LinearOperator(_gram_matvec, m, (m.shape[1], m.shape[1]), m.dtype, m.device)


@highest_f32_matmul()
def truncated_svd_via_lanczos(
    t,
    left_axes: int,
    rank: int,
    *,
    tolerance: float = 1e-12,
    max_subspace: int | None = None,
    seed: int = 0,
    device=None,
) -> TensorSVDResult:
    """Top-``rank`` singular triplets of ``t`` split after ``left_axes``
    axes, without the full SVD.  ``device`` as for :func:`gram_operator`."""
    if not isinstance(t, torch.Tensor) or device is not None:
        from ..utils.device import resolve_device

        t = torch.as_tensor(t if isinstance(t, torch.Tensor) else np.asarray(t))
        t = t.to(resolve_device(device))
    left_dims, right_dims, m = _split(t, left_axes)
    mr, mc = m.shape
    small = min(mr, mc)
    if rank > small:
        raise EigenexError(f"rank {rank} exceeds min matricized dim {small}")

    # Lanczos on the smaller Gram side
    use_right = mc <= mr
    g = gram_operator(m if use_right else m.conj().T)
    dim = mc if use_right else mr
    opts = LanczosOptions(
        max_eigenvalues=rank,
        eigenvalue_indices=tuple(range(-rank, 0)),  # largest Ritz values
        tolerance=tolerance,
        max_subspace=min(max_subspace or max(4 * rank + 16, 32), dim),
        seed=seed,
    )
    res = LanczosEigenSolver(g, opts).compute()
    # ascending from the tridiagonal solver -> descending sigma
    theta = np.maximum(np.asarray(res.eigenvalues)[::-1], 0.0)
    rdt = m.abs().dtype
    sigma = torch.as_tensor(np.sqrt(theta)).to(device=m.device, dtype=rdt)
    W = res.eigenvectors.flip(1)  # (dim, rank), columns for descending sigma
    safe = torch.where(sigma > 0, sigma, torch.ones_like(sigma)).to(m.dtype)
    if use_right:
        V = W  # right singular vectors
        U = (m @ V) / safe[None, :]
    else:
        U = W
        V = (m.conj().T @ U) / safe.conj()[None, :]
    return TensorSVDResult(
        tensor_u=U.reshape(left_dims + (rank,)),
        singular_values=sigma,
        tensor_v=V.conj().reshape(right_dims + (rank,)),
        left_dims=left_dims,
        right_dims=right_dims,
    )
