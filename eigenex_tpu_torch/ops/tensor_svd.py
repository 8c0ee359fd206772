"""Tensor SVD with rank/threshold truncation.

Counterpart of ``eigenex_tpu/ops/tensor_svd.py`` (the reference's
``TensorSVD<TensorT, Urow, Vrow>``, include/cmpt/eigen_ex/tensor_svd.hpp:172):
the SVD of a rank-N tensor split as (first ``left_axes`` axes) x (the
rest),

    T ~ sum_k  U[..., k] s[k] V[..., k],

with the reference's storage convention: ``tensor_v`` holds the
**conjugated** (not adjointed) right factor (tensor_svd.hpp:164-167,303),
so reconstruction needs no further conjugation.

Matricization is a row-major reshape, as in the JAX package, so the
factors agree with it.  The dense SVD is ``torch.linalg.svd``.  Truncation
by threshold or rank either zero-pads, keeping the shapes
(getTruncatedTensorU/V :362-402), or slices; the truncation error is
sqrt(sum of the discarded sigma^2) (:122-126).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.exceptions import EigenexError

__all__ = ["TensorSVDResult", "tensor_svd", "truncated_tensor_svd"]


@dataclasses.dataclass(frozen=True)
class TensorSVDResult:
    """Factors of T = U S V (V stored conjugated, tensor_svd.hpp:164-167)."""

    tensor_u: torch.Tensor  # (left_dims..., k)
    singular_values: torch.Tensor  # (k,) real, descending
    tensor_v: torch.Tensor  # (right_dims..., k) -- conjugated right factor
    left_dims: tuple
    right_dims: tuple

    @property
    def rank(self) -> int:
        return self.singular_values.shape[0]

    def get_rank(self, threshold: float) -> int:
        """Number of singular values > threshold
        (cf. getRank tensor_svd.hpp:318-330)."""
        return int((self.singular_values > threshold).sum())

    def truncation_error(self, rank: int) -> float:
        """sqrt(sum_{k >= rank} sigma_k^2) (cf. tensor_svd.hpp:122-126)."""
        s = self.singular_values.detach().cpu().numpy().astype(np.float64)
        return float(np.sqrt(np.sum(s[rank:] ** 2)))

    def reconstruct(self) -> torch.Tensor:
        """T = sum_k U[..., k] s[k] V[..., k] -- no conjugation, per the
        storage convention."""
        u = self.tensor_u.reshape(-1, self.rank)
        v = self.tensor_v.reshape(-1, self.rank)
        m = (u * self.singular_values.to(u.dtype)[None, :]) @ v.T
        return m.reshape(tuple(self.left_dims) + tuple(self.right_dims))

    def truncated(self, rank: int | None = None, threshold: float | None = None,
                  pad: bool = True) -> "TensorSVDResult":
        """A new result truncated to ``rank`` (or by sigma-threshold).  With
        ``pad=True`` the tensors keep their shapes, zero past the truncation
        rank (the reference's zero-pad semantics); with ``pad=False`` they
        are sliced."""
        if rank is None:
            if threshold is None:
                raise EigenexError("specify rank or threshold")
            rank = self.get_rank(threshold)
        rank = int(rank)
        if pad:
            keep = torch.arange(self.rank, device=self.singular_values.device) < rank
            return TensorSVDResult(
                tensor_u=self.tensor_u * keep.to(self.tensor_u.dtype),
                singular_values=self.singular_values * keep.to(self.singular_values.dtype),
                tensor_v=self.tensor_v * keep.to(self.tensor_v.dtype),
                left_dims=self.left_dims,
                right_dims=self.right_dims,
            )
        return TensorSVDResult(
            tensor_u=self.tensor_u[..., :rank],
            singular_values=self.singular_values[:rank],
            tensor_v=self.tensor_v[..., :rank],
            left_dims=self.left_dims,
            right_dims=self.right_dims,
        )


def _split(t: torch.Tensor, left_axes: int):
    if not (0 < left_axes < t.ndim):
        raise EigenexError(f"left_axes must split the tensor: 0 < {left_axes} < {t.ndim}")
    left_dims = tuple(t.shape[:left_axes])
    right_dims = tuple(t.shape[left_axes:])
    return left_dims, right_dims, t.reshape(int(np.prod(left_dims)), int(np.prod(right_dims)))


def tensor_svd(t, left_axes: int, full_matrices: bool = False) -> TensorSVDResult:
    """SVD of ``t`` split after ``left_axes`` axes
    (cf. TensorSVD::compute tensor_svd.hpp:250-307)."""
    t = t if isinstance(t, torch.Tensor) else torch.as_tensor(np.asarray(t))
    left_dims, right_dims, m = _split(t, left_axes)
    u, s, vh = torch.linalg.svd(m, full_matrices=full_matrices)
    # tensorV stores conj(V); with vh = V^H that is exactly vh.T
    return TensorSVDResult(
        tensor_u=u.reshape(left_dims + (u.shape[1],)),
        singular_values=s,
        tensor_v=vh.T.reshape(right_dims + (vh.shape[0],)),
        left_dims=left_dims,
        right_dims=right_dims,
    )


def truncated_tensor_svd(t, left_axes: int, rank: int | None = None,
                         threshold: float | None = None) -> TensorSVDResult:
    """One-shot truncated SVD (sliced shapes)."""
    return tensor_svd(t, left_axes).truncated(rank=rank, threshold=threshold, pad=False)
