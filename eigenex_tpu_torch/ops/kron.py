"""Lazy tensor Kronecker (outer) product.

Counterpart of ``eigenex_tpu/ops/kron.py`` (the reference's
include/cmpt/eigen_ex/tensor_kronecker_product.hpp):
``TensorKroneckerProduct`` (:19) -- an O(1)-storage virtual tensor whose
axes are the concatenation of the two factors' axes and whose
coefficients are products of factor coefficients (:81-95), with
``makeDenseTensor`` (:104-116) materialization.

The einsum layer never gathers scalars over this virtual tensor, as the
reference's general einsum does (einsum.hpp:892,1000-1018), so the lazy
product serves API parity, cheap coefficient peeking, and one dense
outer product when an explicit tensor is wanted.
"""

from __future__ import annotations

import torch

from ..core.indices import ProductIndices
from ..utils.device import as_device_tensor

__all__ = ["TensorKroneckerProduct", "tensor_kronecker_product"]


class TensorKroneckerProduct:
    """Lazy outer product of two tensors (never materialized unless asked).
    Tensors stay where they live; host arrays go to ``device`` (the card
    unless told otherwise), or join a tensor factor's device."""

    def __init__(self, left, right, device=None):
        if device is None:
            device = next((t.device for t in (left, right) if isinstance(t, torch.Tensor)), None)
        self.left = as_device_tensor(left, device)
        self.right = as_device_tensor(right, device)
        #: joined axes = left axes then right axes (tensor_kronecker_product.hpp:54-71)
        self.dims = tuple(self.left.shape) + tuple(self.right.shape)
        self._pi = ProductIndices(self.dims)

    @property
    def ndim(self) -> int:
        return len(self.dims)

    @property
    def dtype(self) -> torch.dtype:
        return torch.promote_types(self.left.dtype, self.right.dtype)

    def coeff_flat(self, flat: int):
        """coeff(flat) = left.flat[i0] * right.flat[i1]
        (tensor_kronecker_product.hpp:81-88)."""
        multi = self._pi.indices(int(flat))
        return self.coeff(multi)

    def coeff(self, multi):
        """coeff(indices) (tensor_kronecker_product.hpp:90-95)."""
        nl = self.left.ndim
        il, ir = tuple(multi[:nl]), tuple(multi[nl:])
        return self.left[il] * self.right[ir]

    def to_dense(self) -> torch.Tensor:
        """Materialize as one outer product
        (cf. makeDenseTensor tensor_kronecker_product.hpp:104-116)."""
        dtype = self.dtype
        return torch.tensordot(self.left.to(dtype), self.right.to(dtype), dims=0)


def tensor_kronecker_product(left, right, device=None) -> TensorKroneckerProduct:
    """Factory (cf. tensorKroneckerProduct tensor_kronecker_product.hpp:119-129)."""
    return TensorKroneckerProduct(left, right, device)
