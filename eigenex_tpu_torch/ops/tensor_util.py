"""Tensor shape/transform utilities.

Counterpart of ``eigenex_tpu/ops/tensor_util.py`` (the reference's
include/cmpt/eigen_ex/tensor_util.hpp): ``zerowiselyResized`` (slice +
zero-pad, :193-256), ``contractVectorAsDiagonal`` (:258-294) and
``transformTensorWithMatrix`` (:296-340), on torch tensors.  Each result
has the shape asked for; the tensor SVD's rank truncation pads with zeros
the same way (tensor_svd.hpp:362-402).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..utils.exceptions import EigenexError

__all__ = [
    "zerowisely_resized",
    "contract_vector_as_diagonal",
    "transform_tensor_with_matrix",
]


def zerowisely_resized(t: torch.Tensor, new_dims: Sequence[int]) -> torch.Tensor:
    """Resize a tensor to ``new_dims``: the overlapping region copied, the
    rest zero-filled (cf. zerowiselyResized tensor_util.hpp:193-256).  Any
    rank, grow and shrink mixed per axis."""
    t = torch.as_tensor(t)
    new_dims = tuple(int(d) for d in new_dims)
    if len(new_dims) != t.ndim:
        raise EigenexError(f"rank mismatch: tensor rank {t.ndim}, new dims {new_dims}")
    out = t.new_zeros(new_dims)
    overlap = tuple(slice(0, min(o, n)) for o, n in zip(t.shape, new_dims))
    out[overlap] = t[overlap]
    return out


def contract_vector_as_diagonal(t: torch.Tensor, v: torch.Tensor, axis: int) -> torch.Tensor:
    """Contract ``diag(v)`` into axis ``axis`` of ``t``: a scaling along
    that axis (cf. contractVectorAsDiagonal tensor_util.hpp:258-294)."""
    t = torch.as_tensor(t)
    v = torch.as_tensor(v, device=t.device)
    axis = axis % t.ndim
    if v.shape[0] != t.shape[axis]:
        raise EigenexError(
            f"vector length {v.shape[0]} does not match axis {axis} dim {t.shape[axis]}"
        )
    shape = [1] * t.ndim
    shape[axis] = v.shape[0]
    return t * v.reshape(shape)


def transform_tensor_with_matrix(t: torch.Tensor, m: torch.Tensor, axis: int) -> torch.Tensor:
    """Apply a matrix to one axis, keeping the axis order:
    ``out[..., i, ...] = sum_j m[i, j] t[..., j, ...]``
    (cf. transformTensorWithMatrix tensor_util.hpp:296-340)."""
    t = torch.as_tensor(t)
    m = torch.as_tensor(m, device=t.device)
    axis = axis % t.ndim
    if m.shape[1] != t.shape[axis]:
        raise EigenexError(
            f"matrix cols {m.shape[1]} do not match axis {axis} dim {t.shape[axis]}"
        )
    out = torch.tensordot(m, t, dims=([1], [axis]))  # new axis at front
    return torch.movedim(out, 0, axis)
