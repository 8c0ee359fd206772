"""Sparse-triplet operators and Givens rotations applied to matrices.

Counterpart of ``eigenex_tpu/ops/rotations.py``: the reference's
triplet-application helpers ``operate_triplets`` (apply a triplet list
as a matrix from the left or right, util.hpp:516-566) and
``rotate_from_left`` / ``rotate_from_right`` (Givens rotations,
util.hpp:568-626, implementing the documented intent), and the
row/col/coefficient shuffles ``rowwiseShuffle``/``colwiseShuffle``/
``cwiseShuffle`` (util.hpp:655-709) as index gathers.

Triplets and permutations join the device of the matrix they act on.
Every function returns a new tensor and leaves its input as it was.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import as_device_tensor, resolve_device
from ..utils.exceptions import EigenexError
from ..utils.tolerance import as_torch_dtype

__all__ = [
    "operate_triplets_left",
    "operate_triplets_right",
    "givens_rotation_triplets",
    "rotate_from_left",
    "rotate_from_right",
    "rowwise_shuffle",
    "colwise_shuffle",
    "cwise_shuffle",
]


def _triplets_on(rows, cols, vals, device):
    return (as_device_tensor(rows, device).long(), as_device_tensor(cols, device).long(),
            as_device_tensor(vals, device))


def operate_triplets_left(rows, cols, vals, M, out_rows: int | None = None, device=None):
    """``T @ M`` where T is given as COO triplets
    (cf. operate_triplets util.hpp:516-540)."""
    M = as_device_tensor(M, device)
    rows, cols, vals = _triplets_on(rows, cols, vals, M.device)
    if out_rows is None:
        out_rows = M.shape[0]
    contrib = vals[:, None] * M[cols]
    out = torch.zeros((out_rows, M.shape[1]), dtype=contrib.dtype, device=M.device)
    return out.index_add_(0, rows, contrib)


def operate_triplets_right(rows, cols, vals, M, out_cols: int | None = None, device=None):
    """``M @ T`` with T as COO triplets (cf. util.hpp:542-566)."""
    M = as_device_tensor(M, device)
    rows, cols, vals = _triplets_on(rows, cols, vals, M.device)
    if out_cols is None:
        out_cols = M.shape[1]
    contrib = vals[None, :] * M[:, rows]
    out = torch.zeros((M.shape[0], out_cols), dtype=contrib.dtype, device=M.device)
    return out.index_add_(1, cols, contrib)


def givens_rotation_triplets(n: int, i: int, j: int, theta: float, dtype=torch.float64,
                             device=None):
    """Triplets of the n x n Givens rotation G(i, j, theta): identity except
    G[i,i]=G[j,j]=cos, G[i,j]=sin, G[j,i]=-sin (the rotation the
    reference builds at util.hpp:568-581), on ``device`` (the card unless
    told otherwise)."""
    if i == j:
        raise EigenexError("Givens rotation requires distinct axes")
    c, s = float(np.cos(theta)), float(np.sin(theta))
    rows, cols, vals = [], [], []
    for k in range(n):
        if k not in (i, j):
            rows.append(k)
            cols.append(k)
            vals.append(1.0)
    rows += [i, j, i, j]
    cols += [i, j, j, i]
    vals += [c, c, s, -s]
    device = resolve_device(device)
    return (
        torch.tensor(rows, dtype=torch.int32, device=device),
        torch.tensor(cols, dtype=torch.int32, device=device),
        torch.tensor(vals, dtype=as_torch_dtype(dtype), device=device),
    )


def rotate_from_left(M, i: int, j: int, theta: float, device=None):
    """G(i,j,theta) @ M -- rotate rows i,j (cf. rotate_from_left util.hpp:568-579).
    Applied directly to the two affected rows (O(n), not O(n^2))."""
    M = as_device_tensor(M, device)
    c, s = float(np.cos(theta)), float(np.sin(theta))
    ri, rj = M[i], M[j]
    out = M.clone()
    out[i] = c * ri + s * rj
    out[j] = -s * ri + c * rj
    return out


def rotate_from_right(M, i: int, j: int, theta: float, device=None):
    """M @ G(i,j,theta)^T-style column rotation (cf. rotate_from_right
    util.hpp:581-626, implementing the documented intent)."""
    M = as_device_tensor(M, device)
    c, s = float(np.cos(theta)), float(np.sin(theta))
    ci, cj = M[:, i], M[:, j]
    out = M.clone()
    out[:, i] = c * ci + s * cj
    out[:, j] = -s * ci + c * cj
    return out


def rowwise_shuffle(M, perm, device=None):
    """Reorder rows (cf. rowwiseShuffle util.hpp:655-675)."""
    M = as_device_tensor(M, device)
    return M[as_device_tensor(perm, M.device).long(), :]


def colwise_shuffle(M, perm, device=None):
    """Reorder columns (cf. colwiseShuffle util.hpp:677-686, implementing
    the documented intent)."""
    M = as_device_tensor(M, device)
    return M[:, as_device_tensor(perm, M.device).long()]


def cwise_shuffle(v, perm, device=None):
    """Reorder vector coefficients (cf. cwiseShuffle util.hpp:688-697)."""
    v = as_device_tensor(v, device)
    return v[as_device_tensor(perm, v.device).long()]
