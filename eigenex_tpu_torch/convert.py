"""Operators and solver states carried across from the JAX package as
numpy arrays.

The containers of the two packages share their layouts, so a packed
operator moves between them as plain arrays: on the JAX side
``np.asarray(bsr.data.astype(jnp.float32))`` (numpy has no bfloat16),
here ``bsr_from_numpy(..., dtype=torch.bfloat16)`` -- lossless for an
operator that was stored in bf16.  The parity tests feed both packages
the same operator this way.  A solver state (the Krylov basis and the
small recurrence arrays that ``continue_to_compute`` resumes from) crosses
the same way: :func:`state_from_numpy`.
"""

from __future__ import annotations

import numpy as np
import torch

from .sparse.bsr import BSRMatrix
from .sparse.coo import COOMatrix
from .sparse.sym_bsr import SymBSRMatrix
from .utils.device import resolve_device
from .utils.exceptions import EigenexError
from .utils.tolerance import accumulation_dtype, as_torch_dtype

__all__ = [
    "bsr_from_numpy",
    "sym_bsr_from_numpy",
    "coo_from_numpy",
    "accelerated_from_numpy",
    "state_from_numpy",
    "to_numpy",
]


def _tensor(a, np_dtype=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor) and np_dtype is None:  # e.g. bf16 blocks read from a file
        return a.contiguous()
    a = np.ascontiguousarray(a, dtype=np_dtype)
    if not a.flags.writeable:  # e.g. a view of a jax array: torch wants its own copy
        a = a.copy()
    return torch.from_numpy(a)


def _blocks(a, dtype, device) -> torch.Tensor:
    t = _tensor(a)
    if dtype is not None:
        t = t.to(as_torch_dtype(dtype))  # cast on the host, then move
    return t.to(device)


def _index(a, device) -> torch.Tensor:
    return _tensor(a, np.int32).to(device)


def bsr_from_numpy(data, block_cols, shape, dtype=None, device=None) -> BSRMatrix:
    """BSRMatrix from ``data (nbr, kmax, bm, bn)`` and ``block_cols
    (nbr, kmax)``; ``dtype`` recasts the blocks (None keeps the array's)."""
    device = resolve_device(device)
    return BSRMatrix(
        _blocks(data, dtype, device), _index(block_cols, device),
        (int(shape[0]), int(shape[1])),
    )


def sym_bsr_from_numpy(diag, upper, upper_cols, shape, band_reach=-1, dtype=None,
                       device=None) -> SymBSRMatrix:
    """SymBSRMatrix from ``diag (nbr, b, b)``, ``upper (nbr, ku, b, b)``
    and ``upper_cols (nbr, ku)``; ``band_reach`` -1 = unknown."""
    device = resolve_device(device)
    return SymBSRMatrix(
        _blocks(diag, dtype, device), _blocks(upper, dtype, device),
        _index(upper_cols, device), (int(shape[0]), int(shape[1])), int(band_reach),
    )


def coo_from_numpy(row, col, val, shape, device=None) -> COOMatrix:
    """COOMatrix from triplet arrays (kept in the order given)."""
    device = resolve_device(device)
    return COOMatrix(
        _index(row, device), _index(col, device),
        _tensor(val).to(device),
        (int(shape[0]), int(shape[1])),
    )


def accelerated_from_numpy(meta: dict, perm, *, data=None, bcols=None, diag=None, upper=None,
                           ucols=None, rowptr=None, col=None, val=None, row_perm=None,
                           dtype=None, device=None):
    """An :class:`~eigenex_tpu_torch.sparse.accelerate.AcceleratedOperator`
    from the arrays of the JAX package's one: ``perm`` (and ``row_perm`` for
    a rectangular pack), the blocks -- ``data``/``bcols`` of a general pack
    or ``diag``/``upper``/``ucols`` of a symmetric one; ``rowptr``/``col``/
    ``val`` of this package's row-compressed storage -- and ``meta``, a
    dict with the keys of its ``save`` metadata (``orig_shape``,
    ``symmetric``, ``complexified``, ``stats``, ``shape``, ``band_reach``
    and the storage ``dtype`` name, which ``dtype`` overrides).  The kept
    host triplets of a fresh pack do not come across: the adjoint pack is
    then made from the blocks."""
    from .sparse.accelerate import AcceleratedOperator
    from .sparse.sym_csr import SymCSRMatrix

    dtype = as_torch_dtype(meta["dtype"] if dtype is None else dtype)
    shape = tuple(meta["shape"])
    device = resolve_device(device)
    if rowptr is not None:
        mat = SymCSRMatrix(torch.as_tensor(rowptr).to(device), torch.as_tensor(col).to(device),
                           torch.as_tensor(val).to(dtype).to(device), shape)
    elif diag is not None:
        mat = sym_bsr_from_numpy(diag, upper, ucols, shape, meta.get("band_reach", -1),
                                 dtype=dtype, device=device)
    else:
        mat = bsr_from_numpy(data, bcols, shape, dtype=dtype, device=device)
    return AcceleratedOperator(
        matrix=mat,
        perm=np.asarray(perm, np.int64),
        orig_shape=tuple(int(d) for d in meta["orig_shape"]),
        symmetric=bool(meta["symmetric"]),
        complexified=bool(meta["complexified"]),
        stats=dict(meta.get("stats") or {}),
        row_perm=None if row_perm is None else np.asarray(row_perm, np.int64),
    )


def state_from_numpy(cls, arrays: dict, device=None):
    """A solver state of the port from the numpy arrays of one of either
    package (``state_to_dict`` of their checkpoint modules, or the fields
    of a ``.npz`` checkpoint): ``cls`` is ``LanczosState`` or
    ``ArnoldiState``, or its name.  The step count ``k``, int32 in the JAX
    package, becomes the port's int64; a state written before the
    NaN/Inf flag ``failed`` existed gets it False.  The tensors land on
    ``device`` (the card unless told otherwise)."""
    import dataclasses

    from .solvers.arnoldi import ArnoldiState
    from .solvers.lanczos import LanczosState

    if isinstance(cls, str):
        classes = {"LanczosState": LanczosState, "ArnoldiState": ArnoldiState}
        if cls not in classes:
            raise EigenexError(f"unknown state class {cls!r} in checkpoint")
        cls = classes[cls]
    fields = [f.name for f in dataclasses.fields(cls)]
    arrays = dict(arrays)
    missing = set(fields) - set(arrays)
    if missing == {"failed"}:
        # checkpoints written before the NaN/Inf failure flag existed
        arrays["failed"] = np.zeros((), np.bool_)
        missing = set()
    if missing:
        raise EigenexError(f"checkpoint missing fields {sorted(missing)} for {cls.__name__}")
    device = resolve_device(device)
    out = {}
    for name in fields:
        t = torch.from_numpy(np.array(arrays[name], copy=True))
        out[name] = (t.to(torch.int64) if name == "k" else t).to(device)
    return cls(**out)


def _host(t: torch.Tensor) -> np.ndarray:
    # bf16/f16 blocks come back as f32 (exact): numpy has no bfloat16
    return t.detach().to(accumulation_dtype(t.dtype)).cpu().numpy()


def to_numpy(container) -> dict:
    """The arrays of a container as numpy, keyed by field name, plus
    ``shape`` (and ``band_reach`` for SymBSR) -- the arguments of the
    matching ``*_from_numpy``."""
    if isinstance(container, BSRMatrix):
        return dict(data=_host(container.data), block_cols=_host(container.block_cols),
                    shape=container.shape)
    if isinstance(container, SymBSRMatrix):
        return dict(diag=_host(container.diag_data), upper=_host(container.upper_data),
                    upper_cols=_host(container.upper_cols), shape=container.shape,
                    band_reach=container.band_reach)
    if isinstance(container, COOMatrix):
        return dict(row=_host(container.row), col=_host(container.col),
                    val=_host(container.val), shape=container.shape)
    raise TypeError(f"not a sparse container: {type(container).__name__}")
