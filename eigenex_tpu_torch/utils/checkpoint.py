"""Checkpoint / resume of solver state.

Counterpart of ``eigenex_tpu/utils/checkpoint.py``, in its ``.npz``
format.  The reference's resume feature is in-memory only
(``continueToCompute``, lanczos.hpp:696-712); here the solver state is an
explicit dataclass (:class:`~eigenex_tpu_torch.solvers.lanczos.LanczosState`
/ :class:`~eigenex_tpu_torch.solvers.arnoldi.ArnoldiState`), so persistence
across process restarts is a flat ``np.savez`` round trip, and
``continue_to_compute`` on the restored state picks up where the saved run
stopped.  The files are those of the JAX package field for field (the step
count ``k`` is written as its int32), so a state saved by either package
loads in the other.  ``load_state(mesh=)`` and :func:`shard_state` (the
distributed layout) are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.exceptions import EigenexError, not_ported

__all__ = ["save_state", "load_state", "shard_state", "state_to_dict", "state_from_dict"]


def state_to_dict(state) -> dict:
    """Flatten a solver-state dataclass into {field: np.ndarray} (host
    copies; ``k`` as int32, the JAX package's dtype)."""
    if not dataclasses.is_dataclass(state):
        raise EigenexError(f"not a solver state: {type(state)}")
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        out[f.name] = a.astype(np.int32) if f.name == "k" else a
    return out


def state_from_dict(cls, d: dict, device=None):
    """The state ``cls`` from :func:`state_to_dict`'s arrays, on ``device``
    (the card unless told otherwise); see
    :func:`eigenex_tpu_torch.convert.state_from_numpy`."""
    from ..convert import state_from_numpy

    return state_from_numpy(cls, d, device=device)


def save_state(path: str, state) -> None:
    """Serialize a solver state (LanczosState/ArnoldiState) to ``path``."""
    d = state_to_dict(state)
    d["__class__"] = np.array(type(state).__name__)
    np.savez(path, **d)


def load_state(path: str, *, mesh=None, axis_name: str | None = None, device=None):
    """Restore a solver state saved by :func:`save_state` of either package,
    on ``device`` (the card unless told otherwise).  ``mesh=`` (the
    distributed layout) is not ported yet."""
    if mesh is not None:
        raise not_ported("load_state(mesh=) (the distributed state layout)")
    with np.load(path, allow_pickle=False) as z:
        name = str(z["__class__"])
        arrays = {k: z[k] for k in z.files if k != "__class__"}
    return state_from_dict(name, arrays, device=device)


def shard_state(state, mesh, *, axis_name: str | None = None):
    """Place a solver state onto a device mesh in the distributed drivers'
    layout -- not ported yet."""
    raise not_ported("shard_state (the distributed state layout)")
