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
loads in the other.  ``load_state(mesh=)`` and :func:`shard_state` place a
state in the distributed drivers' layout: the basis in per-shard column
panels, the small fields on the mesh's first device (of this process, on
a mesh across processes, where each process holds its own shards' panels).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.exceptions import EigenexError

__all__ = ["save_state", "load_state", "shard_state", "state_to_dict", "state_from_dict"]


def state_to_dict(state) -> dict:
    """Flatten a solver-state dataclass into {field: np.ndarray} (host
    copies; ``k`` as int32, the JAX package's dtype)."""
    if not dataclasses.is_dataclass(state):
        raise EigenexError(f"not a solver state: {type(state)}")
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if not isinstance(v, torch.Tensor) and hasattr(v, "gather"):
            v = v.gather()  # a basis in per-shard panels (parallel.shard_map.Sharded)
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
    on ``device`` (the card unless told otherwise).

    mesh: a :class:`~eigenex_tpu_torch.parallel.mesh.Mesh` places the
    restored state for the distributed drivers (:func:`shard_state`): the
    basis ``V`` in per-shard column panels over ``axis_name`` (default: the
    mesh's first axis), the small fields on the mesh's first device, so a
    resumed mesh run never holds a whole basis per shard."""
    with np.load(path, allow_pickle=False) as z:
        name = str(z["__class__"])
        arrays = {k: z[k] for k in z.files if k != "__class__"}
    if mesh is not None:
        device = mesh.first_device
    state = state_from_dict(name, arrays, device=device)
    if mesh is None:
        return state
    return shard_state(state, mesh, axis_name=axis_name)


def shard_state(state, mesh, *, axis_name: str | None = None):
    """Place a (host or single-device) solver state onto ``mesh`` in the
    distributed drivers' layout: basis ``V`` split by columns over
    ``axis_name`` (the JAX package's ``P(None, axis)``) as per-shard
    panels, everything else on the mesh's first device."""
    from ..parallel.shard_map import P, split_tensor

    if axis_name is None:
        axis_name = mesh.axis_names[0]
    nd = mesh.shape[axis_name]
    n = state.V.shape[1]
    if n % nd:
        raise EigenexError(
            f"basis width {n} not divisible by {nd} mesh shards — the "
            "checkpoint was not written by a mesh-padded run"
        )
    dev0 = mesh.first_device
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name == "V":
            out[f.name] = split_tensor(torch.as_tensor(v), P(None, axis_name), mesh, place=True)
        else:
            out[f.name] = torch.as_tensor(v).to(dev0)
    return type(state)(**out)
