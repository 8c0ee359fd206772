"""Device meshes and multi-process initialisation.

Counterpart of ``eigenex_tpu/parallel/mesh.py``.  A :class:`Mesh` is the
port's ``jax.sharding.Mesh``: an n-dimensional array of ``torch.device``
with one name per axis.  A device may appear more than once, which is how
one card carries a 4- or 8-shard mesh (``make_mesh(devices=["cuda:0"] *
4)``) and how the CPU tests run a mesh (``make_mesh(devices=["cpu"] *
8)``); :mod:`~eigenex_tpu_torch.parallel.shard_map` runs one body per
shard, whatever device it names.

:func:`initialize_multihost` keeps the JAX package's argument contract
over ``torch.distributed.init_process_group``.  A mesh across processes
(``make_global_mesh=True`` with more than one process) is not ported yet:
the collectives of :mod:`~eigenex_tpu_torch.parallel.shard_map` join the
shards of one process.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.exceptions import not_ported

__all__ = [
    "ROWS",
    "Mesh",
    "make_mesh",
    "row_sharding",
    "replicated_sharding",
    "initialize_multihost",
]

#: canonical mesh-axis name for the row partition of operators/vectors
ROWS = "rows"


class Mesh:
    """An array of devices with named axes (the port's ``jax.sharding.Mesh``).

    ``devices``: anything ``np.array`` turns into an array of devices or
    device strings; ``axis_names``: one name per array axis.  ``shape`` maps
    each axis name to its size, as the JAX mesh's does."""

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim == 0:
            arr = arr.reshape(1)
        axis_names = tuple(axis_names)
        if len(axis_names) != arr.ndim:
            raise ValueError(
                f"mesh of {arr.ndim} dimensions needs {arr.ndim} axis names, got {axis_names}"
            )
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis name in {axis_names}")
        flat = [torch.device(d) for d in arr.reshape(-1)]
        out = np.empty(len(flat), dtype=object)
        out[:] = flat
        self.devices = out.reshape(arr.shape)
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, arr.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def flat_devices(self) -> list:
        """The devices in shard order (row-major over the axes)."""
        return list(self.devices.reshape(-1))

    def flattened(self, axis_name: str = ROWS) -> "Mesh":
        """The same devices as a 1-D mesh over one axis."""
        return Mesh(self.devices.reshape(-1), (axis_name,))

    def _key(self):
        return (tuple(str(d) for d in self.flat_devices), self.axis_names,
                tuple(self.devices.shape))

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return f"Mesh(shape={self.shape}, devices={[str(d) for d in self.flat_devices]})"


def make_mesh(n_devices: int | None = None, axis_name: str = ROWS, devices=None) -> Mesh:
    """A 1-D mesh over ``n_devices`` (default: every CUDA device).

    The row axis is the SpMV analog of data parallelism: operator block
    rows, vector segments and the Krylov basis columns all shard over it.
    ``devices`` names the devices, repeats allowed (``["cuda:0"] * 4``,
    ``["cpu"] * 8``); without it the mesh never takes the CPU."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError(
                "make_mesh: no CUDA device; pass devices= (e.g. ['cpu'] * 8) for a CPU mesh"
            )
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = list(devices)
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(devices, (axis_name,))


def row_sharding(mesh: Mesh, axis_name: str = ROWS, ndim: int = 1, axis: int = 0):
    """The placement that shards array axis ``axis`` over the mesh rows:
    a ``(mesh, spec)`` pair, the port's ``NamedSharding``."""
    from .shard_map import P

    spec = [None] * ndim
    spec[axis] = axis_name
    return mesh, P(*spec)


def replicated_sharding(mesh: Mesh):
    """The placement that replicates an array on every shard."""
    from .shard_map import P

    return mesh, P()


def initialize_multihost(
    coordinator_address=None,
    num_processes=None,
    process_id=None,
    *,
    make_global_mesh: bool = False,
    axis_name: str = ROWS,
):
    """Initialise the process group of a multi-process run -- a wrapper over
    ``torch.distributed.init_process_group`` (NCCL when CUDA is present,
    gloo otherwise), so single-process use needs no call at all.

    The three arguments are given together or not at all (all None: the
    ``env://`` variables MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK);
    ``process_id`` must lie in ``[0, num_processes)``; a repeated call is
    rejected.  ``coordinator_address`` is ``host:port``.

    ``make_global_mesh=True`` returns a 1-D mesh over the local CUDA
    devices when there is one process; a mesh over several processes is
    not ported yet."""
    import torch.distributed as dist

    given = [coordinator_address is not None, num_processes is not None,
             process_id is not None]
    if any(given) and not all(given):
        raise ValueError(
            "initialize_multihost needs coordinator_address, num_processes "
            "AND process_id together (or none of them, for environment "
            "auto-detection)"
        )
    if num_processes is not None:
        num_processes = int(num_processes)
        process_id = int(process_id)
        if num_processes <= 0:
            raise ValueError(f"num_processes must be positive, got {num_processes}")
        if not 0 <= process_id < num_processes:
            raise ValueError(
                f"process_id {process_id} outside [0, {num_processes})"
            )
    if dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is already initialized in this process -- "
            "initialize_multihost must be called exactly once, before any "
            "collective"
        )
    kw = {"backend": "nccl" if torch.cuda.is_available() else "gloo"}
    if coordinator_address is not None:
        kw["init_method"] = f"tcp://{coordinator_address}"
        kw["world_size"] = num_processes
        kw["rank"] = process_id
    dist.init_process_group(**kw)
    if make_global_mesh:
        world = num_processes if num_processes is not None else dist.get_world_size()
        if world > 1:
            raise not_ported("initialize_multihost(make_global_mesh=True) across processes")
        return make_mesh(axis_name=axis_name)
    return None
