"""Device meshes and multi-process initialisation.

Counterpart of ``eigenex_tpu/parallel/mesh.py``.  A :class:`Mesh` is the
port's ``jax.sharding.Mesh``: an n-dimensional array of ``torch.device``
with one name per axis.  A device may appear more than once, which is how
one card carries a 4- or 8-shard mesh (``make_mesh(devices=["cuda:0"] *
4)``) and how the CPU tests run a mesh (``make_mesh(devices=["cpu"] *
8)``); :mod:`~eigenex_tpu_torch.parallel.shard_map` runs one body per
shard, whatever device it names.

**A mesh across processes.**  After :func:`initialize_multihost` with more
than one process, :func:`make_mesh` is a collective of every process: the
global mesh is the all-gather, in rank order, of each process's local
devices (its CUDA devices, or the ``devices=`` it is given, as
``["cuda:0"] * 2`` or ``["cpu"] * 2``), as ``jax.devices()`` is global
after ``jax.distributed.initialize``.  The mesh records which process owns
each shard (:attr:`Mesh.processes`); a process runs and holds only its own
shards, and the last of them to reach a collective exchanges the terms of
all of them with the other processes, once a collective.

**Backend rule.**  The process group :func:`initialize_multihost` opens is
gloo: it carries the mesh's construction and every exchange that gloo
moves.  The exchanges of a global mesh then go

- over **NCCL** (a group of its own, opened by :func:`make_mesh`) when
  every shard sits on a CUDA card that no other process uses;
- over **gloo** otherwise: on the CPU, and for the shards of one card
  shared by several processes, because NCCL refuses two ranks on one GPU
  (the reason a one-process mesh runs one thread a shard).  Gloo takes no
  CUDA tensor, so the terms are staged through pinned host memory,
  explicitly, one copy each way.

The rule is decided once, from the cards' UUIDs, when the mesh is built
(:attr:`Mesh.backend`); an NCCL failure is never retried on gloo.  Only the
gloo branch has run: the machines of the port's tests have one card.
"""

from __future__ import annotations

import datetime
import socket

import numpy as np
import torch

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

#: seconds a collective of a mesh waits for the other shards and processes
COLLECTIVE_TIMEOUT = 600.0

#: set by :func:`initialize_multihost`: the process group it opened
_GROUP = {"initialized": False, "nccl": None}


class Mesh:
    """An array of devices with named axes (the port's ``jax.sharding.Mesh``).

    ``devices``: anything ``np.array`` turns into an array of devices or
    device strings; ``axis_names``: one name per array axis.  ``shape`` maps
    each axis name to its size, as the JAX mesh's does.

    A mesh across processes (built by :func:`make_mesh` after
    :func:`initialize_multihost`) also has ``processes``, the rank that owns
    each shard (same shape as ``devices``), ``process_index``, this
    process's rank, ``backend`` ("gloo" or "nccl") and ``group``, the
    process group its exchanges use.  A mesh of one process has every shard
    local."""

    def __init__(self, devices, axis_names, *, processes=None, process_index: int = 0,
                 backend: str | None = None, group=None):
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
        if processes is None:
            processes = np.full(arr.shape, int(process_index), dtype=np.int64)
        self.processes = np.asarray(processes, dtype=np.int64).reshape(arr.shape)
        self.process_index = int(process_index)
        self.backend = backend
        self.group = group
        owned = self.processes.reshape(-1)
        self.local_shards = [s for s in range(len(flat)) if owned[s] == self.process_index]
        if not self.local_shards:
            raise ValueError(f"process {self.process_index} holds no shard of the mesh")

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def flat_devices(self) -> list:
        """The devices in shard order (row-major over the axes); a shard of
        another process names that process's device."""
        return list(self.devices.reshape(-1))

    @property
    def multiprocess(self) -> bool:
        """Whether the shards belong to more than one process."""
        return len(np.unique(self.processes)) > 1

    @property
    def process_count(self) -> int:
        return len(np.unique(self.processes))

    def is_local(self, shard: int) -> bool:
        return int(self.processes.reshape(-1)[shard]) == self.process_index

    @property
    def first_device(self) -> torch.device:
        """The device of this process's first shard: where a mesh operator's
        global results and a placed state's small fields live."""
        return self.flat_devices[self.local_shards[0]]

    def reshape(self, shape, axis_names) -> "Mesh":
        """The same shards (and owners) as an array of ``shape``."""
        return Mesh(self.devices.reshape(shape), axis_names,
                    processes=self.processes.reshape(shape),
                    process_index=self.process_index, backend=self.backend, group=self.group)

    def flattened(self, axis_name: str = ROWS) -> "Mesh":
        """The same devices as a 1-D mesh over one axis."""
        return self.reshape(-1, (axis_name,))

    def _key(self):
        return (tuple(str(d) for d in self.flat_devices), self.axis_names,
                tuple(self.devices.shape), tuple(self.processes.reshape(-1).tolist()),
                self.process_index)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        procs = f", processes={self.processes.reshape(-1).tolist()}" if self.multiprocess else ""
        return f"Mesh(shape={self.shape}, devices={[str(d) for d in self.flat_devices]}{procs})"


def _local_devices(devices) -> list:
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError(
                "make_mesh: no CUDA device; pass devices= (e.g. ['cpu'] * 8) for a CPU mesh"
            )
        devices = [torch.device("cuda", i) for i in range(count)]
    return [torch.device(d) for d in devices]


def make_mesh(n_devices: int | None = None, axis_name: str = ROWS, devices=None) -> Mesh:
    """A 1-D mesh over ``n_devices`` (default: every device).

    The row axis is the SpMV analog of data parallelism: operator block
    rows, vector segments and the Krylov basis columns all shard over it.
    ``devices`` names this process's devices, repeats allowed (``["cuda:0"]
    * 4``, ``["cpu"] * 8``); without it the mesh never takes the CPU.

    After :func:`initialize_multihost` with more than one process this is a
    collective of every process, and the mesh is global: every process's
    devices in rank order, ``n_devices`` counted over all of them."""
    devices = _local_devices(devices)
    if _multiprocess():
        return _global_mesh(devices, n_devices, axis_name)
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(devices, (axis_name,))


def _multiprocess() -> bool:
    import torch.distributed as dist

    return _GROUP["initialized"] and dist.is_initialized() and dist.get_world_size() > 1


def _card_id(device: torch.device):
    """What names a CUDA card across processes (its UUID); None for the CPU."""
    if device.type != "cuda":
        return None
    index = device.index if device.index is not None else torch.cuda.current_device()
    uuid = getattr(torch.cuda.get_device_properties(index), "uuid", None)
    return str(uuid) if uuid is not None else f"{socket.gethostname()}:{index}"


def backend_for(devices: list, processes: list, cards: list) -> str:
    """The backend rule: "nccl" when every shard sits on a CUDA card that no
    other process uses, else "gloo"."""
    owners: dict = {}
    for dev, proc, card in zip(devices, processes, cards):
        if torch.device(dev).type != "cuda" or card is None:
            return "gloo"
        owners.setdefault(card, set()).add(proc)
    return "nccl" if all(len(p) == 1 for p in owners.values()) else "gloo"


def _global_mesh(local: list, n_devices, axis_name: str) -> Mesh:
    """The all-gather, in rank order, of every process's local devices."""
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    info = [None] * world
    dist.all_gather_object(info, ([str(d) for d in local], [_card_id(d) for d in local]))
    devices, processes, cards = [], [], []
    for proc, (devs, ids) in enumerate(info):
        devices += devs
        processes += [proc] * len(devs)
        cards += ids
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devices)}")
        devices, processes, cards = devices[:n_devices], processes[:n_devices], cards[:n_devices]
    if set(processes) != set(range(world)):
        raise ValueError("a mesh across processes needs a shard on every process")
    backend = backend_for(devices, processes, cards)
    group = None
    if backend == "nccl":
        if _GROUP["nccl"] is None:
            _GROUP["nccl"] = dist.new_group(backend="nccl")
        group = _GROUP["nccl"]
    return Mesh(devices, (axis_name,), processes=processes, process_index=rank,
                backend=backend, group=group)


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
    timeout: float = COLLECTIVE_TIMEOUT,
    devices=None,
):
    """Initialise the process group of a multi-process run -- a wrapper over
    ``torch.distributed.init_process_group`` (gloo; see the backend rule in
    the module head), so single-process use needs no call at all.

    The three arguments are given together or not at all (all None: the
    ``env://`` variables MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK);
    ``process_id`` must lie in ``[0, num_processes)``; a repeated call is
    rejected.  ``coordinator_address`` is ``host:port``.  ``timeout``:
    seconds a collective across processes waits before it raises.

    ``make_global_mesh=True`` additionally returns :func:`make_mesh`'s 1-D
    mesh over every process's ``devices`` (default: its CUDA devices), as
    ``jax.devices()`` is global after ``jax.distributed.initialize``."""
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
    kw = {"backend": "gloo", "timeout": datetime.timedelta(seconds=float(timeout))}
    if coordinator_address is not None:
        kw["init_method"] = f"tcp://{coordinator_address}"
        kw["world_size"] = num_processes
        kw["rank"] = process_id
    dist.init_process_group(**kw)
    _GROUP["initialized"] = True
    if make_global_mesh:
        return make_mesh(axis_name=axis_name, devices=devices)
    return None
