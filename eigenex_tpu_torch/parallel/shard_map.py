"""``shard_map`` and the mesh collectives: N shards, one process or several.

Counterpart of ``jax.shard_map`` with ``lax.psum``, ``lax.all_gather``,
``lax.psum_scatter`` and ``lax.ppermute``, which the JAX package's
distributed layer is written in.  The JAX package is single-controller
within a process: one process owns every local device, ``shard_map`` runs
one body per shard, and a body's collectives name a mesh axis.  The port
keeps that model instead of one process per device over
``torch.distributed``, because NCCL refuses two ranks on one GPU: a port of
one process a device could only ever run at world size 1 on a machine with
one card, and its halo, column-split and grid exchanges would never reach
the card.  Here a mesh
may name one device several times (``["cuda:0"] * 4``), and every shard
runs its body.

- :func:`shard_map` splits each global tensor argument by its spec
  (:class:`P`) into per-shard pieces on each shard's device, runs ``body``
  once per shard -- **one worker thread per shard, each on its own CUDA
  stream** -- and reassembles the outputs.  A replicated output is the
  first local shard's (``check=True`` asserts that every local shard agrees).  An argument that
  is already a :class:`Sharded` passes its pieces through untouched, and
  ``gather=False`` keeps sharded outputs as :class:`Sharded`, so a basis
  stays in per-shard panels between two calls; operator pieces are placed
  once (:class:`Sharded` of containers) and never re-placed per call.
- ``body(comm, *local_args)`` gets a :class:`ShardComm`: ``comm.psum``,
  ``all_gather``, ``psum_scatter`` and ``ppermute`` along a named axis (or
  a tuple of axes), and ``comm.along(axis)`` binds one axis for the
  solver bodies that take ``comm=``.
- **One result a collective.** The last shard to reach a collective
  computes every shard's result, once, on its own device, and moves each
  to its shard's device (a copy only where the devices differ; no mesh of
  several cards has been run yet).  A reduction adds the shards' terms in
  shard order 0..N-1, so results are bit-reproducible and replicated
  values agree bit for bit.
- **Turns.** The shard threads take turns between collectives (one runs
  Python at a time, as the GIL would have it anyway, without the threads
  fighting over it); the kernels each shard launched run on concurrently.
- **No hang.** Every wait at a collective has a timeout.  A shard that
  raises wakes the others, they stop at their next collective, and the
  caller re-raises the first error; a shard that never reaches a
  collective makes the others time out, and the caller raises after
  waiting ``timeout`` seconds more.
- **Streams.** Each worker waits on an event recorded on the caller's
  stream before it starts, and the caller's stream waits on each worker's
  last event before the outputs are used.  A tensor handed from one shard
  to another inside a collective is published with an event recorded on
  its producer's stream; the consumer waits on that event and records its
  own stream on the tensor for the caching allocator.

**A mesh across processes** (:func:`~eigenex_tpu_torch.parallel.mesh.make_mesh`
after :func:`~eigenex_tpu_torch.parallel.mesh.initialize_multihost`): each
process runs its own shards as above; their collectives still take turns.
The last local shard to arrive exchanges the terms of all local shards with
the other processes in one all-gather of the mesh's process group (bytes,
so every dtype crosses bit for bit; through pinned host memory on gloo),
and combines all N terms in global shard order, as one process does.  So
replicated results are bit-equal across processes and to a one-process
mesh of the same shard count.  A :class:`Sharded` holds only the local
pieces (None for another process's shards); ``gather``, ``combine`` and a
``shard_map`` split output with ``gather=True`` all-gather across processes
and are collectives of every process, which the drivers use for the Ritz
vectors and the mesh operators' products, never for a basis.  A failing
or stuck process makes the others raise within the process group's
timeout (``initialize_multihost(timeout=)``, 600 s by default) or as soon
as its connection closes.

Worker threads never touch the process-wide f32 matmul precision: the
front ends pin it once around the whole call
(:func:`~eigenex_tpu_torch.utils.precision.highest_f32_matmul`).  Python
work of the N bodies is serialised by the GIL; the tensor work is not.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..utils.exceptions import EigenexError
from .mesh import COLLECTIVE_TIMEOUT, Mesh

__all__ = ["P", "Sharded", "ShardComm", "AxisComm", "shard_map", "DEFAULT_TIMEOUT"]

#: seconds a shard waits at a collective for the others
DEFAULT_TIMEOUT = COLLECTIVE_TIMEOUT


class P(tuple):
    """A partition spec (the port's ``jax.sharding.PartitionSpec``): one
    entry per leading tensor dimension -- ``None`` (not split), an axis
    name, or a tuple of axis names (split over their product, the first
    axis major).  ``P()`` is replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple(self)!r}"


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _split_dim(spec: P) -> tuple[int, tuple] | None:
    """(tensor dim, mesh axes) of the one split dimension of ``spec``, or
    None for a replicated spec."""
    found = [(d, _axes_of(e)) for d, e in enumerate(spec) if e is not None]
    if not found:
        return None
    if len(found) > 1:
        raise EigenexError(f"shard_map: spec {spec!r} splits more than one dimension")
    return found[0]


class _Layout:
    """Index arithmetic of one mesh: shard s <-> coordinates, groups along axes."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.names = mesh.axis_names
        self.dims = tuple(mesh.devices.shape)
        self.coords = [np.unravel_index(s, self.dims) for s in range(mesh.size)]
        self._groups: dict = {}

    def _check(self, axes):
        for a in axes:
            if a not in self.names:
                raise EigenexError(f"unknown mesh axis {a!r}; the mesh has {self.names}")

    def index(self, shard: int, axes) -> int:
        """Mixed-radix index of ``shard`` over ``axes`` (first axis major)."""
        idx = 0
        for a in axes:
            i = self.names.index(a)
            idx = idx * self.dims[i] + int(self.coords[shard][i])
        return idx

    def size(self, axes) -> int:
        return int(np.prod([self.dims[self.names.index(a)] for a in axes], dtype=np.int64))

    def group(self, shard: int, axes) -> list[int]:
        """The shards that differ from ``shard`` only along ``axes``, in
        group order."""
        key = (shard, axes)
        found = self._groups.get(key)
        if found is None:
            self._check(axes)
            fixed = [i for i, a in enumerate(self.names) if a not in axes]
            members = [s for s in range(self.mesh.size)
                       if all(self.coords[s][i] == self.coords[shard][i] for i in fixed)]
            found = self._groups[key] = sorted(members, key=lambda s: self.index(s, axes))
        return found


class Sharded:
    """A value split over a mesh: one piece per shard (shard order), the
    global ``shape`` and the ``spec`` that split it.  Pieces may be tensors
    or any per-shard object (the placed operator containers); on a mesh
    across processes another process's pieces are None.  Row indexing of a
    tensor split along dim 1 (``V[k]``, ``V[:k]``) gives the pieces' views,
    as a basis held in per-shard column panels needs."""

    def __init__(self, pieces: Sequence, spec: P, mesh: Mesh, shape=None):
        self.pieces = list(pieces)
        self.spec = P(*spec)
        self.mesh = mesh
        self.shape = tuple(shape) if shape is not None else None

    @property
    def local_pieces(self) -> list:
        """This process's pieces, in shard order."""
        return [self.pieces[s] for s in self.mesh.local_shards]

    # -- tensor-like surface of a split tensor ---------------------------
    @property
    def dtype(self):
        return self.local_pieces[0].dtype

    @property
    def device(self):
        return self.local_pieces[0].device

    def is_complex(self) -> bool:
        return self.local_pieces[0].is_complex()

    def _split(self):
        return _split_dim(self.spec)

    def _each(self, fn) -> list:
        return [None if p is None else fn(s, p) for s, p in enumerate(self.pieces)]

    def __getitem__(self, idx):
        dim, axes = self._split()
        if dim == 0:
            raise EigenexError("Sharded: indexing along the split dimension is not supported")
        out = self._each(lambda s, p: p[idx])
        drops = 1 if isinstance(idx, int) else 0
        spec = list(self.spec)[drops:] if drops else list(self.spec)
        shape = None
        if self.shape is not None:
            ref = torch.empty(self.shape[:dim], device="meta")[idx]
            shape = tuple(ref.shape) + tuple(self.shape[dim:])
        return Sharded(out, P(*spec), self.mesh, shape)

    def clone(self) -> "Sharded":
        return Sharded(self._each(lambda s, p: p.clone()), self.spec, self.mesh, self.shape)

    def map(self, fn: Callable, *others: "Sharded") -> "Sharded":
        """``fn(piece, *other pieces)`` on every local shard, same spec."""
        outs = self._each(lambda s, p: fn(p, *(o.pieces[s] for o in others)))
        return Sharded(outs, self.spec, self.mesh, None)

    def combine(self, fn: Callable, dim: int | None = None) -> torch.Tensor:
        """``fn(piece)`` on each piece, joined along ``dim`` (default: the
        split dimension) into one tensor on the mesh's first local device;
        across processes a collective of every process."""
        split_dim, axes = self._split()
        return _join(self._each(lambda s, p: fn(p)), self.mesh,
                     split_dim if dim is None else dim, axes)

    def gather(self) -> torch.Tensor:
        """The global tensor on the mesh's first local device (across
        processes a collective of every process)."""
        return self.combine(lambda p: p)


def _join(pieces: list, mesh: Mesh, dim: int, axes) -> torch.Tensor:
    """Concatenate one piece per index along ``axes`` (the first shard
    holding each index) on the mesh's first local device, all-gathering
    the pieces of other processes."""
    lay = _Layout(mesh)
    dev0 = mesh.first_device
    if mesh.multiprocess:
        local = [pieces[s] for s in mesh.local_shards]
        local = [p if p.device == dev0 else p.to(dev0) for p in local]
        pieces = across_processes(mesh, local, dev0)
    first = {}
    for s in range(mesh.size):
        first.setdefault(lay.index(s, axes), s)
    parts = [pieces[first[i]] for i in range(lay.size(axes))]
    parts = [p if p.device == dev0 else p.to(dev0) for p in parts]
    return torch.cat(parts, dim=dim)


# ---------------------------------------------------------------------------
# the exchange across processes
# ---------------------------------------------------------------------------
def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous().reshape(-1)
    if t.is_complex():
        t = torch.view_as_real(t).reshape(-1)
    return t.view(torch.uint8)


def _from_bytes(b: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.is_complex():
        real = torch.empty((), dtype=like.dtype).real.dtype
        return torch.view_as_complex(b.view(real).reshape(tuple(like.shape) + (2,)))
    return b.view(like.dtype).reshape(like.shape)


def across_processes(mesh: Mesh, local: list, device) -> list:
    """Every shard's tensor, in shard order, from this process's tensors of
    its local shards (``local``, in shard order, of one shape and dtype on
    ``device``): one all-gather of the mesh's process group.  A process's
    own tensors are returned as given; the others' arrive on ``device``.
    On gloo a CUDA term is staged through pinned host memory."""
    import torch.distributed as dist

    owners = mesh.processes.reshape(-1)
    world = mesh.process_count
    per_process = [int(np.sum(owners == p)) for p in range(world)]
    rows = max(per_process)
    like = local[0]
    if any(t.shape != like.shape or t.dtype != like.dtype for t in local):
        raise EigenexError("a collective across processes needs terms of one shape and dtype")
    buf = torch.stack([_as_bytes(t) for t in local])
    if buf.shape[0] < rows:
        buf = torch.cat([buf, buf.new_zeros((rows - buf.shape[0], buf.shape[1]))])
    if mesh.backend == "nccl":
        out = buf.new_empty((world,) + tuple(buf.shape))
        dist.all_gather_into_tensor(out, buf, group=mesh.group)
        got = list(out)
    else:
        if buf.device.type == "cuda":
            host = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(buf)
        else:
            host = buf.cpu()
        parts = [torch.empty_like(host) for _ in range(world)]
        dist.all_gather(parts, host, group=mesh.group)
        got = [p.to(device, non_blocking=True) if p.device != device else p for p in parts]
    seen = [0] * world
    out_list = []
    mine = iter(local)
    for s in range(mesh.size):
        p = int(owners[s])
        j = seen[p]
        seen[p] += 1
        out_list.append(next(mine) if p == mesh.process_index else _from_bytes(got[p][j], like))
    return out_list


def _place(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned on ``device`` (the kernels'
    requirement); a view that already is stays a view."""
    if t.device != device:
        return t.to(device).contiguous()
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def split_tensor(x: torch.Tensor, spec: P, mesh: Mesh, *, place: bool = False) -> Sharded:
    """``x`` split by ``spec`` into per-shard pieces on each local shard's
    device (views on a shard that shares ``x``'s device; ``place=True``
    makes every piece contiguous and aligned; None for another process's
    shards)."""
    lay = _Layout(mesh)
    split = _split_dim(spec)
    pieces = []
    cache: dict = {}
    for s, dev in enumerate(mesh.flat_devices):
        if not mesh.is_local(s):
            pieces.append(None)
            continue
        if split is None:
            key = (None, dev)
            if key not in cache:
                cache[key] = x if x.device == dev else x.to(dev)
            pieces.append(cache[key])
            continue
        dim, axes = split
        lay._check(axes)
        parts = lay.size(axes)
        if x.shape[dim] % parts:
            raise EigenexError(
                f"shard_map: dimension {dim} of size {x.shape[dim]} does not split "
                f"into {parts} shards"
            )
        size = x.shape[dim] // parts
        i = lay.index(s, axes)
        key = (i, dev)
        if key not in cache:
            piece = x.narrow(dim, i * size, size)
            cache[key] = _place(piece, dev) if place or piece.device != dev else piece
        pieces.append(cache[key])
    return Sharded(pieces, spec, mesh, tuple(x.shape))


# ---------------------------------------------------------------------------
# the rendezvous of one shard_map call
# ---------------------------------------------------------------------------
class _Rendezvous:
    """The local shards of one call take turns: the first runs until its
    first collective, hands the turn to the second, and so on; the last to
    arrive completes the exchange and hands the turn back to the first.  So
    one shard thread runs Python at a time -- the GIL would serialise them
    anyway, and taking turns saves the threads from fighting over it --
    while the kernels each shard launched keep running on its own stream.
    Every wait for the turn has the timeout.  Two slot buffers are used in
    turn: a shard publishes for collective j+1 only after every shard has
    read j.

    The last shard to arrive computes the collective for all of them
    (``combine``, over every shard of the mesh in shard order) on its own
    device; on a mesh across processes it first gathers the other
    processes' terms (:func:`across_processes`).  A reduction is added
    once, in shard order, and each local shard's result is moved to that
    shard's device (a copy only where the devices differ).  Results of a
    collective are shared, and so are read-only for the bodies.  ``pos``
    below is a shard's position among the local shards."""

    def __init__(self, mesh: Mesh, timeout: float):
        self.mesh = mesh
        self.local = list(mesh.local_shards)
        self.n = n = len(self.local)
        self.devices = devices = [mesh.flat_devices[s] for s in self.local]
        self.timeout = timeout
        self.turns = [threading.Lock() for _ in range(n)]
        for lock in self.turns[1:]:
            lock.acquire()  # the first local shard holds the first turn
        self.slots = [[None] * n, [None] * n]
        self.results = [None, None]
        self.seq = [0] * n
        self.aborted = False
        cuda = devices[0].type == "cuda"
        # an event a shard and slot buffer, re-recorded two collectives later,
        # when every consumer has waited on it; one more a buffer for results
        self.events = [[torch.cuda.Event(), torch.cuda.Event()] for _ in range(n)] if cuda else None
        self.result_events = [torch.cuda.Event(), torch.cuda.Event()] if cuda else None

    def wait_turn(self, pos: int):
        if not self.turns[pos].acquire(timeout=self.timeout) or self.aborted:
            self.abort()
            raise _Aborted()

    @staticmethod
    def _release(lock):
        try:
            lock.release()
        except RuntimeError:  # already released by an abort
            pass

    def pass_turn(self, pos: int):
        if pos + 1 < self.n:
            self._release(self.turns[pos + 1])

    def exchange(self, pos: int, value, combine, stream=None):
        """Publish ``value`` and return this shard's entry of
        ``combine(values)``, computed once by the last shard to arrive."""
        if self.aborted:
            raise _Aborted()
        j = self.seq[pos]
        self.seq[pos] = j + 1
        buf = self.slots[j % 2]
        event = None
        if stream is not None and isinstance(value, torch.Tensor):
            event = self.events[pos][j % 2]
            event.record(stream)
        buf[pos] = (value, event)
        if pos == self.n - 1:
            # the round is complete: compute every shard's result, once
            dev = self.devices[pos]
            values = [_receive(item, stream, q == pos, dev) for q, item in enumerate(buf)]
            if self.mesh.multiprocess:
                values = across_processes(self.mesh, values, dev)
            results = combine(values)
            self.results[j % 2] = [results[s] if results[s].device == d
                                   else results[s].to(d, non_blocking=True)
                                   for s, d in zip(self.local, self.devices)]
            if stream is not None:
                self.result_events[j % 2].record(stream)
        # the last shard to arrive starts the next round at the first
        self._release(self.turns[(pos + 1) % self.n])
        self.wait_turn(pos)
        out = self.results[j % 2][pos]
        if stream is not None and pos != self.n - 1:
            stream.wait_event(self.result_events[j % 2])
            out.record_stream(stream)
        return out

    def abort(self):
        """Wake every shard; each raises at its next wait for the turn."""
        self.aborted = True
        for lock in self.turns:
            if lock.locked():
                self._release(lock)


class _Aborted(Exception):
    """A collective was abandoned because another shard failed or timed out."""


def _receive(item, stream, own: bool, device) -> torch.Tensor:
    """Another shard's tensor, usable on ``stream`` (None on the CPU) on
    ``device``: wait for the event its producer recorded, tell the caching
    allocator that this stream reads it, and copy it over when it lives on
    another device."""
    t, ev = item
    if ev is not None and not own:
        stream.wait_event(ev)
        t.record_stream(stream)
    return t if t.device == device else t.to(device, non_blocking=True)


def _add_in_order(terms):
    acc = terms[0].clone()
    for t in terms[1:]:
        acc += t
    return acc


class AxisComm:
    """The collectives of one shard along one mesh axis (or a tuple of
    axes): what the solver bodies take as ``comm=``."""

    def __init__(self, comm: "ShardComm", axes):
        self._comm = comm
        self.axes = _axes_of(axes)
        self.index = comm.axis_index(self.axes)
        self.size = comm.axis_size(self.axes)

    def psum(self, x):
        return self._comm.psum(x, self.axes)

    def all_gather(self, x, *, tiled: bool = True):
        return self._comm.all_gather(x, self.axes, tiled=tiled)

    def psum_scatter(self, x, *, scatter_dimension: int = 0, tiled: bool = True):
        return self._comm.psum_scatter(x, self.axes, scatter_dimension=scatter_dimension,
                                       tiled=tiled)

    def ppermute(self, x, perm):
        return self._comm.ppermute(x, self.axes, perm)

    def shift(self, x, step: int):
        """``ppermute`` by ``step`` around the ring: shard i's ``x`` goes to
        shard (i + step) mod size."""
        n = self.size
        return self.ppermute(x, [(i, (i + step) % n) for i in range(n)])


class ShardComm:
    """One shard's handle on the mesh inside :func:`shard_map`.  The results
    of its collectives may be shared with other shards: read them, do not
    write into them."""

    def __init__(self, shard: int, layout: _Layout, rdv: _Rendezvous, device, stream=None):
        self.shard = shard
        self._pos = rdv.local.index(shard)
        self._lay = layout
        self._rdv = rdv
        self.device = device
        self._stream = stream  # this shard's CUDA stream (None on the CPU)

    @property
    def mesh(self) -> Mesh:
        return self._lay.mesh

    def axis_index(self, axes) -> int:
        axes = _axes_of(axes)
        self._lay._check(axes)
        return self._lay.index(self.shard, axes)

    def axis_size(self, axes) -> int:
        axes = _axes_of(axes)
        self._lay._check(axes)
        return self._lay.size(axes)

    def along(self, axes) -> AxisComm:
        return AxisComm(self, axes)

    def _collective(self, x, axes, per_group):
        """``per_group(terms)``: the results of a group's members (in group
        order) from their terms; the last shard to arrive computes every
        group's results, once."""
        axes = _axes_of(axes)
        lay = self._lay
        n = lay.mesh.size

        def combine(values):
            out = [None] * n
            for s in range(n):
                if out[s] is None:
                    group = lay.group(s, axes)
                    for g, result in zip(group, per_group([values[g] for g in group])):
                        out[g] = result
            return out

        return self._rdv.exchange(self._pos, x, combine, self._stream)

    def psum(self, x, axes):
        return self._collective(x, axes, lambda terms: [_add_in_order(terms)] * len(terms))

    def all_gather(self, x, axes, *, tiled: bool = True):
        def gathered(terms):
            out = torch.cat(terms, dim=0) if tiled else torch.stack(terms, dim=0)
            return [out] * len(terms)

        return self._collective(x, axes, gathered)

    def psum_scatter(self, x, axes, *, scatter_dimension: int = 0, tiled: bool = True):
        if scatter_dimension != 0:
            raise EigenexError("psum_scatter: only scatter_dimension=0 is supported")
        n = self.axis_size(axes)
        if tiled and x.shape[0] % n:
            raise EigenexError(
                f"psum_scatter: dimension of size {x.shape[0]} does not split into {n}"
            )

        def parts(terms):  # each member's slice of the group's sum
            total = _add_in_order(terms)
            if not tiled:
                return [total[i] for i in range(len(terms))]
            size = total.shape[0] // len(terms)
            return [total.narrow(0, i * size, size) for i in range(len(terms))]

        return self._collective(x, axes, parts)

    def ppermute(self, x, axes, perm):
        axes = _axes_of(axes)
        n = self.axis_size(axes)
        source = {dst: src for src, dst in perm}
        if len(source) != len(perm) or any(not 0 <= v < n for pair in perm for v in pair):
            raise EigenexError(f"ppermute: {perm} is not a permutation of {n} shards")

        def received(terms):
            return [terms[source[i]] if i in source else torch.zeros_like(terms[i])
                    for i in range(len(terms))]

        return self._collective(x, axes, received)


# ---------------------------------------------------------------------------
# the worker pool: one thread a shard, each with its own stream per device
# ---------------------------------------------------------------------------
class _Worker:
    def __init__(self):
        self.tasks: queue.Queue = queue.Queue()
        self.streams: dict = {}
        self.busy = False
        self.thread = threading.Thread(target=self._loop, daemon=True,
                                       name="eigenex-shard")
        self.thread.start()

    def stream(self, device: torch.device):
        s = self.streams.get(device)
        if s is None:
            s = self.streams[device] = torch.cuda.Stream(device)
        return s

    def _loop(self):
        while True:
            fn, done = self.tasks.get()
            try:
                out = (True, fn(self))
            except BaseException as e:  # handed to the caller
                out = (False, e)
            # an idle worker holds nothing of its last task (its operands,
            # its collectives' terms) once the caller has the result
            del fn
            done.put(out)
            del done, out


_POOL: list[_Worker] = []
_POOL_LOCK = threading.Lock()
_IN_WORKER = threading.local()


def _workers(n: int) -> list[_Worker]:
    """``n`` idle workers, marked busy; a worker left busy by a shard that
    never returned is dropped from the pool."""
    with _POOL_LOCK:
        _POOL[:] = [w for w in _POOL if not w.busy]
        while len(_POOL) < n:
            _POOL.append(_Worker())
        chosen = _POOL[:n]
        for w in chosen:
            w.busy = True
        return chosen


def _run_shards(mesh: Mesh, task: Callable[[int, "ShardComm"], Any], timeout: float) -> list:
    """``task(shard, comm)`` on every local shard, one worker thread each;
    the results in shard order (None for another process's shards), or the
    first error re-raised."""
    if getattr(_IN_WORKER, "active", False):
        raise EigenexError("shard_map cannot be called from inside a shard body")
    lay = _Layout(mesh)
    rdv = _Rendezvous(mesh, timeout)
    local = rdv.local
    n = len(local)
    devices = rdv.devices
    # intra-op threads are a per-thread setting: the shard threads take the
    # caller's, so that N shards do not each start a full pool
    intra_op = torch.get_num_threads()
    start = {}
    for dev in set(devices):
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            start[dev] = ev

    def make(pos: int):
        dev = devices[pos]
        s = local[pos]

        def fn(worker: _Worker):
            _IN_WORKER.active = True
            try:
                if torch.get_num_threads() != intra_op:
                    torch.set_num_threads(intra_op)
                rdv.wait_turn(pos)
                if dev.type == "cuda":
                    stream = worker.stream(dev)
                    comm = ShardComm(s, lay, rdv, dev, stream)
                    stream.wait_event(start[dev])
                    with torch.cuda.device(dev), torch.cuda.stream(stream), torch.no_grad():
                        out = task(s, comm)
                    done = torch.cuda.Event()
                    done.record(stream)
                    out = (out, done)
                else:
                    comm = ShardComm(s, lay, rdv, dev)
                    with torch.no_grad():
                        out = (task(s, comm), None)
                rdv.pass_turn(pos)
                return out
            except BaseException:
                rdv.abort()
                raise
            finally:
                _IN_WORKER.active = False

        return fn

    workers = _workers(n)
    boxes = []
    for s, w in enumerate(workers):
        box: queue.Queue = queue.Queue()
        w.tasks.put((make(s), box))
        boxes.append(box)
    results: list = [None] * n
    errors: list = [None] * n
    deadline = None
    for s, box in enumerate(boxes):
        while True:
            wait = 1.0 if deadline is None else max(deadline - time.monotonic(), 0.0)
            try:
                ok, val = box.get(timeout=wait)
            except queue.Empty:
                if deadline is not None and time.monotonic() >= deadline:
                    break  # the shard is stuck: leave its worker out of the pool
                if deadline is None and any(e is not None for e in errors):
                    deadline = time.monotonic() + timeout
                continue
            workers[s].busy = False
            if ok:
                results[s] = val
            else:
                errors[s] = val
                if deadline is None:
                    deadline = time.monotonic() + timeout
            break
    real = [e for e in errors if e is not None and not isinstance(e, _Aborted)]
    if real:
        raise real[0]
    if any(e is not None for e in errors) or any(
            r is None and e is None for r, e in zip(results, errors)):
        raise EigenexError(
            f"shard_map: a collective waited more than {timeout:g} s for a shard "
            "(a shard hung or never reached it)"
        )
    outs: list = [None] * mesh.size
    for s, dev, (out, done) in zip(local, devices, results):
        if done is not None:
            torch.cuda.current_stream(dev).wait_event(done)
        outs[s] = out
    return outs


def _values_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a.cpu(), b.cpu())
    return a == b


def shard_map(body: Callable, mesh: Mesh, in_specs, out_specs, *, check: bool = False,
              gather: bool = True, timeout: float | None = None) -> Callable:
    """The port's ``jax.shard_map``: ``shard_map(body, mesh, in_specs,
    out_specs)(*args)``.

    ``body(comm, *local_args)`` runs once per shard with a
    :class:`ShardComm`.  ``in_specs``: one :class:`P` per argument (an
    argument that is a :class:`Sharded` is taken as split already; a
    non-tensor under ``P()`` is handed to every shard as is; a replicated
    tensor is copied per shard, so a body may update it in place).
    ``out_specs``: a :class:`P` for a body that returns one value, or a
    tuple of them.  ``gather=False`` returns split outputs as
    :class:`Sharded` instead of global tensors.  ``check=True`` asserts
    that replicated outputs agree on every local shard.  ``timeout``: seconds a
    collective waits (default :data:`DEFAULT_TIMEOUT`)."""
    single = isinstance(out_specs, P)
    outs_spec = (out_specs,) if single else tuple(out_specs)
    timeout = DEFAULT_TIMEOUT if timeout is None else float(timeout)

    def run(*args):
        if len(args) != len(in_specs):
            raise EigenexError(
                f"shard_map: {len(args)} arguments for {len(in_specs)} in_specs"
            )
        local = []
        for a, spec in zip(args, in_specs):
            spec = P(*spec)
            if isinstance(a, Sharded):
                if len(a.pieces) != mesh.size:
                    raise EigenexError("shard_map: a Sharded argument of another mesh")
                local.append(a.pieces)
            elif isinstance(a, torch.Tensor):
                if _split_dim(spec) is None:
                    local.append([a.to(dev, copy=True) if mesh.is_local(s) else None
                                  for s, dev in enumerate(mesh.flat_devices)])
                else:
                    local.append(split_tensor(a, spec, mesh).pieces)
            else:
                local.append([a] * mesh.size)

        def task(s, comm):
            out = body(comm, *(pieces[s] for pieces in local))
            return (out,) if single else tuple(out)

        per_shard = _run_shards(mesh, task, timeout)
        first = mesh.local_shards[0]
        results = []
        for j, spec in enumerate(outs_spec):
            spec = P(*spec)
            vals = [None if o is None else o[j] for o in per_shard]
            split = _split_dim(spec)
            if split is None:
                if check:
                    for s in mesh.local_shards[1:]:
                        if not _values_equal(vals[first], vals[s]):
                            raise EigenexError(
                                f"shard_map: replicated output {j} differs on shard {s}"
                            )
                results.append(vals[first])
            elif gather:
                results.append(_join(vals, mesh, *split))
            else:
                shape = None
                if all(isinstance(vals[s], torch.Tensor) for s in mesh.local_shards):
                    dim, axes = split
                    shape = list(vals[first].shape)
                    shape[dim] *= _Layout(mesh).size(axes)
                results.append(Sharded(vals, spec, mesh, shape))
        return results[0] if single else tuple(results)

    return run
