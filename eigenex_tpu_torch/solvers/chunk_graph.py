"""CUDA graphs of the Arnoldi chunk: the port's counterpart of ``jax.jit``.

The JAX package compiles its Arnoldi chunk once per configuration,
``_arnoldi_chunk = jax.jit(_arnoldi_chunk_body, static_argnames=...)``
(``eigenex_tpu/solvers/arnoldi.py:236-238``), and every later call with the
same static arguments runs the compiled program.  Eager PyTorch replays the
body from Python instead, about 15 kernel launches a step on the card (the
step's tail is one, :mod:`~eigenex_tpu_torch.ops.arnoldi_step`).
Here a CUDA graph of the body stands for the compiled program: one replay
launches every kernel of the chunk.

A :class:`ChunkGraphs` set lives for one solve (:func:`solve_graphs`, which
the restart loop of thick restart and Krylov-Schur,
``restart._RestartedArnoldi.compute``, and the GMRES solves open; an inner
GMRES solve joins the set of the solve around it) and is freed at its end:
its graphs, its private memory pool and the state buffers they hold.
Unlike the reference's jit cache, nothing outlives the call but the
thread's side stream, so no basis stays pinned on the card between solves.

A graph reads and writes fixed addresses, so a chunk runs on state tensors
the solver keeps for the whole solve (``restart._restart_into`` writes a
restart's kept rows into them in place).  A key is the operator, the six
state tensors, and the values the graph bakes in: ``(k_start, num_steps,
shift, breakdown_threshold, deflate)``, the reference's static arguments
plus the traced values that are constants of a solve here.  The first time a key is seen the body runs
eagerly, on a side stream (the warm-up: the kernels' per-stream
workspaces and the cuBLAS workspace of that stream are made here, never in
the graph's pool); the second time the body is captured on that stream and
the graph replayed; after that it is only replayed.  The side stream is the
calling thread's, one a device, kept from one solve to the next so that
those workspaces are made once.  Only operators that say so
(``LinearOperator.capturable``: the block containers on CUDA in a kernel
storage, and the shifted operator of a GMRES solve on one) are captured, and
only on CUDA; everything else runs the body eagerly on the same buffers.
Nothing falls back: a failed capture raises.

Each chunk runs under a span of its route (``eigenex.chunk.eager``,
``.warmup`` or ``.replay``; a capture under ``eigenex.graph.capture``, the
set's freeing under ``eigenex.graphs.close``;
:mod:`~eigenex_tpu_torch.utils.profiling`).  A replay runs no Python, so the
spans inside the body show in eager chunks, warm-ups and captures only.
The kernel wrappers count their launches at capture into a tally instead of
the global counts (:func:`~eigenex_tpu_torch.ops.cuda_spmv.launch_tally`);
each replay adds that tally, so launch counts still equal matvecs.  An
operator's ``stats`` dict of host counts (the shift-invert operators') is
treated the same way.  :func:`eager_chunks` switches graphs off for tests and
comparisons; :func:`graph_counts` counts keys, warm-ups, captures, replays,
capture time and pool bytes since :func:`reset_graph_counts`.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

from ..ops import cuda_spmv
from ..utils import profiling
from ..utils.profiling import annotate

__all__ = [
    "ChunkGraphs",
    "eager_chunks",
    "graph_counts",
    "reset_graph_counts",
    "solve_graphs",
    "state_tensors",
]

_local = threading.local()
_lock = threading.Lock()
_eager_depth = 0
_COUNTS = ("solves", "keys", "eager", "warmups", "captures", "replays", "capture_ms",
           "pool_bytes")


def graph_counts() -> dict:
    """Since the last reset: solves that opened a set, distinct keys, chunks
    run eagerly (no graph: CPU, an operator that is not capturable, or
    :func:`eager_chunks`), warm-ups, captures, replays, ms spent capturing
    and instantiating, and bytes the captures added to the reserved memory
    (the graphs' private pools): the ``graph.<name>`` counters of
    :mod:`~eigenex_tpu_torch.utils.profiling`."""
    counted = profiling.counters("graph.")
    return {name: counted.get(f"graph.{name}", 0) for name in _COUNTS}


def reset_graph_counts() -> None:
    profiling.reset_counters("graph.")


def _count(**deltas) -> None:
    for name, value in deltas.items():
        profiling.count(f"graph.{name}", value)


def current() -> "ChunkGraphs | None":
    """The set of the solve running on this thread, or None."""
    return getattr(_local, "graphs", None)


@contextlib.contextmanager
def solve_graphs():
    """The graph set of a solve: a new one, closed on exit, or the one a
    solve around this one opened on this thread.  Usable as a decorator."""
    outer = current()
    if outer is not None:
        yield outer
        return
    graphs = ChunkGraphs()
    _local.graphs = graphs
    _count(solves=1)
    try:
        yield graphs
    finally:
        _local.graphs = None
        graphs.close()


@contextlib.contextmanager
def eager_chunks():
    """Run every chunk eagerly (through the same state buffers) while the
    block is open, on every thread; the graph route comes back on exit."""
    global _eager_depth
    with _lock:
        _eager_depth += 1
    try:
        yield
    finally:
        with _lock:
            _eager_depth -= 1


def state_tensors(state) -> tuple:
    """The six tensors of an Arnoldi state, in field order."""
    return (state.V, state.H, state.k, state.breakdown, state.residue, state.failed)


def _store(state, out) -> None:
    """The chunk's new scalars written into ``state``'s tensors (V and H
    were updated in place)."""
    state.k.copy_(out.k)
    state.breakdown.copy_(out.breakdown)
    state.residue.copy_(out.residue)
    state.failed.copy_(out.failed)


def _identity(value):
    """A key part: a number as it is, anything else by identity."""
    return value if isinstance(value, (int, float, complex)) else ("id", id(value))


def _thread_stream(device) -> torch.cuda.Stream:
    """This thread's side stream on ``device``, made at its first solve and
    kept for the next ones: PyTorch keeps a cuBLAS workspace (32 MiB on
    this card) for every stream that runs a cuBLAS call, so a new stream a
    solve would add one a solve, until its pool of streams comes round."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    streams = _local.__dict__.setdefault("streams", {})
    if index not in streams:
        streams[index] = torch.cuda.Stream(index)
    return streams[index]


class _Graph:
    """One captured chunk: the graph, the launches and host counts one replay
    stands for, and what it reads and writes (kept alive with it)."""

    __slots__ = ("graph", "launches", "host_counts", "stats", "refs")

    def __init__(self, graph, launches, host_counts, stats, refs):
        self.graph, self.launches, self.host_counts = graph, launches, host_counts
        self.stats, self.refs = stats, refs

    def replay(self) -> None:
        self.graph.replay()
        cuda_spmv.count_replayed_launches(self.launches)
        if self.stats is not None:
            for name, value in self.host_counts.items():
                self.stats[name] += value


class ChunkGraphs:
    """The graphs, state buffers and memory pool of one solve, on the
    calling thread's side stream."""

    def __init__(self):
        self._graphs: dict = {}
        self._seen: set = set()
        self._buffers: dict = {}
        self._stream = None
        self._pool = None

    def buffers(self, owner, tag, make):
        """State tensors kept for the whole solve, made once by ``make()``
        for ``(owner, tag)`` (the GMRES solves' cycle states)."""
        key = (id(owner), tag)
        found = self._buffers.get(key)
        if found is None:
            found = self._buffers[key] = (owner, make())
        return found[1]

    def run(self, op, state, key: tuple, body):
        """Run the chunk ``body`` (no arguments; updates ``state.V`` and
        ``state.H`` in place and returns the new state) for ``key`` on
        ``state``'s tensors, and return ``state``."""
        full = (id(op), *(t.data_ptr() for t in state_tensors(state)),
                *(_identity(part) for part in key))
        graph = self._graphs.get(full)
        if graph is not None and not _eager_depth:
            self._replay(graph)
            return state
        first = full not in self._seen
        if first:
            self._seen.add(full)
            _count(keys=1)
        if _eager_depth or not (op.capturable and state.V.is_cuda):
            with annotate("eigenex.chunk.eager"):
                _store(state, body())
            _count(eager=1)
        elif first:
            self._warm_up(state, body)
        else:
            graph = self._graphs[full] = self._capture(op, state, body, key)
            self._replay(graph)
        return state

    @staticmethod
    def _replay(graph: _Graph) -> None:
        with annotate("eigenex.chunk.replay"):
            graph.replay()
        _count(replays=1)

    def _side_stream(self, device):
        if self._stream is None:
            self._stream = _thread_stream(device)
            self._pool = torch.cuda.graph_pool_handle()
        return self._stream

    def _warm_up(self, state, body) -> None:
        """The first run of a key: eager, on the set's stream."""
        device = state.V.device
        stream = self._side_stream(device)
        caller = torch.cuda.current_stream(device)
        with annotate("eigenex.chunk.warmup"):
            stream.wait_stream(caller)
            with torch.cuda.stream(stream):
                _store(state, body())
            caller.wait_stream(stream)
        _count(warmups=1)

    def _capture(self, op, state, body, key) -> _Graph:
        """Capture the body on the set's stream (nothing runs); the launches
        and host counts it makes are kept apart, as one replay's."""
        device = state.V.device
        stream = self._side_stream(device)
        stats = getattr(op, "stats", None)
        held = dict(stats) if stats is not None else None
        graph = torch.cuda.CUDAGraph()
        reserved = torch.cuda.memory_reserved(device)
        t0 = time.perf_counter()
        with (annotate("eigenex.graph.capture"), cuda_spmv.launch_tally() as launches,
              torch.cuda.stream(stream)):
            graph.capture_begin(pool=self._pool)
            try:
                _store(state, body())
            finally:
                graph.capture_end()
        ms = (time.perf_counter() - t0) * 1e3
        grown = torch.cuda.memory_reserved(device) - reserved
        host_counts = None
        if stats is not None:
            host_counts = {name: stats[name] - held[name] for name in held}
            stats.update(held)
        _count(captures=1, capture_ms=ms, pool_bytes=grown)
        return _Graph(graph, launches, host_counts, stats, (op, state, key))

    def close(self) -> None:
        """Free the graphs, their pool and the buffers."""
        with annotate("eigenex.graphs.close"):
            for graph in self._graphs.values():
                graph.graph.reset()
            self._graphs.clear()
            self._seen.clear()
            self._buffers.clear()
            self._stream = self._pool = None
