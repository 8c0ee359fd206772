"""Profiling hooks: spans, counters and traces.

Counterpart of ``eigenex_tpu/utils/profiling.py``, on ``torch.profiler``
instead of ``jax.profiler``: :func:`profile_trace` records a host and
device trace of a code region and writes it as a Chrome trace (view it
in Perfetto or ``chrome://tracing``), :func:`annotate` is the span that
names a region of the program, and :class:`PhaseTimer` gives cheap
host-side per-phase wall-clock accounting for a convergence loop.

A span (:class:`annotate`) does nothing while neither a ``torch.profiler``
runs nor :func:`record_spans` is open: one test of two flags.  Under a
profiler it is a ``record_function`` range, so that it lies on the
profiler's clock beside the device's events, and on a CUDA machine an NVTX
range too.  Inside :func:`record_spans` it is also kept in memory (name,
start and end on ``time.perf_counter_ns``, the enclosing span's index, the
solve it belongs to, its attributes) until :func:`spans` reads it.  The
outermost ``eigenex.solve`` span starts a solve: every span opened inside
it, on any thread, carries its solve id.  A span never waits for the
device; the program's waits are spans of their own (``eigenex.wait``).

Counters (:func:`count`, :func:`counters`, :func:`reset_counters`) are
always on: one store of named numbers under a lock, which the kernel
wrappers' launch counts (``launch.<kernel>``), the chunk graphs' counts
(``graph.<name>``) and the solvers' counts (``solver.<name>``) share.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict, deque

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = [
    "profile_trace",
    "annotate",
    "PhaseTimer",
    "record_spans",
    "spans",
    "add_span",
    "span_summary",
    "count",
    "counters",
    "reset_counters",
    "ROOT_SPAN",
]

#: the span of one request; its outermost instance starts a solve id
ROOT_SPAN = "eigenex.solve"
#: spans kept in memory; beyond it the oldest are dropped
MAX_SPANS = 1 << 16

_recording = False
_records: deque = deque(maxlen=MAX_SPANS)
_span_index = itertools.count()
_solve_ids = itertools.count(1)
_solve = None  # id of the solve whose root span is open, or None
_spans_lock = threading.Lock()
_local = threading.local()  # .open: indices of this thread's open recorded spans
_nvtx = None  # whether spans push NVTX ranges (a CUDA machine); decided at first use

_counters: dict = defaultdict(int)
_counters_lock = threading.Lock()


@contextlib.contextmanager
def profile_trace(log_dir: str, host_tracer_level: int = 2):
    """Record the CPU and, where a card is present, the CUDA activity of
    the region and write ``log_dir/trace.json`` (a Chrome trace).  Yields
    the ``torch.profiler.profile`` object, whose ``key_averages()`` sums
    the recorded events by name.  ``host_tracer_level`` is accepted for the
    JAX package's signature; ``torch.profiler`` has no such level."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------
class annotate(contextlib.ContextDecorator):
    """A span named ``name`` with attributes ``attrs``, as a context manager
    or a decorator: nothing while neither a profiler runs nor
    :func:`record_spans` is open; else a ``record_function`` range (under a
    profiler), an NVTX range (on CUDA) and a kept record (when recording)."""

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self._open = None

    def _recreate_cm(self):
        # a decorated function may run on several threads, or within itself
        return annotate(self.name, **self.attrs)

    def __enter__(self):
        if _recording or _autograd_profiler._is_profiler_enabled:
            self._open = _begin(self.name, self.attrs)
        return self

    def __exit__(self, *exc):
        if self._open is not None:
            _end(self._open)
            self._open = None
        return False


def _begin(name: str, attrs: dict) -> tuple:
    global _nvtx, _solve
    function = None
    if _autograd_profiler._is_profiler_enabled:
        function = torch.profiler.record_function(name)
        function.__enter__()
    if _nvtx is None:
        _nvtx = torch.cuda.is_available()
    if _nvtx:
        torch.cuda.nvtx.range_push(name)
    record = None
    if _recording:
        stack = _local.__dict__.setdefault("open", [])
        parent = stack[-1] if stack else None
        if name == ROOT_SPAN and parent is None and _solve is None:
            _solve = next(_solve_ids)
            record = [next(_span_index), name, 0, None, None, _solve, attrs, True]
        else:
            record = [next(_span_index), name, 0, None, parent, _solve, attrs, False]
        stack.append(record[0])
        with _spans_lock:
            _records.append(record)
        record[2] = time.perf_counter_ns()
    return function, record


def _end(opened: tuple) -> None:
    global _solve
    function, record = opened
    if record is not None:
        record[3] = time.perf_counter_ns()
        stack = _local.open
        if stack and stack[-1] == record[0]:
            stack.pop()
        if record[7]:  # the root span of a solve
            _solve = None
    if _nvtx:
        torch.cuda.nvtx.range_pop()
    if function is not None:
        function.__exit__(None, None, None)


def add_span(name: str, start_s: float, end_s: float, **attrs) -> None:
    """Keep a span that has already ended, timed on ``time.perf_counter``
    (the clock of ``perf_counter_ns``), inside the innermost open span of
    this thread: for stages a caller times itself.  Nothing unless
    :func:`record_spans` is open; it never reaches a profiler."""
    if not _recording:
        return
    stack = getattr(_local, "open", None)
    record = [next(_span_index), name, int(start_s * 1e9), int(end_s * 1e9),
              stack[-1] if stack else None, _solve, attrs, False]
    with _spans_lock:
        _records.append(record)


@contextlib.contextmanager
def record_spans():
    """Keep every span opened while the block runs, for :func:`spans`."""
    global _recording
    previous = _recording
    _recording = True
    try:
        yield
    finally:
        _recording = previous


def spans() -> list[dict]:
    """The kept spans, oldest first, and forget them: each a dict of
    ``index``, ``name``, ``start_ns``, ``end_ns`` (None while open),
    ``parent`` (the enclosing span's index, or None), ``solve`` (the id of
    the solve it ran in, or None) and ``attrs``."""
    with _spans_lock:
        kept = list(_records)
        _records.clear()
    return [dict(index=r[0], name=r[1], start_ns=r[2], end_ns=r[3], parent=r[4], solve=r[5],
                 attrs=r[6]) for r in kept]


def span_summary(records: list[dict]) -> dict:
    """Per span name, over the ended ``records``: ``count``, ``ms`` (their
    durations summed) and ``self_ms`` (less the time their child spans
    cover)."""
    ended = [r for r in records if r["end_ns"] is not None]
    children = defaultdict(int)
    for r in ended:
        if r["parent"] is not None:
            children[r["parent"]] += r["end_ns"] - r["start_ns"]
    out: dict = {}
    for r in ended:
        entry = out.setdefault(r["name"], dict(count=0, ms=0.0, self_ms=0.0))
        took = r["end_ns"] - r["start_ns"]
        entry["count"] += 1
        entry["ms"] += took * 1e-6
        entry["self_ms"] += (took - children[r["index"]]) * 1e-6
    return out


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------
def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _counters_lock:
        _counters[name] += n


def counters(prefix: str = "") -> dict:
    """The counters whose names start with ``prefix``, since their last reset."""
    with _counters_lock:
        return {k: v for k, v in _counters.items() if k.startswith(prefix)}


def reset_counters(prefix: str = "") -> None:
    """Set the counters whose names start with ``prefix`` to zero: they are
    forgotten, so :func:`counters` lists only what was counted since."""
    with _counters_lock:
        for k in [k for k in _counters if k.startswith(prefix)]:
            del _counters[k]


class PhaseTimer:
    """Accumulate wall-clock per named phase (host side).  It reads the
    host's clock only: work a phase enqueues on the card counts where the
    host waits for it, so a phase times its enqueue unless the caller
    synchronises inside it.

    >>> t = PhaseTimer()
    >>> with t("matvec"): ...
    >>> t.summary()
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[phase] += time.perf_counter() - t0
            self.counts[phase] += 1

    def summary(self) -> str:
        lines = []
        for phase in sorted(self.totals, key=lambda p: -self.totals[p]):
            tot, n = self.totals[phase], self.counts[phase]
            lines.append(f"{phase:24s} {tot:9.4f}s  x{n:<6d} {tot/max(n,1)*1e3:9.3f} ms/call")
        return "\n".join(lines)
