"""Profiling hooks.

Counterpart of ``eigenex_tpu/utils/profiling.py``, on ``torch.profiler``
instead of ``jax.profiler``: :func:`profile_trace` records a host and
device trace of a code region and writes it as a Chrome trace (view it
in Perfetto or ``chrome://tracing``), :func:`annotate` names a host
region so that it lines up with the device timeline (and, on a CUDA
machine, with an NVTX range), and :class:`PhaseTimer` gives cheap
host-side per-phase wall-clock accounting for a convergence loop.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

__all__ = ["profile_trace", "annotate", "PhaseTimer"]


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


class annotate(contextlib.ContextDecorator):
    """Named region visible in profiler timelines (a
    ``torch.profiler.record_function``, and an NVTX range when CUDA is
    present); usable as context manager or decorator."""

    def __init__(self, name: str):
        self.name = name
        self._stack: list[contextlib.ExitStack] = []

    def __enter__(self):
        stack = contextlib.ExitStack()
        stack.enter_context(torch.profiler.record_function(self.name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(self.name))
        self._stack.append(stack)
        return self

    def __exit__(self, *exc):
        self._stack.pop().close()
        return False


class PhaseTimer:
    """Accumulate wall-clock per named phase (host side).

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
