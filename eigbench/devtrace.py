"""Device timing: chains of products timed by CUDA events, and one solve
under ``torch.profiler`` reduced to busy time and a breakdown."""

from __future__ import annotations

import statistics
import time
from collections import defaultdict

import torch

CHAIN_TARGET_MS = 100.0  # one chain lasts about this long
CHAIN_REPS = 7
TOP = 10                 # entries of each breakdown list
NAME_CHARS = 120         # a kernel's name cut to this length (templates run to pages)
ROOT_SPAN = "eigbench.solve"


def chain_ms(fn, reps: int = CHAIN_REPS) -> float:
    """Device ms of one call of ``fn``: the median over ``reps`` chains of
    back-to-back calls, each chain timed by two CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    calls = max(10, int(CHAIN_TARGET_MS / max(start.elapsed_time(end), 1e-3)))
    per_call = []
    for _ in range(reps):
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / calls)
    return statistics.median(per_call)


def profile(fn) -> dict:
    """Run ``fn`` once under the profiler.  Returns its result (``solve``),
    the wall seconds of the traced window (``window_s``), the seconds in
    which an operation ran on the device (``busy_s``: the union of the
    device events' intervals) and ``breakdown``: the device operations
    that took most time and the longest idle gaps, each gap named by the
    innermost host operation running at its middle."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function(ROOT_SPAN):
            solve = fn()
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    events = prof.events()
    # user annotations (record_function ranges) are mirrored on the device's
    # timeline: they are spans, not device work
    device = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                     if e.device_type == DeviceType.CUDA and e.name != ROOT_SPAN
                     and not getattr(e, "is_user_annotation", False)), key=lambda t: t[0])
    root = next(e for e in events if e.name == ROOT_SPAN and e.device_type == DeviceType.CPU)
    host = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                   if e.device_type == DeviceType.CPU and e.thread == root.thread
                   and e.name != ROOT_SPAN), key=lambda t: t[0])
    by_op = defaultdict(float)
    for s, e, name in device:
        by_op[name[:NAME_CHARS]] += (e - s) * 1e-6
    busy_us, gaps = _union_and_gaps(device, root.time_range.start, root.time_range.end)
    by_host = defaultdict(float)
    for (s, e), name in zip(gaps, _innermost(host, [(s + e) / 2 for s, e in gaps])):
        by_host[name or "host code outside torch operations"] += (e - s) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"solve": solve, "window_s": window_s, "busy_s": busy_us * 1e-6,
            "breakdown": {"device_ops": top(by_op), "idle_gaps": top(by_host)}}


def _union_and_gaps(intervals, lo, hi):
    """(length of the union of the sorted ``intervals``, the gaps between
    them inside [lo, hi])."""
    busy = 0.0
    gaps = []
    cursor = lo
    cur_s = cur_e = None
    for s, e, _ in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            if s > cursor:
                gaps.append((cursor, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        cursor = max(cursor, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    if hi > cursor:
        gaps.append((cursor, hi))
    return busy, gaps


def _innermost(host, points):
    """Name of the innermost host interval holding each of the sorted
    ``points`` (intervals of one thread nest), or None."""
    names = []
    stack = []
    i = 0
    for p in points:
        while i < len(host) and host[i][0] <= p:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        names.append(stack[-1][2] if stack else None)
    return names
