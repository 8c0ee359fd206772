"""Benchmark timing protocol -- one tested implementation for every
harness that times a product of the port.

Counterpart of ``eigenex_tpu/utils/benchtime.py``, with the same names and
return fields.  What the protocol guards against on a CUDA card:

1. **Launch overhead**: a single call measures the host's time to queue
   it.  A rate comes from the SLOPE between two back-to-back chains of
   ``k_lo`` and ``k_hi`` products, each timed by CUDA events around the
   whole chain, which cancels the constant part.
2. **Asynchronous launches**: PyTorch returns before the device has
   finished, so :func:`force_sync` synchronises the device the tensor
   lives on before a host clock is read.
3. **Jitter**: medians of ``reps`` runs per point, and the spread is
   reported beside them.
4. **Physical plausibility**: a time below what the bytes the path must
   stream allow at the card's memory rate is a timing artefact -- clamped
   and flagged, never recorded.  The ceiling is the H100 SXM's published
   3.35 TB/s (NVIDIA data sheet).
"""

from __future__ import annotations

import time

import numpy as np
import torch

__all__ = [
    "force_sync",
    "timed_median",
    "chain_slope",
    "plausibility_floor",
    "clamp_to_roofline",
    "H100_SXM_PEAK_GBS",
]

#: H100 SXM memory rate (GB/s), NVIDIA's data sheet -- the plausibility
#: ceiling for memory-bound paths
H100_SXM_PEAK_GBS = 3350.0


def force_sync(y) -> None:
    """Wait until ``y`` (a tensor, or a tuple or list whose first item is
    one) is computed: synchronise its CUDA device; a CPU tensor is ready
    when the call that made it returns."""
    t = y[0] if isinstance(y, (tuple, list)) else y
    if isinstance(t, torch.Tensor) and t.is_cuda:
        torch.cuda.synchronize(t.device)


def timed_median(fn, reps: int = 5):
    """(median_seconds, all_samples) of ``fn()`` (which must block)."""
    ts = []
    for _ in range(int(reps)):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), ts


def chain_slope(
    matvec_fn,
    params,
    x: torch.Tensor,
    *,
    k_lo: int = 32,
    k_hi: int = 160,
    reps: int = 5,
    normalize: bool = True,
):
    """Per-application seconds of ``matvec_fn(params, x)`` via the
    two-point chain slope, with medians of ``reps`` runs per point.  Each
    run applies the product ``k`` times back to back (normalising between
    applications unless ``normalize=False``); on a CUDA tensor CUDA events
    time the whole chain, elsewhere the host clock.

    Returns ``(per_seconds, stats)``; ``per_seconds`` is None when the
    slope is not resolvable above the jitter (stats say so).  ``stats``
    carries the medians, spreads and protocol parameters."""

    def chain(k):
        v = x
        for _ in range(k):
            y = matvec_fn(params, v)
            if normalize:
                y = y / torch.linalg.vector_norm(y)
            v = y.to(x.dtype)
        return v

    def run(k) -> float:
        if x.is_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chain(k)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        force_sync(chain(k))
        return time.perf_counter() - t0

    run(k_lo)  # warm both points
    run(k_hi)
    ts_lo = [run(k_lo) for _ in range(int(reps))]
    ts_hi = [run(k_hi) for _ in range(int(reps))]
    med_lo, med_hi = float(np.median(ts_lo)), float(np.median(ts_hi))
    per = (med_hi - med_lo) / (k_hi - k_lo)
    stats = dict(
        k_lo=k_lo,
        k_hi=k_hi,
        reps=reps,
        median_lo_s=med_lo,
        median_hi_s=med_hi,
        spread_lo_s=float(np.max(ts_lo) - np.min(ts_lo)),
        spread_hi_s=float(np.max(ts_hi) - np.min(ts_hi)),
    )
    if per <= 0:
        stats["unresolvable"] = True
        return None, stats
    return per, stats


def plausibility_floor(bytes_accessed: int, peak_gbs: float = H100_SXM_PEAK_GBS) -> float:
    """Minimum seconds a memory-bound path streaming ``bytes_accessed``
    can physically take at ``peak_gbs``."""
    return bytes_accessed / (peak_gbs * 1e9)


def clamp_to_roofline(
    per_seconds: float, bytes_accessed: int, peak_gbs: float = H100_SXM_PEAK_GBS
):
    """(clamped_seconds, was_clamped): reject timings faster than the
    memory rate allows -- they are artefacts of a synchronisation that
    raced the work, not measurements."""
    floor = plausibility_floor(bytes_accessed, peak_gbs)
    if per_seconds < floor:
        return floor, True
    return per_seconds, False
