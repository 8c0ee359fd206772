"""The measured program's counters, for the readers of ``metrics/``.

The program keeps them in one store, always on
(``eigenex_tpu_torch.utils.profiling.counters``); the run never resets
them, so a reader sees the whole run: set-up's warm-up solve, the window's
solves, the traced extras.  Per-solve readings divide by the program's own
count of solves (``solver.solves``), so every solve of the run weighs alike.
A program that keeps no such store gives None, and the metric is left out.
"""


def program_counters() -> dict | None:
    try:
        from eigenex_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    return counters()


def per_solve(name: str) -> float | None:
    """Counter ``name`` over the run's solves, or None."""
    counted = program_counters()
    if counted is None or not counted.get("solver.solves"):
        return None
    return counted.get(name, 0) / counted["solver.solves"]
