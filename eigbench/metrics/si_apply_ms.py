"""Host ms one outer application of the shift-invert operator takes, from
its start to its answer (the inner GMRES solve, its true-residual read, any
CGLS fallback; inside the span ``eigenex.si.apply``): the program's
``si.apply_ms`` over its ``si.applications``, over every application of
the run.  None where the program keeps no such counts."""

from eigbench.counters import program_counters


def read(ctx):
    counted = program_counters() if ctx.cuda else None
    if counted is None or not counted.get("si.apply_ms") or not counted.get("si.applications"):
        return None
    return counted["si.apply_ms"] / counted["si.applications"]
