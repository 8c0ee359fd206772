"""Share of a solve, %, in which the device ran nothing: 1 - the device busy
seconds a matvec of one profiled solve (the union of its device events'
intervals over its matvecs) over the median wall seconds a matvec of the
window's unprofiled solves, so that the profiler's own host time does not
count as idle and a solve of another length compares alike."""

import statistics


def read(ctx):
    per_matvec = [s.wall_s / s.iterations for s in ctx.solves if s.iterations]
    if ctx.profile is None or not per_matvec or not ctx.profile["solve"].iterations:
        return None
    busy = ctx.profile["busy_s"] / ctx.profile["solve"].iterations
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / statistics.median(per_matvec))
