"""Kernel launches a matvec: the launches made while a solve ran (the
program's ``solver.launches``: its ``launch.<kernel>`` counts, replays of
captured launches included, grown inside its front end) over the solves'
own matvec counts (``solver.iterations``, the ``result.iterations`` that
``matvecs_per_solve`` reads), over every solve of the run.  The product
chain that ``spmv_ms`` times runs outside any solve and is not counted."""

from eigbench.counters import program_counters


def read(ctx):
    counted = program_counters() if ctx.cuda else None
    if counted is None or not counted.get("solver.iterations"):
        return None
    return counted.get("solver.launches", 0) / counted["solver.iterations"]
