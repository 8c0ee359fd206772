"""Thick restarts a solve: the program's ``solver.restarts`` (counted at
each restart of the thick-restart and Krylov-Schur loops) over its
``solver.solves``, over every solve of the run."""

from eigbench.counters import per_solve


def read(ctx):
    if not ctx.cuda:
        return None
    return per_solve("solver.restarts")
