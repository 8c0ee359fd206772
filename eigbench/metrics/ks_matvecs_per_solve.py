"""Arnoldi steps a Krylov-Schur solve takes: the program's ``ks.steps``
(the steps of each chunk of ``solvers/krylov_schur.py``) over its
``solver.solves``, over every solve of the run.  None where the program
keeps no ``ks.steps`` count, or it is zero."""

from eigbench.counters import program_counters


def read(ctx):
    counted = program_counters() if ctx.cuda else None
    if counted is None or not counted.get("ks.steps") or not counted.get("solver.solves"):
        return None
    return counted["ks.steps"] / counted["solver.solves"]
