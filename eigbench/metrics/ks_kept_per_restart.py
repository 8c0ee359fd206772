"""Vectors a Krylov-Schur restart keeps: the program's ``ks.kept`` (the
kept dimension written at each restart) over its ``solver.restarts``, over
every restart of the run.  None where the program keeps no ``ks.kept``
count, or nothing restarted."""

from eigbench.counters import program_counters


def read(ctx):
    counted = program_counters() if ctx.cuda else None
    if counted is None or not counted.get("ks.kept") or not counted.get("solver.restarts"):
        return None
    return counted["ks.kept"] / counted["solver.restarts"]
