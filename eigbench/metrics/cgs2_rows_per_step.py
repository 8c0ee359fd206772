"""Basis rows one CGS2 pass reads, a Krylov step: the program's
``cgs2.rows`` (the rows each step's pass reads, summed over every chunk of
the run, graph replays included) over its ``cgs2.steps``.  None where the
program keeps no such count (a program whose passes read the whole
preallocated basis under a mask), or took no step."""

from eigbench.counters import program_counters


def read(ctx):
    counted = program_counters() if ctx.cuda else None
    if counted is None or not counted.get("cgs2.steps"):
        return None
    return counted["cgs2.rows"] / counted["cgs2.steps"]
