"""GMRES cycles one outer application of the shift-invert operator takes:
the program's ``gmres.cycles`` over its ``si.applications``, over every
application of the run.  None where the program keeps no such counts."""

from eigbench.counters import program_counters


def read(ctx):
    counted = program_counters() if ctx.cuda else None
    if counted is None or not counted.get("gmres.cycles") or not counted.get("si.applications"):
        return None
    return counted["gmres.cycles"] / counted["si.applications"]
