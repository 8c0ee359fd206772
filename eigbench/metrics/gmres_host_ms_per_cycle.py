"""Host ms a GMRES cycle spends reading its Hessenberg and solving the
small least-squares problem on the host (inside the span
``eigenex.gmres.lstsq``): the program's ``gmres.host_ms`` over its
``gmres.cycles``, over every cycle of the run.  None where the program
keeps no such counts."""

from eigbench.counters import program_counters


def read(ctx):
    counted = program_counters() if ctx.cuda else None
    if counted is None or not counted.get("gmres.host_ms") or not counted.get("gmres.cycles"):
        return None
    return counted["gmres.host_ms"] / counted["gmres.cycles"]
