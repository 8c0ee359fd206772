"""Host ms a Krylov-Schur restart spends on its projected problem (the
ordered Schur form, the Ritz pairs and the stop test, inside the span
``eigenex.ks.project``): the program's ``ks.host_ms`` over its
``solver.restarts``, over every restart of the run.  None where the program
keeps no ``ks.host_ms`` count, or nothing restarted."""

from eigbench.counters import program_counters


def read(ctx):
    counted = program_counters() if ctx.cuda else None
    if counted is None or not counted.get("ks.host_ms") or not counted.get("solver.restarts"):
        return None
    return counted["ks.host_ms"] / counted["solver.restarts"]
