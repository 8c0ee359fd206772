"""Host ms a solve spends carrying vectors across the accelerated
operator's boundary (``embed``, ``embed_left``, ``restore`` and
``restore_right``, the wait for the answer's copy to the host included): the
program's ``accelerate.host_ms`` over its ``solver.solves``, over every solve
of the run.  None where the program keeps no ``accelerate.host_ms`` count."""

from eigbench.counters import per_solve, program_counters


def read(ctx):
    counted = program_counters() if ctx.cuda else None
    if counted is None or "accelerate.host_ms" not in counted:
        return None
    return per_solve("accelerate.host_ms")
