"""Products with A a shift-invert solve makes inside its outer
applications (every inner GMRES cycle's, each application's true-residual
check and any CGLS fallback's): the program's ``si.matvecs`` over its
``solver.solves``, over every solve of the run.  None where the program
keeps no ``si.matvecs`` count."""

from eigbench.counters import per_solve, program_counters


def read(ctx):
    counted = program_counters() if ctx.cuda else None
    if counted is None or not counted.get("si.matvecs"):
        return None
    return per_solve("si.matvecs")
