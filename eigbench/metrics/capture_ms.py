"""Host ms a solve spends capturing and instantiating CUDA graphs of its
Krylov chunks: the program's ``graph.capture_ms`` over its
``solver.solves``, over every solve of the run."""

from eigbench.counters import per_solve


def read(ctx):
    if not ctx.cuda:
        return None
    return per_solve("graph.capture_ms")
