"""Wall ms of one Krylov step: the window's solves' wall time (host clock;
each solve ends in host arrays, so it is synchronised) over their matvecs."""


def read(ctx):
    timed = [s for s in ctx.solves if s.iterations]
    if not ctx.cuda or not timed:
        return None
    return sum(s.wall_s for s in timed) * 1e3 / sum(s.iterations for s in timed)
