"""Operator applications a solve takes: the solver's own count
(``result.iterations``) summed over the window's solves, over their number."""


def read(ctx):
    counted = [s.iterations for s in ctx.solves if s.iterations is not None]
    if not counted:
        return None
    return sum(counted) / len(counted)
