"""Wall seconds per converged solve: the whole measured window, from its
start to the end of its last solve (synchronised), over the solves in it."""


def read(ctx):
    if not ctx.cuda or not ctx.solves:
        return None
    return ctx.window_s / len(ctx.solves)
