"""Seconds from process start to the first timed solve: imports, the card's
start, the host build and pack of the operator, and one warm-up solve
(which builds the kernels where the checkout has none built)."""


def read(ctx):
    if not ctx.cuda:
        return None
    return ctx.setup_s
