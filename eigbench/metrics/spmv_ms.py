"""Device ms of one product with the cell's operator through its public
``matvec`` (the call the solver makes): CUDA events around chains of
back-to-back calls, the median of the chains, after the window."""


def read(ctx):
    return ctx.spmv_ms
