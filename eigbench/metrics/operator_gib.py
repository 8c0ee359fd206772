"""Device GiB the packed operator holds: ``memory_allocated`` after the pack
minus before it."""


def read(ctx):
    if not ctx.cuda or ctx.operator_bytes is None:
        return None
    return ctx.operator_bytes / 2**30
