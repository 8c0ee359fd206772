"""Peak device memory over set-up and window, GiB: the allocator's
``max_memory_allocated`` after a reset at process start."""


def read(ctx):
    if not ctx.cuda:
        return None
    return ctx.memory_peak_bytes / 2**30
