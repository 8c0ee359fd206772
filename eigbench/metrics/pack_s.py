"""Host seconds of the operator's pack in set-up: the clock around
``config.pack`` (the measured package's ``accelerate``) and a synchronise."""


def read(ctx):
    if not ctx.cuda:
        return None
    return ctx.pack_s
