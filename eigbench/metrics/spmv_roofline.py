"""Share of the roofline, %, of one product with the cell's operator: the
least time the card could take for the operator's own work (``work.py``:
bytes over bandwidth or flops over the storage's peak, the larger) over
``spmv_ms``.  None on a card the peak table does not know."""

from eigbench import work


def read(ctx):
    if ctx.spmv_ms is None:
        return None
    bound = work.roofline_ms(*ctx.work, ctx.storage, ctx.device_name)
    if bound is None:
        return None
    return 100.0 * bound / ctx.spmv_ms
