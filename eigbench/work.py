"""The work one product with a sparse operator needs, and the peaks of the
cards the benchmark knows.

The count is of the operator, not of any packed format: each stored
nonzero is one value in the storage dtype plus one 32-bit column index;
a symmetric operator stores its diagonal and upper triangle only; the
input vector is read once and the output written once, in float32.
Flops are two per nonzero of the full operator.  The same count holds
whatever format or kernel stands behind the product, so a share of the
roofline taken from it can only be read against the operator's own need.
"""

from __future__ import annotations

import numpy as np

VALUE_BYTES = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2}
INDEX_BYTES = 4
VECTOR_BYTES = 4

#: (name fragment, memory bytes/s, flop/s by storage dtype): NVIDIA's data
#: sheets, dense rates without sparsity; float32 outside the tensor cores,
#: bfloat16 on them, float64 on the tensor cores.  The first fragment found
#: in the card's name is used, so the specific parts come before "H100".
PEAKS = (
    ("H100 PCIe", 2.0e12, {"float64": 51e12, "float32": 51e12, "bfloat16": 756e12}),
    ("H100 NVL", 3.9e12, {"float64": 60e12, "float32": 60e12, "bfloat16": 835e12}),
    ("H100", 3.35e12, {"float64": 67e12, "float32": 67e12, "bfloat16": 989e12}),
)


def spmv_work(rows, cols, n_rows: int, n_cols: int, storage: str, symmetric: bool):
    """(bytes, flops) of y = A x for the duplicate-free triplets (rows, cols)."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    nnz = int(rows.size)
    stored = int(np.count_nonzero(rows <= cols)) if symmetric else nnz
    nbytes = stored * (VALUE_BYTES[storage] + INDEX_BYTES) + (n_rows + n_cols) * VECTOR_BYTES
    return nbytes, 2 * nnz


def peaks_for(device_name: str):
    """(bytes/s, flop/s by storage) of the named card, or None if unknown."""
    for fragment, bandwidth, flops in PEAKS:
        if fragment in device_name:
            return bandwidth, flops
    return None


def roofline_ms(nbytes: int, flops: int, storage: str, device_name: str):
    """The least time the card could take for that work, in ms: the larger
    of bytes over bandwidth and flops over the storage's peak; None for a
    card not in the table."""
    peaks = peaks_for(device_name)
    if peaks is None:
        return None
    bandwidth, rates = peaks
    return max(nbytes / bandwidth, flops / rates[storage]) * 1e3
