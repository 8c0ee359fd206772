"""BASELINE config 2 at its published size: the 2-D upwind
convection-diffusion 5-point stencil on a 316 x 316 grid (n = 99,856,
about 498 k nonzeros), convection 0.4.  The triplets are made here; the
measured package's ``accelerate`` packs them into its float32 general
pack of 32x128 blocks.  Not cut: ``reduced`` is empty."""

import numpy as np

SOURCE = ("https://github.com/versmc/cmpt-eigenex (BASELINE.json configs[1], Arnoldi dominant "
          "eigenpairs of a 2D convection-diffusion operator, n = 1e5; nx = 316 as BASELINE.md)")
REDUCED: list = []
#: set here, not by the source: the convection coefficient and the storage
ASSUMED = {"conv": 0.4, "storage": "float32"}
PARAMS = {"nx": 316, "conv": 0.4}
STORAGE = "float32"
SYMMETRIC = False
REFERENCE = "convection_diffusion"


def operand(params):
    """(rows, cols, vals, shape): 4 on the diagonal, -1 - conv towards the
    lower neighbour in x and in y, -1 + conv towards the upper one; row-major
    grid index u = y nx + x; triplets sorted by (row, col)."""
    nx, conv = params["nx"], params["conv"]
    n = nx * nx
    i = np.arange(nx)
    jj, ii = np.meshgrid(i, i)
    u = (ii * nx + jj).ravel()
    rows, cols, vals = [u], [u], [np.full(n, 4.0)]
    for mask, offset, value in ((ii > 0, -nx, -1.0 - conv), (ii < nx - 1, nx, -1.0 + conv),
                                (jj > 0, -1, -1.0 - conv), (jj < nx - 1, 1, -1.0 + conv)):
        uu = u[mask.ravel()]
        rows.append(uu)
        cols.append(uu + offset)
        vals.append(np.full(uu.size, value))
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    v = np.concatenate(vals)
    order = np.lexsort((c, r))
    return r[order], c[order], v[order], (n, n)


def triplets(trip):
    return trip[0], trip[1], trip[3]


def pack(trip, device):
    from eigenex_tpu_torch import accelerate

    return accelerate(trip, device=device)
