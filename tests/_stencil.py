"""The upwind convection-diffusion 5-point stencil of BASELINE config 2,
shared by the test modules of the general storages (row-compressed and
block) on the CPU and on the card."""

import scipy.sparse as sp


def stencil(nx: int, conv: float = 0.4) -> sp.coo_matrix:
    """The stencil on an nx x nx grid (n = nx^2 rows), a scipy COO matrix
    with no duplicate entries."""
    lap = sp.diags([-1.0 - conv, 4.0, -1.0 + conv], [-1, 0, 1], shape=(nx, nx))
    return (sp.kron(sp.eye(nx), lap) + sp.kron(sp.diags([-1.0 - conv, -1.0 + conv], [-1, 1],
                                                       shape=(nx, nx)), sp.eye(nx))).tocoo()
