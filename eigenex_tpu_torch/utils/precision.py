"""The f32 matmul precision every solver runs at.

The JAX package pins ``precision="highest"`` on its dense f32 products
(the CGS2 projections, the restart compression, Ritz vectors, the GMRES
update, the LOBPCG and Rayleigh-Ritz Gram products).  In PyTorch the
same products follow a process-wide setting,
``torch.set_float32_matmul_precision``: a caller's ``"high"`` turns them
into TF32 on the card and ``"medium"`` into bf16-grade products, and a
solve would then return Ritz values off by 1e-4..1e-3 relative while
reporting convergence.

:func:`highest_f32_matmul` sets ``"highest"`` for the duration of a
solve and gives the caller's setting back on exit, also when the solve
raises.  Every front end and every solver's ``compute()`` runs under it,
as a context manager or as a decorator.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["highest_f32_matmul"]


@contextlib.contextmanager
def highest_f32_matmul():
    """Run the block at ``torch.set_float32_matmul_precision("highest")``
    and restore the caller's setting afterwards.  Usable as a decorator."""
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(previous)
