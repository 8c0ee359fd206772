"""Exception hierarchy of the PyTorch port.

Same classes as ``eigenex_tpu/utils/exceptions.py`` (which mirrors the
reference's ``RuntimeException`` / ``LanczosException`` /
``VectorMapException``).  Exceptions are raised on the host for
configuration and validation errors; numerical failures inside a Krylov
chunk (breakdown, NaN/Inf) are carried as device flags in the solver
state and surfaced in the result, so the hot loop never has to
synchronise with the host to raise.
"""

from __future__ import annotations

__all__ = [
    "EigenexError",
    "LanczosError",
    "ArnoldiError",
    "OperatorError",
    "BlockTensorError",
    "EinsumError",
    "not_ported",
]


class EigenexError(RuntimeError):
    """Base class for all eigenex errors (cf. util.hpp:161)."""


class LanczosError(EigenexError):
    """Lanczos configuration/validation error (cf. lanczos.hpp:90)."""


# The reference aliases ArnoldiException = LanczosException (arnoldi.hpp:45).
ArnoldiError = LanczosError


class OperatorError(EigenexError):
    """Linear-operator composition error (cf. vector_map.hpp:18)."""


class BlockTensorError(EigenexError):
    """Block-sparse tensor structure error (cf. block_tensor.hpp throw sites)."""


class EinsumError(EigenexError):
    """Einsum label/shape validation error (cf. einsum.hpp:186-214)."""


def not_ported(what: str) -> EigenexError:
    """The error every entry point of the port raises for a feature of
    the JAX package that has no counterpart here yet."""
    return EigenexError(f"not ported yet: {what}")
