"""Dtype-dependent default tolerances.

Counterpart of ``eigenex_tpu/utils/tolerance.py`` keyed on torch dtypes:
the reference's ``DefaultTolerance`` trait (lanczos.hpp:63-83) defaults
to 1e-12 for double-precision scalar types and 1e-4 for single
precision; complex dtypes follow their real component dtype.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "as_torch_dtype",
    "default_tolerance",
    "default_breakdown_threshold",
    "real_dtype_of",
    "is_complex_dtype",
    "accumulation_dtype",
]

_FROM_NAME = {
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
    "int32": torch.int32,
    "int64": torch.int64,
}


def as_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    try:
        return _FROM_NAME[name]
    except KeyError:
        raise TypeError(f"unsupported dtype {dtype!r}") from None


def real_dtype_of(dtype) -> torch.dtype:
    """The real scalar dtype underlying ``dtype`` (identity for real dtypes)."""
    dtype = as_torch_dtype(dtype)
    if dtype == torch.complex64:
        return torch.float32
    if dtype == torch.complex128:
        return torch.float64
    return dtype


def is_complex_dtype(dtype) -> bool:
    return as_torch_dtype(dtype).is_complex


def accumulation_dtype(dtype) -> torch.dtype:
    """Low-precision block storage (bf16/f16) still accumulates, and
    yields matvecs, in f32; every other dtype accumulates in itself."""
    dtype = as_torch_dtype(dtype)
    if dtype in (torch.bfloat16, torch.float16):
        return torch.float32
    return dtype


def default_tolerance(dtype) -> float:
    """Default convergence tolerance for a scalar dtype.

    Mirrors the reference's dtype dispatch (lanczos.hpp:67-78):
    1e-12 for float64/complex128, 1e-4 for float32/complex64, 1e-2 for
    the half-precision types.
    """
    rdt = real_dtype_of(dtype)
    if rdt == torch.float64:
        return 1e-12
    if rdt == torch.float32:
        return 1e-4
    return 1e-2


def default_breakdown_threshold(dtype) -> float:
    """Threshold below which a Krylov residual norm counts as breakdown
    (the reference uses its ``DefaultTolerance`` value, lanczos.hpp:316,433)."""
    return default_tolerance(dtype)
