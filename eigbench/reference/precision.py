"""Rounding to TF32 (8 exponent bits, 10 explicit mantissa bits), the
input precision of a float32 product on the tensor cores with TF32 on.
A product whose inputs pass through these functions and accumulates in
float32 is what such a product computes, up to the order of the sums."""

from __future__ import annotations

import numpy as np
import torch

_LOW = 0x1FFF  # the 13 mantissa bits TF32 drops


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 tensor -> float32 tensor of TF32 values, rounded to nearest even."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~_LOW
    return bits.view(torch.float32)


def round_tf32_np(x: np.ndarray) -> np.ndarray:
    """The same for a float32 NumPy array."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    bits = (bits + np.uint32(0xFFF) + ((bits >> np.uint32(13)) & np.uint32(1))) & np.uint32(~_LOW & 0xFFFFFFFF)
    return bits.view(np.float32)
