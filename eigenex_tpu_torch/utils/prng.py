"""Random vectors on an explicit ``torch.Generator``.

Counterpart of ``eigenex_tpu/utils/prng.py``.  The JAX package draws
from ``jax.random`` keys; the port draws from a ``torch.Generator``
seeded by the caller.  The two give different numbers from the same
seed, so code that must agree across the packages passes an explicit
start vector instead of a seed.

Samples are drawn on the CPU and moved to the target device, so a seed
gives the same vector whichever device the solve runs on.  Complex
normal samples have independent N(0, 1/2) real and imaginary parts so
that E|z|^2 = 1 (cf. util.hpp:77-106).
"""

from __future__ import annotations

import torch

from .tolerance import as_torch_dtype, is_complex_dtype, real_dtype_of

__all__ = ["make_generator", "random_normal", "random_vector", "random_matrix"]


def make_generator(seed: int) -> torch.Generator:
    """A CPU generator seeded with ``seed``."""
    g = torch.Generator(device="cpu")
    g.manual_seed(int(seed))
    return g


def random_normal(generator: torch.Generator, shape, dtype=torch.float32, device="cpu"):
    """Standard normal samples of any real or complex dtype."""
    dtype = as_torch_dtype(dtype)
    shape = tuple(shape)
    if is_complex_dtype(dtype):
        rdt = real_dtype_of(dtype)
        re = torch.randn(shape, generator=generator, dtype=rdt)
        im = torch.randn(shape, generator=generator, dtype=rdt)
        out = torch.complex(re, im) * (0.5**0.5)
    else:
        # draw in f64 so a seed gives the same direction at every dtype
        out = torch.randn(shape, generator=generator, dtype=torch.float64).to(dtype)
    return out.to(device)


def random_vector(generator: torch.Generator, n: int, dtype=torch.float32,
                  normalize: bool = True, device="cpu"):
    """Random (optionally unit-norm) vector (cf. VectorDistribution
    random.hpp:74-112, normalize flag :83)."""
    v = random_normal(generator, (int(n),), dtype, device)
    if normalize:
        v = v / torch.linalg.vector_norm(v)
    return v


def random_matrix(generator: torch.Generator, rows: int, cols: int, dtype=torch.float32,
                  device="cpu"):
    """Random dense matrix (cf. MatrixDistribution random.hpp:29-71)."""
    return random_normal(generator, (int(rows), int(cols)), dtype, device)
