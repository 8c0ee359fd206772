"""Random vectors, matrices and tensors on an explicit ``torch.Generator``.

Counterpart of ``eigenex_tpu/utils/prng.py`` (the reference's
distribution objects: ``ComplexUniformDistribution``/
``ComplexNormalDistribution``, util.hpp:49-158, ``VectorDistribution``,
``MatrixDistribution`` and ``OrthogonalMatrixDistribution``,
random.hpp:29-158, ``TensorDistribution``, tensor_random.hpp:16).  The
JAX package draws from ``jax.random`` keys; the port draws from a
``torch.Generator`` seeded by the caller.  The two give different
numbers from the same seed, so code that must agree across the packages
passes an explicit start vector instead of a seed.

Samples are drawn on the CPU generator and moved to ``device``, the
card unless told otherwise, so a seed gives the same numbers whichever
device they land on.  Complex normal samples have independent N(0, 1/2)
real and imaginary parts so that E|z|^2 = 1 (cf. util.hpp:77-106).
"""

from __future__ import annotations

import torch

from .device import resolve_device
from .tolerance import as_torch_dtype, is_complex_dtype, real_dtype_of

__all__ = [
    "make_generator",
    "random_normal",
    "random_uniform",
    "random_vector",
    "random_matrix",
    "random_tensor",
    "random_orthogonal",
    "random_hermitian",
]


def make_generator(seed: int) -> torch.Generator:
    """A CPU generator seeded with ``seed``."""
    g = torch.Generator(device="cpu")
    g.manual_seed(int(seed))
    return g


def random_normal(generator: torch.Generator, shape, dtype=torch.float32, stddev=1.0,
                  mean=0.0, device=None):
    """Normal samples of any real or complex dtype.  For complex dtypes the
    real and imaginary parts are independent with stddev/sqrt(2) each, so
    that E|z - mean|^2 = stddev^2 (cf. util.hpp:77-106)."""
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
    if stddev != 1.0:
        out = out * stddev
    if mean != 0.0:
        out = out + mean
    return out.to(resolve_device(device))


def random_uniform(generator: torch.Generator, shape, dtype=torch.float32, minval=0.0,
                   maxval=1.0, device=None):
    """Uniform samples on [minval, maxval); complex dtypes get independent
    uniform real and imaginary parts (cf. ComplexUniformDistribution
    util.hpp:49-75)."""
    dtype = as_torch_dtype(dtype)
    shape = tuple(shape)

    def draw(rdt):
        u = torch.rand(shape, generator=generator, dtype=torch.float64)
        return (minval + (maxval - minval) * u).to(rdt)

    if is_complex_dtype(dtype):
        rdt = real_dtype_of(dtype)
        re = draw(rdt)
        out = torch.complex(re, draw(rdt))
    else:
        out = draw(dtype)
    return out.to(resolve_device(device))


def random_vector(generator: torch.Generator, n: int, dtype=torch.float32,
                  normalize: bool = True, device=None):
    """Random (optionally unit-norm) vector (cf. VectorDistribution
    random.hpp:74-112, normalize flag :83)."""
    v = random_normal(generator, (int(n),), dtype, device=device)
    if normalize:
        v = v / torch.linalg.vector_norm(v)
    return v


def random_matrix(generator: torch.Generator, rows: int, cols: int, dtype=torch.float32,
                  device=None):
    """Random dense matrix (cf. MatrixDistribution random.hpp:29-71)."""
    return random_normal(generator, (int(rows), int(cols)), dtype, device=device)


def random_tensor(generator: torch.Generator, shape, dtype=torch.float32, device=None):
    """Random dense tensor (cf. TensorDistribution tensor_random.hpp:16-52)."""
    return random_normal(generator, tuple(shape), dtype, device=device)


def random_orthogonal(generator: torch.Generator, rows: int, cols: int | None = None,
                      dtype=torch.float32, device=None):
    """Random matrix with orthonormal columns (unitary if square): the QR
    of a Gaussian matrix with diag(R) made positive, which gives the Haar
    distribution -- the stable equivalent of the reference's Gram-Schmidt
    over random columns (random.hpp:144-150)."""
    cols = rows if cols is None else cols
    a = random_normal(generator, (int(rows), int(cols)), dtype, device=device)
    q, r = torch.linalg.qr(a)
    d = torch.diagonal(r)
    mag = d.abs()
    phase = torch.where(mag > 0, d / torch.where(mag > 0, mag, torch.ones_like(mag)),
                        torch.ones_like(d))
    return q * phase.conj()[None, :]


def random_hermitian(generator: torch.Generator, n: int, dtype=torch.float32, device=None):
    """Random Hermitian (symmetric if real) matrix -- test-oracle helper."""
    a = random_matrix(generator, n, n, dtype, device=device)
    return (a + a.conj().T) / 2
