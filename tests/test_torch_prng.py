"""The port's random helpers (``utils/prng.py``): the seven ``random_*``
the package exports have the JAX package's shapes, dtypes and
properties (unit norm, orthonormal columns, Hermitian, range, moments);
their numbers come from a CPU ``torch.Generator``, so a seed gives the
same samples on every device; and with no ``device`` they go to the card."""

import numpy as np
import pytest
import torch

import eigenex_tpu_torch as ext
from eigenex_tpu_torch.utils.prng import make_generator


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.complex128])
def test_shapes_dtypes_and_properties(dtype):
    g = make_generator(0)
    cpu = dict(device="cpu")
    assert ext.random_normal(g, (3, 4), dtype, **cpu).shape == (3, 4)
    u = ext.random_uniform(g, (2000,), dtype, -2.0, 3.0, **cpu)
    assert u.dtype == dtype and u.shape == (2000,)
    parts = [u.real, u.imag] if dtype.is_complex else [u]
    for p in parts:
        assert float(p.min()) >= -2.0 and float(p.max()) < 3.0
        assert abs(float(p.double().mean()) - 0.5) < 0.1
    v = ext.random_vector(g, 7, dtype, **cpu)
    assert abs(float(torch.linalg.vector_norm(v)) - 1.0) < 1e-6
    assert ext.random_vector(g, 7, dtype, normalize=False, **cpu).dtype == dtype
    assert ext.random_matrix(g, 3, 5, dtype, **cpu).shape == (3, 5)
    assert ext.random_tensor(g, (2, 3, 4), dtype, **cpu).shape == (2, 3, 4)
    Q = ext.random_orthogonal(g, 6, 4, dtype, **cpu).to(torch.complex128)
    assert torch.allclose(Q.conj().T @ Q, torch.eye(4, dtype=torch.complex128), atol=1e-5)
    H = ext.random_hermitian(g, 5, dtype, **cpu)
    assert torch.equal(H, H.conj().T)
    z = ext.random_normal(g, (20000,), dtype, stddev=2.0, mean=1.0, **cpu)
    assert abs(float((z - 1.0).abs().pow(2).double().mean()) - 4.0) < 0.2


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs an NVIDIA GPU to compare two devices")
def test_a_seed_gives_the_same_numbers_on_every_device():
    for draw in (ext.random_tensor, ext.random_normal, ext.random_uniform):
        a = draw(make_generator(3), (4, 4), torch.float64, device="cuda")
        b = draw(make_generator(3), (4, 4), torch.float64, device="cpu")
        assert a.is_cuda and torch.equal(a.cpu(), b)


def test_a_seed_gives_the_same_numbers_on_every_call():
    a = ext.random_tensor(make_generator(3), (4, 4), torch.float32, device="cpu")
    b = ext.random_tensor(make_generator(3), (4, 4), torch.float32, device="cpu")
    assert torch.equal(a, b)
    n = ext.random_normal(make_generator(3), (4, 4), torch.float32, device="cpu")
    assert torch.equal(n, a)


def test_random_normal_takes_the_reference_argument_order():
    """``(generator, shape, dtype, stddev, mean)`` as the JAX package's
    ``(key, shape, dtype, stddev, mean)``, with ``device`` after them."""
    base = ext.random_normal(make_generator(4), (3,), torch.float64, device="cpu")
    got = ext.random_normal(make_generator(4), (3,), torch.float64, 2.0, 1.0, device="cpu")
    assert torch.equal(got, base * 2.0 + 1.0)


def test_default_device_is_the_card():
    """Entry points run on the card unless told otherwise: without a
    device they put the samples on CUDA, or raise where there is none --
    never a quiet CPU tensor."""
    g = make_generator(0)
    for draw in (lambda: ext.random_vector(g, 4), lambda: ext.random_uniform(g, (2,)),
                 lambda: ext.random_orthogonal(g, 3), lambda: ext.random_hermitian(g, 3)):
        if torch.cuda.is_available():
            assert draw().is_cuda
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                draw()
