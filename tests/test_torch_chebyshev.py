"""Chebyshev filter parity in f64 on the CPU: the port against the JAX package
on the same numpy-seeded operator, the same start block and the same spectral
bounds (the default bounds come from a seeded probe, which the two packages
draw differently).

Tolerances: a filter application to 1e-12 relative (same recurrence, rounding
order only); window eigenvalues to 1e-8 with the same count in the window and
the same number of outer iterations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eigenex_tpu as ex
import eigenex_tpu_torch as ext
from eigenex_tpu.solvers import chebyshev as jc
from eigenex_tpu_torch.solvers import chebyshev as tc
from eigenex_tpu_torch.sparse.bsr import bsr_from_dense
from eigenex_tpu_torch.sparse.sym_bsr import sym_bsr_from_bsr
from eigenex_tpu_torch.utils.exceptions import EigenexError, LanczosError

torch.set_num_threads(1)

N = 96


def matrix(seed=0):
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((N, N))
    return np.diag(np.arange(1, N + 1) * 1.0) + 0.05 * (noise + noise.T)


def operators(A):
    return ex.aslinearoperator(jnp.asarray(A)), ext.aslinearoperator(torch.as_tensor(A))


def test_filter_apply_matches_reference():
    A = matrix()
    jop, top = operators(A)
    X = np.random.default_rng(1).standard_normal((N, 5))
    ref = np.asarray(jc.chebyshev_filter_apply(jop, jnp.asarray(X), 20.0, 97.0, degree=12))
    got = tc.chebyshev_filter_apply(top, torch.as_tensor(X), 20.0, 97.0, degree=12).numpy()
    assert np.linalg.norm(got - ref) <= 1e-12 * np.linalg.norm(ref)


@pytest.mark.parametrize("degree", [1, 2, 25])
def test_bandpass_apply_and_coefficients_match_reference(degree):
    A = matrix(seed=2)
    jop, top = operators(A)
    X = np.random.default_rng(3).standard_normal((N, 4))
    cj = jc._bandpass_coefficients(-0.2, 0.1, degree)
    ct = tc._bandpass_coefficients(-0.2, 0.1, degree)
    np.testing.assert_array_equal(ct, cj)
    ref = np.asarray(jc.chebyshev_bandpass_apply(jop, jnp.asarray(X), 0.0, 98.0, cj, degree=degree))
    got = tc.chebyshev_bandpass_apply(top, torch.as_tensor(X), 0.0, 98.0, ct, degree=degree).numpy()
    assert np.linalg.norm(got - ref) <= 1e-12 * np.linalg.norm(ref)


def test_cholesky_qr2_matches_reference():
    X = np.random.default_rng(4).standard_normal((N, 6)) @ np.diag([1, 2, 5, 10, 50, 100.0])
    Qj = np.asarray(jc.cholesky_qr2(jnp.asarray(X)))
    Qt = tc.cholesky_qr2(torch.as_tensor(X)).numpy()
    np.testing.assert_allclose(Qt, Qj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(Qt.T @ Qt, np.eye(6), rtol=0, atol=1e-13)


@pytest.mark.parametrize("orth", ["qr", "cholesky_qr2"])
def test_solver_matches_reference_in_window(orth):
    A = matrix(seed=5)
    w = np.linalg.eigvalsh(A)
    window = (w[40] - 0.3, w[44] + 0.3)
    bounds = (w[0] - 1.0, w[-1] + 1.0)
    X0 = np.random.default_rng(6).standard_normal((N, 8))
    oj = ex.ChebyshevFilterOptions(degree=40, tolerance=1e-10, spectral_bounds=bounds)
    ot = ext.ChebyshevFilterOptions(degree=40, tolerance=1e-10, spectral_bounds=bounds)
    kj = dict(orthonormalize=jc.cholesky_qr2) if orth == "cholesky_qr2" else {}
    kt = dict(orthonormalize=tc.cholesky_qr2) if orth == "cholesky_qr2" else {}
    rj = ex.ChebyshevFilterSolver(jnp.asarray(A), window, oj, block_size=8,
                                  initial_block=jnp.asarray(X0), **kj).compute()
    rt = ext.ChebyshevFilterSolver(torch.as_tensor(A), window, ot, block_size=8,
                                   initial_block=torch.as_tensor(X0), **kt).compute()
    assert rt.converged and rt.termination == rj.termination == "converged"
    assert rt.iterations == rj.iterations
    assert len(rt.eigenvalues) == len(rj.eigenvalues) == 5  # same count in the window
    np.testing.assert_allclose(rt.eigenvalues, np.asarray(rj.eigenvalues), rtol=0, atol=1e-8)
    np.testing.assert_allclose(rt.eigenvalues, w[40:45], rtol=0, atol=1e-8)
    X = rt.eigenvectors.numpy()
    assert np.abs(A @ X - X * rt.eigenvalues[None, :]).max() < 1e-6


def test_eigsh_window_matches_reference_and_dense():
    A = matrix(seed=7)
    w = np.linalg.eigvalsh(A)
    window = (w[10] - 0.4, w[13] + 0.4)
    bounds = (w[0] - 1.0, w[-1] + 1.0)
    rj = ex.eigsh_window(jnp.asarray(A), window, block_size=8, degree=40, tol=1e-10,
                         spectral_bounds=bounds)
    rt = ext.eigsh_window(A, window, block_size=8, degree=40, tol=1e-10,
                          spectral_bounds=bounds, device="cpu")
    assert rj.converged and rt.converged
    assert len(rt.eigenvalues) == len(rj.eigenvalues) == 4
    np.testing.assert_allclose(rt.eigenvalues, np.asarray(rj.eigenvalues), rtol=0, atol=1e-8)
    np.testing.assert_allclose(rt.eigenvalues, w[10:14], rtol=0, atol=1e-8)


def test_eigsh_window_default_bounds_from_container_and_from_probe():
    """No ``spectral_bounds``: Gershgorin for a container, the power probe for
    a dense operand.  Held to the dense spectrum."""
    A = matrix(seed=8)
    w = np.linalg.eigvalsh(A)
    window = (w[20] - 0.4, w[22] + 0.4)
    sym = sym_bsr_from_bsr(bsr_from_dense(A, (8, 8), device="cpu"))
    # the probe's bounds are symmetric about 0, twice the true span: a sharper filter
    for operand, degree in ((sym, 60), (torch.as_tensor(A), 150)):
        rt = ext.eigsh_window(operand, window, block_size=6, degree=degree, tol=1e-9)
        assert rt.converged and len(rt.eigenvalues) == 3
        np.testing.assert_allclose(rt.eigenvalues, w[20:23], rtol=0, atol=1e-8)
    lo, hi = tc.ChebyshevFilterSolver(sym, window)._spectral_bounds(sym.as_linear_operator())
    assert lo <= w[0] and hi >= w[-1]
    lo, hi = tc.ChebyshevFilterSolver(torch.as_tensor(A), window)._spectral_bounds(
        ext.aslinearoperator(torch.as_tensor(A)))
    assert lo <= w[0] and hi >= w[-1]


def test_eigsh_window_on_accelerated_operator_matches_reference():
    """Permuted, padded container: the start block is exactly zero on the pad
    rows, and eigenvectors come back in original coordinates."""
    rng = np.random.default_rng(9)
    n = 100  # pads to 128 with block 4 (32 block rows)
    r = np.repeat(np.arange(n), 2)
    c = r + rng.integers(1, 9, size=len(r))
    keep = c < n
    r, c = r[keep], c[keep]
    v = np.round(rng.standard_normal(len(r)) * 8) / 8
    rows = np.concatenate([r, c, np.arange(n)])
    cols = np.concatenate([c, r, np.arange(n)])
    vals = np.concatenate([v, v, np.round(np.linspace(1.0, 30.0, n) * 8) / 8])  # f32-exact: the pack is f32
    dense = np.zeros((n, n))
    np.add.at(dense, (rows, cols), vals)
    w = np.linalg.eigvalsh(dense)
    window = (w[50] - 0.05, w[53] + 0.05)
    bounds = (w[0] - 1.0, w[-1] + 1.0)
    jacc = ex.accelerate((rows, cols, vals, (n, n)), block=4, dtype=jnp.float64)
    tacc = ext.accelerate((rows, cols, vals, (n, n)), block=4, dtype=torch.float64, device="cpu")
    assert tacc.shape == jacc.shape and tacc.shape[0] > n
    X0 = tc._padding_safe_block(tacc.n_work, tacc.shape[0], 8, torch.float64, 0, "cpu")
    assert X0.shape == (tacc.shape[0], 8) and not X0[n:].any() and X0[:n].abs().min() > 0
    rj = ex.eigsh_window(jacc, window, block_size=8, degree=60, tol=1e-10, spectral_bounds=bounds)
    rt = ext.eigsh_window(tacc, window, block_size=8, degree=60, tol=1e-10, spectral_bounds=bounds)
    assert rt.converged and len(rt.eigenvalues) == len(rj.eigenvalues) == 4
    np.testing.assert_allclose(rt.eigenvalues, np.asarray(rj.eigenvalues), rtol=0, atol=1e-8)
    np.testing.assert_allclose(rt.eigenvalues, w[50:54], rtol=0, atol=1e-8)
    X = rt.eigenvectors
    assert isinstance(X, np.ndarray) and X.shape == (n, 4)
    assert np.abs(dense @ X - X * rt.eigenvalues[None, :]).max() < 1e-6


def test_empty_window_and_max_iterations():
    A = matrix(seed=10)
    w = np.linalg.eigvalsh(A)
    bounds = (w[0] - 1.0, w[-1] + 1.0)
    gap = ((w[30] + w[31]) / 2 - 0.01, (w[30] + w[31]) / 2 + 0.01)
    rt = ext.eigsh_window(A, gap, block_size=4, degree=30, max_iterations=3,
                          spectral_bounds=bounds, device="cpu")
    assert not rt.converged and rt.termination == "max_iterations"
    assert rt.eigenvalues.size == 0 and rt.eigenvectors is None and rt.trace.has_warn()


def test_validation_and_unported_routes():
    A = torch.as_tensor(matrix(seed=11))
    with pytest.raises(LanczosError, match="lo < hi"):
        ext.eigsh_window(A, (2.0, 1.0))
    with pytest.raises(LanczosError, match="no target window"):
        tc.ChebyshevFilterSolver(A).compute()
    with pytest.raises(LanczosError, match="covers the whole"):
        ext.eigsh_window(A, (-10.0, 200.0), spectral_bounds=(0.0, 100.0))
    with pytest.raises(LanczosError, match="exceeds n"):
        ext.eigsh_window(A, (1.0, 2.0), block_size=N + 1, spectral_bounds=(0.0, 100.0))
    with pytest.raises(LanczosError, match="initial_block"):
        tc.ChebyshevFilterSolver(A, (1.0, 2.0), block_size=4,
                                 initial_block=torch.ones(N, 3)).compute()
    # mesh= is ported for block-sparse operands; a dense one is refused as
    # the reference refuses it
    with pytest.raises(LanczosError, match="mesh= requires a block-sparse operand"):
        ext.eigsh_window(A, (1.0, 2.0), mesh=ext.make_mesh(devices=["cpu"] * 2))


def complex_chain(n=80, seed=12):
    """A complex Hermitian hopping chain (random phases, next-nearest hops,
    an on-site potential) with f32-exact values, as triplets, and its dense
    matrix."""
    rng = np.random.default_rng(seed)
    r, c, v = [], [], []
    for d, t in ((1, 1.0), (2, 0.35)):
        i = np.arange(n - d)
        h = t * np.exp(1j * rng.uniform(0, 2 * np.pi, n - d))
        r += [i, i + d]
        c += [i + d, i]
        v += [h, np.conj(h)]
    r.append(np.arange(n))
    c.append(np.arange(n))
    v.append(np.linspace(-1.0, 1.0, n) + 0j)
    r, c, v = np.concatenate(r), np.concatenate(c), np.concatenate(v)
    # f32-exact parts: the packers store f32 values even for an f64 pack
    v = v.real.astype(np.float32).astype(np.float64) + 1j * v.imag.astype(np.float32)
    dense = np.zeros((n, n), complex)
    np.add.at(dense, (r, c), v)
    return (r, c, v, (n, n)), dense


def test_eigsh_window_on_complexified_operator_matches_reference():
    """The real embedding holds every eigenvalue twice: the block is doubled,
    the window's doubled pairs deduped, the kept vectors normalised -- in both
    packages, to the same eigenvalues (1e-10) and counts."""
    trip, dense = complex_chain()
    w = np.linalg.eigvalsh(dense)
    window = (w[30] - 0.01, w[34] + 0.01)
    bounds = (w[0] - 0.5, w[-1] + 0.5)
    jacc = ex.accelerate(trip, block=4, dtype=jnp.float64, symmetric=True)
    tacc = ext.accelerate(trip, block=4, dtype=torch.float64, symmetric=True, device="cpu")
    assert tacc.complexified and tacc.n_work == 160 and np.array_equal(tacc.perm, jacc.perm)
    kw = dict(block_size=8, degree=80, tol=1e-12, spectral_bounds=bounds)
    rj = ex.eigsh_window(jacc, window, **kw)
    rt = ext.eigsh_window(tacc, window, **kw)
    assert rt.converged and len(rt.eigenvalues) == len(rj.eigenvalues) == 5
    np.testing.assert_allclose(np.sort(rt.eigenvalues), np.sort(np.asarray(rj.eigenvalues)),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(np.sort(rt.eigenvalues), w[30:35], rtol=0, atol=1e-10)
    Z = rt.eigenvectors
    assert Z.shape == (80, 5) and np.iscomplexobj(Z)
    np.testing.assert_allclose(np.linalg.norm(Z, axis=0), 1.0, rtol=0, atol=1e-12)
    assert np.abs(dense @ Z - Z * rt.eigenvalues[None, :]).max() < 1e-8
