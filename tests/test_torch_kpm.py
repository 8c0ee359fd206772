"""KPM parity on the CPU in f64.

``_moment_recurrence`` takes the probe block, so it is held to the JAX package
to 1e-10 on the same numpy-made Rademacher block.  ``chebyshev_moments`` draws
its probes from each package's own generator and takes no block, so
``eigenvalue_count``, ``spectral_density`` and ``eigsh_range`` are held to a
dense ``numpy.linalg.eigh`` of the same small matrix: counts within the slack
the reference's own tests use (``max(10 %, 6)`` for an interval, 3 % for the
whole spectrum: ``tests/test_kpm.py``), the eigenvalues in the range to 1e-8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eigenex_tpu as ex
import eigenex_tpu_torch as ext
from eigenex_tpu.solvers import kpm as jk
from eigenex_tpu_torch.solvers import kpm as tk
from eigenex_tpu_torch.sparse.bsr import bsr_from_dense
from eigenex_tpu_torch.sparse.sym_bsr import sym_bsr_from_bsr
from eigenex_tpu_torch.utils.exceptions import EigenexError, LanczosError

torch.set_num_threads(1)

N = 96


def matrix(seed=0):
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((N, N))
    return np.diag(np.arange(1, N + 1) * 1.0) + 0.05 * (noise + noise.T)


@pytest.mark.parametrize("n_moments", [1, 2, 40])
def test_moment_recurrence_matches_reference(n_moments):
    A = matrix()
    w = np.linalg.eigvalsh(A)
    lo, hi = w[0] - 1.0, w[-1] + 1.0
    Z = np.sign(np.random.default_rng(1).standard_normal((N, 6)))
    mj = np.asarray(jk._moment_recurrence(
        ex.aslinearoperator(jnp.asarray(A)), jnp.asarray(Z), lo, hi, jnp.asarray(float(N)),
        n_moments=max(n_moments, 2)))[:n_moments]
    mt = tk._moment_recurrence(ext.aslinearoperator(torch.as_tensor(A)), torch.as_tensor(Z),
                               lo, hi, float(N), n_moments=n_moments).numpy()
    assert mt.shape == (n_moments,) and mt.dtype == np.float64
    np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-10)
    assert mt[0] == 1.0  # unit-modulus probes: mu_0 = 1 exactly
    # exact moments of this spectrum, within the Hutchinson noise of 6 probes
    t = (2 * w - (hi + lo)) / (hi - lo)
    exact = np.array([np.mean(np.cos(k * np.arccos(t))) for k in range(n_moments)])
    assert np.abs(mt - exact).max() < 0.1


def test_jackson_and_count_formula_match_reference_on_the_same_moments():
    A = matrix(seed=2)
    np.testing.assert_array_equal(tk._jackson(64), jk._jackson(64))
    mu = tk.chebyshev_moments(A, 64, n_probes=8, spectral_bounds=(0.0, 98.0), seed=3,
                              device="cpu")
    assert mu[0].shape == (64,) and abs(mu[0][0] - 1.0) < 1e-12
    for interval in ((10.0, 30.0), (-5.0, 50.0), (60.0, 200.0)):
        got = tk.eigenvalue_count(torch.as_tensor(A), interval, _moments=mu)
        ref = jk.eigenvalue_count(jnp.asarray(A), interval, _moments=mu)
        assert abs(got - ref) < 1e-10


@pytest.mark.parametrize("operand", ["dense", "sym_bsr"])
def test_eigenvalue_count_against_dense_eigh(operand):
    A = matrix(seed=4)
    w = np.linalg.eigvalsh(A)
    op = (A if operand == "dense"
          else sym_bsr_from_bsr(bsr_from_dense(A, (8, 8), device="cpu")))
    kw = dict(device="cpu") if operand == "dense" else {}
    for a, b in ((w[10] - 0.5, w[30] + 0.5), (w[50] - 0.5, w[89] + 0.5)):
        true = int(np.count_nonzero((w >= a) & (w <= b)))
        est = ext.eigenvalue_count(op, (a, b), n_moments=200, n_probes=32, seed=1, **kw)
        assert abs(est - true) < max(0.10 * true, 6), (est, true)
    whole = ext.eigenvalue_count(op, (w[0] - 0.5, w[-1] + 0.5), n_moments=120, n_probes=16, **kw)
    assert abs(whole - N) < 0.03 * N


def test_spectral_density_integrates_to_n():
    A = matrix(seed=5)
    grid, rho = ext.spectral_density(A, 96, n_probes=16, grid=300, device="cpu")
    assert grid.shape == rho.shape == (300,) and np.all(np.diff(grid) > 0)
    # Chebyshev nodes: integral = sum rho * d(lambda) with d = ext * pi/grid * sqrt(1-t^2)
    ext_half = (grid[-1] - grid[0]) / 2 / np.cos(np.pi * 0.5 / 300)
    t = (grid - (grid[-1] + grid[0]) / 2) / ext_half
    total = np.sum(rho * ext_half * np.pi / 300 * np.sqrt(1 - t**2))
    assert abs(total - N) < 0.02 * N


def test_eigsh_range_against_dense_eigh_and_reference():
    A = matrix(seed=6)
    w = np.linalg.eigvalsh(A)
    interval = (w[10] - 0.5, w[24] + 0.5)
    rt = ext.eigsh_range(A, interval, block_size=8, slack=3, degree=60, tol=1e-10, device="cpu")
    assert rt.converged and rt.termination == "converged"
    assert len(rt.eigenvalues) == 15
    np.testing.assert_allclose(rt.eigenvalues, w[10:25], rtol=0, atol=1e-8)
    X = rt.eigenvectors
    assert isinstance(X, np.ndarray) and X.shape == (N, 15)
    assert np.abs(A @ X - X * rt.eigenvalues[None, :]).max() < 1e-6
    rj = ex.eigsh_range(jnp.asarray(A), interval, block_size=8, slack=3, degree=60, tol=1e-10)
    assert len(rj.eigenvalues) == 15
    np.testing.assert_allclose(rt.eigenvalues, np.asarray(rj.eigenvalues), rtol=0, atol=1e-8)


def test_eigsh_range_on_accelerated_operator():
    rng = np.random.default_rng(7)
    n = 100
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
    acc = ext.accelerate((rows, cols, vals, (n, n)), block=4, dtype=torch.float64, device="cpu")
    # the window excludes 0, where the 28 pad rows would sit if probes touched them
    interval = (w[40] - 0.05, w[50] + 0.05)
    rt = ext.eigsh_range(acc, interval, block_size=8, slack=3, degree=80, tol=1e-10,
                         spectral_bounds=(w[0] - 1.0, w[-1] + 1.0))
    assert rt.converged and len(rt.eigenvalues) == 11
    np.testing.assert_allclose(rt.eigenvalues, w[40:51], rtol=0, atol=1e-8)
    assert rt.eigenvectors.shape == (n, 11)
    assert np.abs(dense @ rt.eigenvectors - rt.eigenvectors * rt.eigenvalues[None, :]).max() < 1e-6
    # pad rows stay out of the trace: mu_0 = 1 with the probe support declared
    mu, _ = tk.chebyshev_moments(acc.matrix, 8, n_probes=4, probe_rows=acc.n_work,
                                 spectral_bounds=(w[0] - 1.0, w[-1] + 1.0))
    assert abs(mu[0] - 1.0) < 1e-12


def test_validation_and_unported_routes():
    A = torch.as_tensor(matrix(seed=8))
    with pytest.raises(LanczosError, match="a < b"):
        ext.eigsh_range(A, (3.0, 1.0))
    with pytest.raises(LanczosError, match="square"):
        ext.chebyshev_moments(torch.ones(4, 6, dtype=torch.float64), 8)
    # mesh= is ported for block-sparse operands; a dense one is refused as
    # the reference refuses it
    mesh = ext.make_mesh(devices=["cpu"] * 2)
    for call in (lambda: ext.eigsh_range(A, (1.0, 2.0), mesh=mesh),
                 lambda: ext.chebyshev_moments(A, 8, mesh=mesh),
                 lambda: ext.eigenvalue_count(A, (1.0, 2.0), mesh=mesh),
                 lambda: ext.spectral_density(A, 8, mesh=mesh)):
        with pytest.raises(LanczosError, match="mesh= requires a block-sparse operand"):
            call()


def test_eigsh_range_on_complexified_operator_matches_reference():
    """Raw KPM counts over the real embedding are twice the true ones: the
    slices are sized on the halved total, the bisection runs on raw counts,
    and each slice dedups its doubled pairs -- every eigenvalue in the
    interval once, as the reference finds them (1e-10, counts equal)."""
    from test_torch_chebyshev import complex_chain

    trip, dense = complex_chain(n=80, seed=13)
    w = np.linalg.eigvalsh(dense)
    interval = (w[20] - 0.01, w[31] + 0.01)
    bounds = (w[0] - 0.5, w[-1] + 0.5)
    jacc = ex.accelerate(trip, block=4, dtype=jnp.float64, symmetric=True)
    tacc = ext.accelerate(trip, block=4, dtype=torch.float64, symmetric=True, device="cpu")
    assert tacc.complexified
    kw = dict(block_size=12, slack=4, degree=80, tol=1e-12, spectral_bounds=bounds)
    rt = ext.eigsh_range(tacc, interval, **kw)
    rj = ex.eigsh_range(jacc, interval, **kw)
    assert rt.converged and len(rt.eigenvalues) == len(rj.eigenvalues) == 12
    np.testing.assert_allclose(rt.eigenvalues, np.asarray(rj.eigenvalues), rtol=0, atol=1e-10)
    np.testing.assert_allclose(rt.eigenvalues, w[20:32], rtol=0, atol=1e-10)
    Z = rt.eigenvectors
    assert Z.shape == (80, 12) and np.abs(dense @ Z - Z * rt.eigenvalues[None, :]).max() < 1e-8
