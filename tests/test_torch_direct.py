"""The tridiagonal operators of the port (``solvers/direct.py``) against the
JAX package's, f64 on the CPU, on the same numpy-seeded bands.

On the CPU the port solves with LAPACK ``gtsv`` (the JAX package with
``lax.linalg.tridiagonal_solve``, which is LAPACK ``gtsv`` on the CPU as
well); the card's route (cuSPARSE ``gtsv2``) is held to it in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.  Tolerances: matvec and
matmat 1e-12 relative against the reference; BASELINE config 1 at its full
size (n = 10^4, sigma = -1e-6, the lowest 5 pairs, full
reorthogonalisation) 1e-10 against the closed form 2 - 2 cos(k pi/(n+1)),
as ``tests/test_baseline_configs.py`` holds the reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eigenex_tpu.solvers.direct as jdirect
from eigenex_tpu_torch import (
    LanczosEigenSolver,
    LanczosOptions,
    tridiagonal_operator,
    tridiagonal_shift_invert_operator,
)
from eigenex_tpu_torch.solvers import direct
from eigenex_tpu_torch.utils.exceptions import EigenexError

torch.set_num_threads(1)


def close(x, ref, rel=1e-12):
    x, ref = np.asarray(x), np.asarray(ref)
    assert x.shape == ref.shape
    assert np.linalg.norm(x - ref) <= rel * np.linalg.norm(ref), np.linalg.norm(x - ref)


def bands(n, seed, full_length):
    rng = np.random.default_rng(seed)
    d = 4.0 + rng.standard_normal(n)
    m = n if full_length else n - 1
    return rng.standard_normal(m), d, rng.standard_normal(m)


@pytest.mark.parametrize("full_length", [True, False], ids=["length_n", "length_n-1"])
def test_operator_and_solve_match_reference(full_length):
    n = 50
    dl, d, du = bands(n, 3, full_length)
    rng = np.random.default_rng(4)
    x, X = rng.standard_normal(n), rng.standard_normal((n, 3))
    A = tridiagonal_operator(dl, d, du, device="cpu")
    jA = jdirect.tridiagonal_operator(dl, d, du)
    assert A.dtype == torch.float64 and A.shape == (n, n)
    close(A.matvec(torch.as_tensor(x)), jA.matvec(jnp.asarray(x)))
    close(A.matmat(torch.as_tensor(X)), np.stack([jA.matvec(jnp.asarray(c)) for c in X.T], 1))
    sigma = 0.3
    si = tridiagonal_shift_invert_operator(dl, d, du, sigma, device="cpu")
    jsi = jdirect.tridiagonal_shift_invert_operator(dl, d, du, sigma)
    close(si.matvec(torch.as_tensor(x)), jsi.matvec(jnp.asarray(x)))
    close(si.matmat(torch.as_tensor(X)), jsi.matmat(jnp.asarray(X)))
    # (A - sigma I) applied to the solve gives the right-hand side back
    close(A.matmat(si.matmat(torch.as_tensor(X))) - sigma * si.matmat(torch.as_tensor(X)), X,
          rel=1e-12)


def test_band_conventions():
    """dl[0] and du[-1] are ignored (set to 0), as by tridiagonal_solve."""
    n = 6
    dl, d, du = np.arange(1.0, n + 1), np.full(n, 5.0), np.arange(10.0, 10 + n)
    A = tridiagonal_operator(dl, d, du, device="cpu")
    dense = A.matmat(torch.eye(n, dtype=torch.float64)).numpy()
    want = np.diag(d) + np.diag(dl[1:], -1) + np.diag(du[:-1], 1)
    np.testing.assert_array_equal(dense, want)
    with pytest.raises(EigenexError, match="length n or n-1"):
        tridiagonal_operator(dl[:3], d, du, device="cpu")


def test_float32_bands_solve_in_float32():
    dl, d, du = bands(40, 5, False)
    si = tridiagonal_shift_invert_operator(dl, d, du, 0.1, dtype=np.float32, device="cpu")
    x = np.random.default_rng(6).standard_normal(40).astype(np.float32)
    y = si.matvec(torch.as_tensor(x))
    assert y.dtype == torch.float32
    jy = jdirect.tridiagonal_shift_invert_operator(dl, d, du, 0.1, dtype=jnp.float32).matvec(
        jnp.asarray(x))
    close(y, np.asarray(jy), rel=1e-5)  # f32 pivoting order may differ
    assert direct.gtsv2_calls() == 0  # the card's route only


def test_config1_laplacian_lowest5_full_size():
    """BASELINE config 1 at n = 10^4 through the exact shift-invert operator."""
    n, sigma = 10_000, -1e-6
    d = np.full(n, 2.0)
    off = np.full(n - 1, -1.0)
    si = tridiagonal_shift_invert_operator(off, d, off, sigma, dtype=np.float64, device="cpu")
    res = LanczosEigenSolver(
        si,
        LanczosOptions(
            max_eigenvalues=5,
            eigenvalue_indices=(-5, -4, -3, -2, -1),  # largest theta
            tolerance=1e-14,
            max_subspace=40,
            reorthogonalize_interval=1,
            compute_eigenvectors=False,
        ),
    ).compute()
    theta = np.sort(np.asarray(res.eigenvalues))[::-1][:5]
    lam = np.sort(sigma + 1.0 / theta)
    exact = 2 - 2 * np.cos(np.arange(1, 6) * np.pi / (n + 1))
    err = np.max(np.abs(lam - exact))
    assert err <= 1e-10, f"config 1 error {err:.2e}"
