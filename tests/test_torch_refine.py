"""Host f64 refinement of the port against the JAX package's, on the same
numpy-seeded operators and approximate pairs (mirrors
``tests/test_refine.py``).  Both are host numpy/scipy code; the port reads
its COOMatrix with ``.cpu().numpy()``.

Tolerance: refined eigenvalues, vectors and residuals 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import torch

import eigenex_tpu.solvers.refine as jr
from eigenex_tpu.sparse.coo import coo_from_dense as j_coo
from eigenex_tpu_torch import coo_from_dense
from eigenex_tpu_torch.solvers import refine as tr

torch.set_num_threads(1)
TOL = 1e-12


def both(A):
    return j_coo(A), coo_from_dense(A, device="cpu")


def symmetric(n=80, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    A = (A + A.T) / 2
    A[np.abs(A) < 0.8] = 0
    return (A + A.T) / 2


def perturbed_eigvecs(A, k, seed, hermitian=True):
    """Exact eigenvectors of A, perturbed at the f32 level (1e-5)."""
    rng = np.random.default_rng(seed)
    if hermitian:
        w, V = np.linalg.eigh(A)
        X = V[:, :k]
    else:
        w, V = np.linalg.eig(A)
        order = np.argsort(-np.abs(w))[:k]
        w, X = w[order], V[:, order]
    noise = rng.standard_normal(X.shape)
    if np.iscomplexobj(X):
        noise = noise + 1j * rng.standard_normal(X.shape)
    return w[:k], X + 1e-5 * noise


def test_rayleigh_and_inverse_iteration_match():
    A = symmetric()
    jc, tc = both(A)
    w, X0 = perturbed_eigvecs(A, 3, 1)
    lam_j, res_j = jr.rayleigh_refine(jc, X0)
    lam_t, res_t = tr.rayleigh_refine(tc, torch.as_tensor(X0))  # a tensor is taken as well
    np.testing.assert_allclose(lam_t, lam_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(res_t, res_j, rtol=0, atol=TOL)
    lam_j, X_j, r_j = jr.inverse_iteration_refine(jc, X0, iters=2)
    lam_t, X_t, r_t = tr.inverse_iteration_refine(tc, X0, iters=2)
    np.testing.assert_allclose(lam_t, lam_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(X_t, X_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(r_t, r_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(lam_t, w, atol=1e-11)  # f64 machine precision


def test_general_refine_matches():
    rng = np.random.default_rng(5)
    n = 50
    A = np.diag(np.arange(1.0, n + 1.0)) + 0.1 * rng.standard_normal((n, n))
    jc, tc = both(A)
    w, X0 = perturbed_eigvecs(A, 4, 0, hermitian=False)
    lam_j, res_j = jr.general_rayleigh_refine(jc, X0)
    lam_t, res_t = tr.general_rayleigh_refine(tc, X0)
    np.testing.assert_allclose(lam_t, lam_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(res_t, res_j, rtol=0, atol=TOL)
    lam_j, X_j, r_j = jr.general_inverse_iteration_refine(jc, X0, w + 1e-5, iters=3)
    lam_t, X_t, r_t = tr.general_inverse_iteration_refine(tc, X0, w + 1e-5, iters=3)
    np.testing.assert_allclose(lam_t, lam_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(X_t, X_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(r_t, r_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(lam_t, w, atol=1e-11)


def test_general_refine_complex_conjugate_pair():
    A = np.array([[0.0, -2.0], [2.0, 0.0]])
    A = np.block([[A, np.zeros((2, 3))], [np.zeros((3, 2)), np.diag([1.0, 2.0, 3.0])]])
    X0 = np.array([[1.0, 1.0], [1j, -1j], [0, 0], [0, 0], [0, 0]], np.complex128)
    lam, X, res = tr.general_inverse_iteration_refine(coo_from_dense(A, device="cpu"), X0,
                                                      np.array([2.1j, -2.1j]), iters=3)
    lam_j, X_j, _ = jr.general_inverse_iteration_refine(j_coo(A), X0, np.array([2.1j, -2.1j]),
                                                        iters=3)
    np.testing.assert_allclose(lam[np.argsort(lam.imag)], [-2j, 2j], atol=1e-12)
    np.testing.assert_allclose(lam, lam_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(X, X_j, rtol=0, atol=TOL)


def test_shift_invert_arnoldi_refine_matches():
    rng = np.random.default_rng(5)
    B = np.diag(np.arange(1.0, 41.0)) + np.triu(rng.standard_normal((40, 40)), 1)
    seed_vec = rng.standard_normal(40)
    jc, tc = both(B)
    lam_j, X_j, r_j = jr.shift_invert_arnoldi_refine(jc, 39.4 + 0.2j, k=3, m=25, v0=seed_vec)
    lam_t, X_t, r_t = tr.shift_invert_arnoldi_refine(tc, 39.4 + 0.2j, k=3, m=25,
                                                     v0=torch.as_tensor(seed_vec))
    np.testing.assert_allclose(lam_t, lam_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(X_t, X_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(r_t, r_j, rtol=0, atol=TOL)
    ref = np.sort(np.linalg.eigvals(B).real)[::-1][:3]
    np.testing.assert_allclose(np.sort(lam_t.real)[::-1], ref, atol=1e-9)
    # re-centering rounds from a bad shift, seeded start (same numpy seed)
    C = np.diag(np.linspace(1.0, 20.0, 30)) + 0.1 * rng.standard_normal((30, 30))
    jc, tc = both(C)
    lam_j, _, _ = jr.shift_invert_arnoldi_refine(jc, 25.0 + 0.5j, k=2, m=15, rounds=4)
    lam_t, _, res = tr.shift_invert_arnoldi_refine(tc, 25.0 + 0.5j, k=2, m=15, rounds=4)
    np.testing.assert_allclose(lam_t, lam_j, rtol=0, atol=TOL)
    assert np.max(res) < 1e-10
