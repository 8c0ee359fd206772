"""Krylov-Schur of the port against the JAX package's, f64 on the CPU, with
the same numpy-seeded operators and the same explicit start vector (mirrors
``tests/test_krylov_schur.py``).

Tolerances: the restart's host pieces (ordered Schur form, the real-basis
span reduction, the basis compression) 1e-12; eigenvalues 1e-10 against the
reference's solve (conjugation-insensitive: the two members of a conjugate
pair tie in |lambda|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eigenex_tpu.solvers.krylov_schur as jks
from eigenex_tpu.solvers.restart import _compress_basis as j_compress
from eigenex_tpu_torch import KrylovSchurArnoldiSolver, KrylovSchurOptions
from eigenex_tpu_torch.solvers import krylov_schur as tks
from eigenex_tpu_torch.solvers.restart import _compress_basis
from eigenex_tpu_torch.utils.exceptions import ArnoldiError

torch.set_num_threads(1)


def canon(v):
    v = np.asarray(v)
    return np.sort_complex(np.where(v.imag < 0, np.conj(v), v))


def solve_both(A, v0, **opts):
    j = jks.KrylovSchurArnoldiSolver(jnp.asarray(A), jks.KrylovSchurOptions(**opts))
    t = KrylovSchurArnoldiSolver(torch.as_tensor(A), KrylovSchurOptions(**opts))
    return (j.set_initial_vector(jnp.asarray(v0)).compute(),
            t.set_initial_vector(v0).compute())


def test_real_clustered_dominant():
    rng = np.random.default_rng(0)
    n = 300
    d = np.linspace(1.0, 4.0, n)
    d[-1], d[-2] = 4.3, 4.2
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    A = Q @ np.diag(d) @ Q.T
    rj, rt = solve_both(A, rng.standard_normal(n), max_eigenvalues=2, tolerance=1e-10,
                        max_subspace=30, max_restarts=100)
    assert rt.converged and rt.iterations == rj.iterations
    np.testing.assert_allclose(np.sort(rt.eigenvalues.real), [4.2, 4.3], atol=1e-7)
    np.testing.assert_allclose(canon(rt.eigenvalues), canon(rj.eigenvalues), atol=1e-10)


@pytest.mark.parametrize("dtype,k,m", [(np.float64, 4, 40), (np.complex128, 3, 30)],
                         ids=["real_complex_pairs", "complex_operator"])
def test_against_reference_and_dense_oracle(dtype, k, m):
    rng = np.random.default_rng(1)
    n = 120 if dtype == np.float64 else 80
    A = rng.standard_normal((n, n))
    if dtype == np.complex128:
        A = A + 1j * rng.standard_normal((n, n))
    v0 = rng.standard_normal(n).astype(dtype)
    rj, rt = solve_both(A, v0, max_eigenvalues=k, tolerance=1e-9, max_subspace=m,
                        max_restarts=150)
    # no iteration count compared: a restart that cuts between the two
    # members of a conjugate pair (a tie in |lambda|) picks one by rounding,
    # so the two packages may take different restart paths to the same pairs
    assert rt.converged and rj.converged
    np.testing.assert_allclose(canon(rt.eigenvalues), canon(rj.eigenvalues), atol=1e-10)
    ref = np.linalg.eigvals(A)
    ref = ref[np.argsort(-np.abs(ref), kind="stable")][:k]
    np.testing.assert_allclose(canon(rt.eigenvalues), canon(ref), atol=1e-6)
    X = rt.eigenvectors.numpy()
    r = A.astype(complex) @ X - X * rt.eigenvalues[None, :]
    assert np.linalg.norm(r, axis=0).max() < 1e-6  # residual certificate


@pytest.mark.parametrize("which", ["LM", "SM", "LR", "SR", "LI", "SI"])
def test_which_key_and_ordered_schur_match(which):
    rng = np.random.default_rng(2)
    H = np.triu(rng.standard_normal((12, 12)), -1)  # upper Hessenberg, real
    evals = np.linalg.eigvals(H)
    np.testing.assert_array_equal(tks._which_key(evals, which), jks._which_key(evals, which))
    T, Q, w = tks._ordered_schur(H, 5, which)
    Tj, Qj, wj = jks._ordered_schur(H, 5, which)
    np.testing.assert_allclose(T, Tj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(Q, Qj, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(w, wj)
    with pytest.raises(ArnoldiError, match="which"):
        tks._which_key(evals, "XX")


@pytest.mark.parametrize("complex_basis", [False, True], ids=["real_basis", "complex_basis"])
def test_restart_compression_matches(complex_basis):
    """The restart of a real basis keeps the real span of the kept Schur
    vectors (SVD, rank cut 1e-10), reducing their count until it fits m - 2;
    the compressed basis is qs^T V with the residual row after it."""
    rng = np.random.default_rng(3)
    k, m, n = 12, 13, 50  # 2 x 7 kept vectors > m - 2: the count is reduced
    H = np.triu(rng.standard_normal((k, k)), -1)
    _, Q, _ = jks._ordered_schur(H, 7, "LM")
    qs = tks._restart_coefficients(Q, 7, m, complex_basis)
    if complex_basis:
        np.testing.assert_array_equal(qs, Q[:, :7])
    else:
        # the reference's loop, as written in eigenex_tpu/solvers/krylov_schur.py
        for pk_try in range(7, 0, -1):
            Qk = Q[:, :pk_try]
            span = np.concatenate([Qk.real, Qk.imag], axis=1)
            u, s, _ = np.linalg.svd(span, full_matrices=False)
            cand = u[:, : int(np.sum(s > s[0] * 1e-10))]
            if cand.shape[1] <= m - 2:
                break
        assert qs.shape == cand.shape and qs.shape[1] <= m - 2 and np.isrealobj(qs)
        np.testing.assert_allclose(qs, cand, rtol=0, atol=1e-12)
    V = rng.standard_normal((m + 1, n))
    if complex_basis:
        V = V + 1j * rng.standard_normal((m + 1, n))
    qs_dev = qs if complex_basis else qs.astype(V.dtype)
    got = _compress_basis(torch.as_tensor(V), qs_dev, torch.as_tensor(V[k])).numpy()
    want = np.asarray(j_compress(jnp.asarray(V), jnp.asarray(qs_dev), jnp.asarray(V[k])))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_rejects_too_small_subspace():
    with pytest.raises(ArnoldiError, match="too small"):
        KrylovSchurArnoldiSolver(torch.eye(10, dtype=torch.float64),
                                 KrylovSchurOptions(max_eigenvalues=5, max_subspace=6)).compute()
