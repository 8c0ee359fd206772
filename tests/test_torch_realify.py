"""The real embedding of the port against the JAX package's, on the same
numpy-seeded complex operators (mirrors ``tests/test_realify.py``).

Tolerances: the embedded triplets exactly; embedded products 1e-12;
eigenvalues 1e-10 against the reference's solve with the same start
vector, and ``eigs_realified`` (whose start both packages draw from a seed
of their own) against ``numpy.linalg.eig`` as the reference's test does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eigenex_tpu.sparse.realify as jre
from eigenex_tpu import LanczosEigenSolver as JLanczos
from eigenex_tpu import LanczosOptions as JLanczosOptions
from eigenex_tpu.sparse.coo import coo_from_dense as j_coo
from eigenex_tpu_torch import (
    LanczosEigenSolver,
    LanczosOptions,
    coo_from_dense,
    complex_from_real,
    dedup_doubled_eigenvalues,
    eigs_realified,
    real_from_complex,
    realify_coo,
)
from eigenex_tpu_torch.utils.exceptions import EigenexError

torch.set_num_threads(1)


def complex_hermitian(n=40, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    A[rng.random((n, n)) > 0.3] = 0
    return (A + A.conj().T) / 2


def complex_general(n=40, seed=3):
    rng = np.random.default_rng(seed)
    A = np.diag(np.arange(1, n + 1) * (1 + 0.5j)).astype(np.complex128)
    return A + 0.05 * (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))


def test_embedding_matches_reference_and_acts_like_h():
    H = complex_hermitian()
    R = realify_coo(coo_from_dense(H, device="cpu"))
    Rj = jre.realify_coo(j_coo(H))
    assert R.shape == Rj.shape == (80, 80) and R.dtype == torch.float64
    for got, want in ((R.row, Rj.row), (R.col, Rj.col), (R.val, Rj.val)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rng = np.random.default_rng(42)
    z = rng.standard_normal(40) + 1j * rng.standard_normal(40)
    zr = real_from_complex(torch.as_tensor(z))
    np.testing.assert_array_equal(zr.numpy(), np.asarray(jre.real_from_complex(jnp.asarray(z))))
    np.testing.assert_allclose(complex_from_real(R.matvec(zr)), H @ z, rtol=0, atol=1e-12)
    Rd = R.to_dense()
    np.testing.assert_allclose(Rd, Rd.T, atol=1e-14)  # Hermitian -> real symmetric
    ev_r, ev_c = np.linalg.eigvalsh(Rd), np.linalg.eigvalsh(H)
    np.testing.assert_allclose(ev_r, np.sort(np.repeat(ev_c, 2)), atol=1e-10)
    np.testing.assert_allclose(dedup_doubled_eigenvalues(ev_r), ev_c, atol=1e-8)
    np.testing.assert_array_equal(dedup_doubled_eigenvalues(ev_r),
                                  jre.dedup_doubled_eigenvalues(ev_r))
    real = coo_from_dense(np.eye(3), device="cpu")
    assert realify_coo(real) is real
    with pytest.raises(EigenexError, match="even"):
        complex_from_real(np.ones(3))


def test_lanczos_on_realified_matches_reference():
    """A complex Hermitian ground state with real arithmetic only."""
    n = 60
    H = 2.0 * np.eye(n, dtype=np.complex128) - 1j * np.eye(n, k=1) + 1j * np.eye(n, k=-1)
    ref = np.linalg.eigvalsh(H)
    v0 = np.random.default_rng(0).standard_normal(2 * n)
    opts = dict(max_eigenvalues=2, tolerance=1e-14, max_subspace=2 * n)
    R = realify_coo(coo_from_dense(H, device="cpu"))
    res = LanczosEigenSolver(R.as_linear_operator(), LanczosOptions(**opts)) \
        .set_initial_vector(v0).compute()
    rj = JLanczos(jre.realify_coo(j_coo(H)).as_linear_operator(), JLanczosOptions(**opts)) \
        .set_initial_vector(jnp.asarray(v0)).compute()
    np.testing.assert_allclose(res.eigenvalues, np.asarray(rj.eigenvalues), rtol=0, atol=1e-10)
    np.testing.assert_allclose(dedup_doubled_eigenvalues(res.eigenvalues)[:1], ref[:1], atol=1e-9)
    v = complex_from_real(res.eigenvectors[:, 0])
    assert np.linalg.norm(H @ v - ref[0] * v) < 1e-7


def test_embedding_of_general_is_lambda_and_conj():
    A = complex_general(12)
    R = realify_coo(coo_from_dense(A, device="cpu")).to_dense()
    ev_c = np.linalg.eigvals(A)
    both = np.sort_complex(np.concatenate([ev_c, np.conj(ev_c)]))
    np.testing.assert_allclose(np.sort_complex(np.linalg.eigvals(R)), both, atol=1e-10)


@pytest.mark.parametrize("refine", [False, True], ids=["plain", "refined"])
def test_eigs_realified_matches_numpy_eig(refine):
    A = complex_general(40)
    lam, X, res = eigs_realified(coo_from_dense(A, device="cpu"), k=3,
                                 tol=1e-12 if not refine else 1e-10, max_subspace=60, refine=refine)
    true = np.linalg.eigvals(A)
    true = true[np.argsort(-np.abs(true))][:3]
    np.testing.assert_allclose(np.sort_complex(lam), np.sort_complex(true),
                               atol=1e-11 if refine else 1e-7)
    np.testing.assert_allclose(np.abs(lam), np.sort(np.abs(true))[::-1])  # |lambda|-descending
    assert X.shape == (40, 3) and np.iscomplexobj(X)
    for j in range(3):
        assert res[j] <= (1e-11 if refine else 1e-6) * np.max(np.abs(lam))


def test_eigs_realified_conjugate_paired_spectrum_dedups():
    rng = np.random.default_rng(7)
    A = np.diag(np.arange(1.0, 21.0)).astype(np.complex128) + 0.3 * rng.standard_normal((20, 20))
    lam, _, _ = eigs_realified(coo_from_dense(A, device="cpu"), k=4, tol=1e-12, max_subspace=38)
    true = np.linalg.eigvals(A)
    true = true[np.argsort(-np.abs(true))][:4]
    np.testing.assert_allclose(np.sort_complex(lam), np.sort_complex(true), atol=1e-6)
    with pytest.raises(EigenexError, match="complex"):
        eigs_realified(coo_from_dense(np.eye(8), device="cpu"), k=2)
