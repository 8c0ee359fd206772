"""``ArnoldiEigenSolver`` of the port against the JAX package's, f64 on the
CPU, on the same numpy-seeded operators with the same explicit start vector
(the two packages draw different random starts from a seed).

Tolerances: basis and Hessenberg entries 1e-12; eigenvalues 1e-10 against
the reference's solve, and against ``numpy.linalg.eig`` where the reference's
own test uses that oracle (mirrors ``tests/test_arnoldi.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigenex_tpu.core.operators import aslinearoperator as j_aslinearoperator
from eigenex_tpu.solvers.arnoldi import ArnoldiEigenSolver as JArnoldi
from eigenex_tpu.solvers.arnoldi import ArnoldiOptions as JOptions
from eigenex_tpu.solvers.arnoldi import arnoldi_steps as j_arnoldi_steps
from eigenex_tpu.solvers.arnoldi import init_arnoldi_state as j_init
from eigenex_tpu_torch import ArnoldiEigenSolver, ArnoldiOptions, aslinearoperator, coo_from_dense
from eigenex_tpu_torch.solvers.arnoldi import arnoldi_steps, init_arnoldi_state
from eigenex_tpu_torch.utils.exceptions import ArnoldiError

torch.set_num_threads(1)


def gaussian(n, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    if dtype == np.complex128:
        A = (A + 1j * rng.standard_normal((n, n))) / np.sqrt(2)
    v0 = rng.standard_normal(n).astype(dtype)
    return A, v0


def sort_desc(v):
    return v[np.argsort(-np.abs(v), kind="stable")]


def canon(v):
    """Conjugation-insensitive sorted values (conjugate pairs tie in |lambda|)."""
    v = np.asarray(v)
    return np.sort_complex(np.where(v.imag < 0, np.conj(v), v))


def both(A, v0, opts, shift=None):
    j = JArnoldi(jnp.asarray(A), JOptions(**opts)).set_initial_vector(jnp.asarray(v0))
    t = ArnoldiEigenSolver(torch.as_tensor(A), ArnoldiOptions(**opts)).set_initial_vector(v0)
    if shift is not None:
        j.set_eigenvalue_shift(shift)
        t.set_eigenvalue_shift(shift)
    return j.compute(), t.compute()


@pytest.mark.parametrize("dtype", [np.float64, np.complex128], ids=["real", "complex"])
def test_basis_and_hessenberg_match_the_reference(dtype):
    A, v0 = gaussian(30, 0, dtype)
    jop = j_aslinearoperator(jnp.asarray(A))
    js = j_arnoldi_steps(jop, j_init(jop, 15, jnp.asarray(v0)), 15)
    op = aslinearoperator(torch.as_tensor(A))
    ts = arnoldi_steps(op, init_arnoldi_state(op, 15, v0), 15)
    assert int(ts.k) == int(js.k) == 15
    np.testing.assert_allclose(ts.H.numpy(), np.asarray(js.H), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ts.V.numpy(), np.asarray(js.V), rtol=0, atol=1e-12)
    V, H = ts.V.numpy(), ts.H.numpy()
    np.testing.assert_allclose(V.conj() @ V.T, np.eye(16), atol=1e-12)  # V^H V = I
    np.testing.assert_allclose(A @ V[:15].T, V.T @ H, atol=1e-11)  # A V_k = V_{k+1} H_k
    assert np.allclose(np.tril(H[:15, :15], -2), 0, atol=1e-13)


@pytest.mark.parametrize("dtype,k", [(np.float64, 4), (np.complex128, 3)], ids=["real", "complex"])
def test_dense_oracle_and_reference(dtype, k):
    A, v0 = gaussian(50 if dtype == np.float64 else 40, 1, dtype)
    n = A.shape[0]
    rj, rt = both(A, v0, dict(max_eigenvalues=k, tolerance=1e-12, max_subspace=n))
    assert rt.iterations == rj.iterations and rt.termination == rj.termination
    np.testing.assert_allclose(canon(rt.eigenvalues), canon(rj.eigenvalues), rtol=0, atol=1e-10)
    ref = sort_desc(np.linalg.eigvals(A))[:k]
    np.testing.assert_allclose(canon(rt.eigenvalues), canon(ref), atol=1e-8)
    assert np.all(rt.residual_norms(torch.as_tensor(A)) < 1e-7)  # ||A P - P D|| ~ 0
    assert rt.eigenvectors.is_complex() and rt.eigenvectors.shape == (n, k)


def test_dominant_subset_early_stop():
    n = 200
    d = np.linspace(1.0, 2.0, n)
    d[-1], d[-2] = 10.0, 8.0
    rng = np.random.default_rng(0)
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    A = Q @ np.diag(d) @ Q.T
    rj, rt = both(A, rng.standard_normal(n),
                  dict(max_eigenvalues=2, tolerance=1e-12, max_subspace=80))
    assert rt.converged and rt.iterations == rj.iterations < 80
    np.testing.assert_allclose(np.sort(rt.eigenvalues.real), [8.0, 10.0], atol=1e-7)
    np.testing.assert_allclose(rt.eigenvalues, np.asarray(rj.eigenvalues), rtol=0, atol=1e-10)


def test_breakdown_invariant_subspace():
    A = np.diag([3.0, 2.0, 1.0, 0.5])
    res = (ArnoldiEigenSolver(torch.as_tensor(A), ArnoldiOptions(max_eigenvalues=2, max_subspace=4))
           .set_initial_vector(np.array([1.0, 1.0, 0.0, 0.0])).compute())
    assert res.termination == "breakdown" and res.converged
    np.testing.assert_allclose(np.sort(res.eigenvalues.real), [2.0, 3.0], atol=1e-10)


def test_convection_diffusion_mini():
    """BASELINE config 2 in miniature, on the port's COO container."""
    nx, conv = 8, 0.5
    n = nx * nx
    A = np.zeros((n, n))
    for i in range(nx):
        for j in range(nx):
            u = i * nx + j
            A[u, u] = 4.0
            if i > 0:
                A[u, u - nx] = -1.0 - conv
            if i < nx - 1:
                A[u, u + nx] = -1.0 + conv
            if j > 0:
                A[u, u - 1] = -1.0 - conv
            if j < nx - 1:
                A[u, u + 1] = -1.0 + conv
    v0 = np.random.default_rng(2).standard_normal(n)
    opts = dict(max_eigenvalues=3, tolerance=1e-12, max_subspace=n)
    res = ArnoldiEigenSolver(coo_from_dense(A, device="cpu"), ArnoldiOptions(**opts)) \
        .set_initial_vector(v0).compute()
    ref = JArnoldi(jnp.asarray(A), JOptions(**opts)).set_initial_vector(jnp.asarray(v0)).compute()
    np.testing.assert_allclose(canon(res.eigenvalues), canon(ref.eigenvalues), atol=1e-10)
    np.testing.assert_allclose(canon(res.eigenvalues), canon(sort_desc(np.linalg.eigvals(A))[:3]),
                               atol=1e-8)


def test_shift_transparent():
    A, v0 = gaussian(30, 3)
    opts = dict(max_eigenvalues=2, max_subspace=30, tolerance=1e-12)
    rj, rt = both(A, v0, opts, shift=100.0)
    np.testing.assert_allclose(canon(rt.eigenvalues), canon(rj.eigenvalues), atol=1e-10)
    want = sort_desc(np.linalg.eigvals(A + 100 * np.eye(30)))[:2] - 100.0
    np.testing.assert_allclose(canon(rt.eigenvalues), canon(want), atol=1e-7)


def test_continue_to_compute_grows_the_subspace():
    A, v0 = gaussian(40, 4)
    s = ArnoldiEigenSolver(torch.as_tensor(A), ArnoldiOptions(max_eigenvalues=2, max_subspace=12,
                                                              tolerance=1e-12))
    first = s.set_initial_vector(v0).compute()
    assert first.termination == "max_iterations" and first.iterations == 12
    s.set_max_subspace(40)
    again = s.continue_to_compute()
    assert again.iterations > 12 and again.converged
    np.testing.assert_allclose(canon(again.eigenvalues),
                               canon(sort_desc(np.linalg.eigvals(A))[:2]), atol=1e-8)


def test_errors():
    with pytest.raises(ArnoldiError, match="no operator"):
        ArnoldiEigenSolver().compute()
    with pytest.raises(ArnoldiError, match="square"):
        ArnoldiEigenSolver(torch.ones(3, 4, dtype=torch.float64)).compute()
    with pytest.raises(ArnoldiError, match="compute"):
        ArnoldiEigenSolver(torch.eye(3, dtype=torch.float64)).eigenvalues
