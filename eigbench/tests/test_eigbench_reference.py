"""The plain references against SciPy's dense and ARPACK answers at small sizes."""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from eigbench.reference import convection_diffusion as cd
from eigbench.reference import heisenberg_chain as hc
from eigbench.reference.lanczos import lanczos
from eigbench.reference.precision import round_tf32, round_tf32_np


def kron_chain(L, n_up, J, Jz, pbc):
    """The chain's Hamiltonian on all 2^L states by Kronecker products (bit i
    of a state's index is site i), restricted to the sector."""
    sp_, sm = np.array([[0.0, 0.0], [1.0, 0.0]]), np.array([[0.0, 1.0], [0.0, 0.0]])
    sz = np.diag([-0.5, 0.5])

    def site(op, i):
        m = np.eye(1)
        for p in reversed(range(L)):
            m = np.kron(m, op if p == i else np.eye(2))
        return m

    H = sum(J / 2 * (site(sp_, i) @ site(sm, j) + site(sm, i) @ site(sp_, j))
            + Jz * site(sz, i) @ site(sz, j) for i, j in hc.bonds(L, pbc))
    states = [s for s in range(2**L) if bin(s).count("1") == n_up]
    return H[np.ix_(states, states)]


@pytest.mark.parametrize("L,pbc,Jz", [(6, False, 1.0), (8, False, 0.7), (8, True, 1.0)])
def test_heisenberg_matrix_matches_kronecker_build(L, pbc, Jz):
    crow, col, val, dim = hc.csr_arrays(L, L // 2, 1.0, Jz, pbc)
    A = sp.csr_matrix((val, col, crow), shape=(dim, dim)).toarray()
    np.testing.assert_array_equal(A, kron_chain(L, L // 2, 1.0, Jz, pbc))
    assert np.all(np.diff(col[crow[0]:crow[1]]) > 0)


@pytest.mark.parametrize("which", ["SA", "LA"])
def test_heisenberg_reference_eigenvalues_match_arpack(which):
    params = {"L": 14, "n_up": 7, "J": 1.0, "Jz": 1.0, "pbc": False}
    H = hc.operator(params, "cpu")
    crow, col, val, dim = hc.csr_arrays(14, 7, 1.0, 1.0, False)
    want = np.sort(spla.eigsh(sp.csr_matrix((val, col, crow), shape=(dim, dim)), k=4,
                              which=which, tol=1e-13)[0])
    got = hc.eigenvalues(H, 4, which, seed=3)
    np.testing.assert_allclose(got, want, rtol=1e-11)


def test_lanczos_ritz_vectors_are_eigenvectors():
    rng = np.random.default_rng(0)
    Q, _ = np.linalg.qr(rng.standard_normal((60, 60)))
    w = np.linspace(-3, 5, 60)
    A = torch.as_tensor(Q @ np.diag(w) @ Q.T)
    theta, X, steps = lanczos(lambda x: A @ x, 60, 3, tol=1e-12, max_steps=60, seed=1,
                              device="cpu")
    np.testing.assert_allclose(theta, w[:3], atol=1e-10)
    assert torch.linalg.norm(A @ X - X * torch.as_tensor(theta)) < 1e-9 and steps <= 60


def test_heisenberg_judge_reads_a_sound_answer_small_and_an_altered_one_large():
    params = {"L": 10, "n_up": 5, "J": 1.0, "Jz": 1.0, "pbc": False}
    H = hc.operator(params, "cpu").to_dense().numpy()
    w, V = np.linalg.eigh(H)
    request = {"k": 2, "which": "SA", "tol": 1e-8}
    numbers, notes = hc.judge(params, request, [(w[:2], V[:, :2]), (w[:2] * 1.001, V[:, :2]),
                                                (w[:1], V[:, :1])], "cpu", 0)
    assert numbers["resid"][0] < 1e-12 and numbers["eig_err"][0] < 1e-12
    assert numbers["eig_err"][1] == pytest.approx(1e-3, rel=1e-6) and numbers["resid"][1] > 5e-4
    assert numbers["resid"][2] == float("inf")
    np.testing.assert_allclose(notes["reference_eigenvalues"], w[:2], rtol=1e-12)


def kron_stencil(nx, c):
    T = np.diag(np.full(nx, 2.0)) + np.diag(np.full(nx - 1, -1.0 - c), -1) \
        + np.diag(np.full(nx - 1, -1.0 + c), 1)
    return np.kron(np.eye(nx), T) + np.kron(T, np.eye(nx))


def test_convection_diffusion_matches_dense_and_closed_form():
    params = {"nx": 9, "conv": 0.4}
    A = cd.operator(params).toarray()
    np.testing.assert_array_equal(A, kron_stencil(9, 0.4))
    assert np.abs(np.linalg.eigvals(A)).max() == pytest.approx(cd.dominant_magnitude(params),
                                                               rel=1e-12)


def test_convection_diffusion_arpack_and_judge():
    params = {"nx": 20, "conv": 0.4}
    request = {"k": 4, "which": "LM", "tol": 1e-10}
    v0 = np.random.default_rng(5).standard_normal(400)
    lam, X = cd.solve(params, request, v0)
    dense = np.linalg.eigvals(cd.operator(params).toarray())
    # each pair is an eigenvalue of the dense matrix, the largest among them
    # (a double eigenvalue may come once: one start vector spans one copy)
    assert all(np.min(np.abs(dense - x)) < 1e-8 for x in lam)
    assert np.abs(lam).max() == pytest.approx(np.abs(dense).max(), rel=1e-10)
    numbers, _ = cd.judge(params, request, [(lam, X), (lam * 0.9, X)], "cpu", 0)
    top = cd.dominant_magnitude(params)
    assert numbers["resid"][0] < 1e-8
    assert numbers["shortfall"][0] == pytest.approx(1 - np.abs(lam).min() / top, abs=1e-12)
    assert numbers["resid"][1] > 0.1 and numbers["shortfall"][1] > 0.09


def test_tf32_rounding():
    x = np.random.default_rng(0).standard_normal(10_000).astype(np.float32)
    a = round_tf32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(a, round_tf32_np(x))
    assert not np.any(a.view(np.uint32) & 0x1FFF)
    assert np.max(np.abs(a - x) / np.abs(x)) <= 2.0**-11
    np.testing.assert_array_equal(round_tf32_np(np.float32([1.0, -0.25, 5.75])),
                                  np.float32([1.0, -0.25, 5.75]))
