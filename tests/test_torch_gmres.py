"""GMRES of the port against the JAX package's, f64 on the CPU, same
numpy-seeded systems (mirrors ``tests/test_gmres.py``).

Tolerance: iterates 1e-10 relative; the shift-invert routes to the true
residual the reference's tests ask for.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eigenex_tpu.solvers.gmres as jg
from eigenex_tpu.core.operators import LinearOperator as JLinearOperator
from eigenex_tpu.core.operators import aslinearoperator as j_aslin
from eigenex_tpu.sparse.bsr import bsr_from_dense as j_bsr_from_dense
from eigenex_tpu.solvers.arnoldi import ArnoldiEigenSolver as JArnoldi
from eigenex_tpu.solvers.arnoldi import ArnoldiOptions as JOptions
from eigenex_tpu_torch import (
    ArnoldiEigenSolver,
    ArnoldiOptions,
    LinearOperator,
    gmres_solve,
    gmres_solve_jit,
    shift_invert_operator_general,
)
from eigenex_tpu_torch.ops import cuda_spmv
from eigenex_tpu_torch.sparse.bsr import bsr_from_dense
from eigenex_tpu_torch.utils.exceptions import EigenexError, OperatorError

torch.set_num_threads(1)


def close(x, ref, rel=1e-10):
    x, ref = np.asarray(x), np.asarray(ref)
    assert np.linalg.norm(x - ref) <= rel * np.linalg.norm(ref), np.linalg.norm(x - ref)


def system(n=50, seed=0, shift=8.0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n)) + shift * np.eye(n), rng.standard_normal(n)


def counting(A):
    calls = {"n": 0}

    def mv(m, x):
        calls["n"] += 1
        return m @ x

    return LinearOperator(mv, torch.as_tensor(A), A.shape, torch.float64, "cpu"), calls


def convection(n=64):
    return 2 * np.eye(n) - 1.4 * np.eye(n, k=1) - 0.6 * np.eye(n, k=-1), np.ones(n)


@pytest.mark.parametrize("case", ["shifted_gaussian", "convection"])
def test_gmres_host_matches_reference(case):
    A, b = system() if case == "shifted_gaussian" else convection()
    restart = 25 if case == "shifted_gaussian" else 32
    xj, relj, cj = jg.gmres_solve(jnp.asarray(A), jnp.asarray(b), tol=1e-12, restart=restart)
    x, rel, cycles = gmres_solve(torch.as_tensor(A), b, tol=1e-12, restart=restart)
    assert cycles == cj and rel <= 1e-12
    close(x.numpy(), xj)
    np.testing.assert_allclose(A @ x.numpy(), b, atol=1e-8)


@pytest.mark.parametrize("tol", [0.0, 1e-6], ids=["whole_budget", "residual_stop"])
def test_gmres_residual_controlled_matches_reference(tol):
    A, b = system(60, 1, shift=20.0)
    xj = jg.gmres_solve_jit(jnp.asarray(A), jnp.asarray(b), restart=8, cycles=6, tol=tol)
    op, calls = counting(A)
    x = gmres_solve_jit(op, b, restart=8, cycles=6, tol=tol)
    close(x.numpy(), xj)
    # one residual matvec and 8 Arnoldi steps a cycle; with a target the
    # loop stops on the residual read off the small problem, before the cap
    if tol:
        assert calls["n"] < 6 * 9 and calls["n"] % 9 == 0
        assert np.linalg.norm(A @ x.numpy() - b) <= 1.01 * tol * np.linalg.norm(b)
    else:
        assert calls["n"] == 6 * 9


def test_gmres_breakdown_rank_deficient_hessenberg():
    """b in a 2-dimensional invariant subspace: the Arnoldi cycle breaks down
    after 2 steps and the (m+1, m) Hessenberg has zero columns; the host
    least-squares solve (SVD) still gives the exact solution."""
    A = np.diag([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    b = np.array([1.0, 1.0, 0, 0, 0, 0])
    xj = jg.gmres_solve_jit(jnp.asarray(A), jnp.asarray(b), restart=5, cycles=2, tol=1e-12)
    x = gmres_solve_jit(torch.as_tensor(A), b, restart=5, cycles=2, tol=1e-12)
    np.testing.assert_allclose(x.numpy(), [1.0, 0.5, 0, 0, 0, 0], atol=1e-14)
    close(x.numpy(), xj)
    x2, rel, _ = gmres_solve(torch.as_tensor(A), b, restart=5, tol=1e-12)
    np.testing.assert_allclose(x2.numpy(), [1.0, 0.5, 0, 0, 0, 0], atol=1e-14)


def test_shift_invert_arnoldi_interior():
    n = 40
    rng = np.random.default_rng(3)
    evals = np.sort(rng.uniform(-5, 5, n))
    X = rng.standard_normal((n, n))
    A = X @ np.diag(evals) @ np.linalg.inv(X)
    target = evals[n // 2]
    sigma = target + 0.05 * (evals[n // 2 + 1] - target)
    v0 = rng.standard_normal(n)
    opts = dict(max_eigenvalues=1, tolerance=1e-10, max_subspace=25)
    si = shift_invert_operator_general(torch.as_tensor(A), sigma, restart=40, cycles=6)
    res = ArnoldiEigenSolver(si, ArnoldiOptions(**opts)).set_initial_vector(v0).compute()
    sij = jg.shift_invert_operator_general(jnp.asarray(A), sigma, restart=40, cycles=6)
    ref = JArnoldi(sij, JOptions(**opts)).set_initial_vector(jnp.asarray(v0)).compute()
    lam = sigma + 1.0 / res.eigenvalues[0]
    np.testing.assert_allclose(np.real(lam), target, atol=1e-6)
    np.testing.assert_allclose(res.eigenvalues, np.asarray(ref.eigenvalues), rtol=1e-10)
    assert si.stats["applications"] == res.iterations


def test_shift_invert_general_cgls_fallback():
    """GMRES(48) stagnates on this nonnormal complex shift; the CGLS
    fallback (warm-started from the GMRES iterate, adjoint from the dense
    operator) rescues it, as in the reference."""
    rng = np.random.default_rng(0)
    n = 80
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    sigma = 0.5 + 0.2j
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    si = shift_invert_operator_general(torch.as_tensor(A), sigma, tol=1e-12)
    y = si.matvec(torch.as_tensor(x)).numpy()
    rel = np.linalg.norm(A @ y - sigma * y - x) / np.linalg.norm(x)
    assert rel < 1e-10, rel
    assert si.stats["fallbacks"] == 1 and si.stats["iterations"] > 0
    yj = jg.shift_invert_operator_general(j_aslin(jnp.asarray(A)), sigma, tol=1e-12).matvec(
        jnp.asarray(x))
    close(y, yj, rel=1e-8)  # the same solution; each solve is itself only 1e-12-exact


def stencil(nx=12, conv=0.4):
    """The upwind convection-diffusion stencil of BASELINE config 2 (non-normal)."""
    lap = np.diag(np.full(nx, 4.0)) + np.diag(np.full(nx - 1, -1.0 - conv), -1) \
        + np.diag(np.full(nx - 1, -1.0 + conv), 1)
    shift = np.diag(np.full(nx - 1, -1.0 - conv), -1) + np.diag(np.full(nx - 1, -1.0 + conv), 1)
    return np.kron(np.eye(nx), lap) + np.kron(shift, np.eye(nx))


def container_matvec(p, v):
    return p.matvec(v)


@pytest.mark.parametrize("case", ["dense_complex", "bsr_stencil"])
def test_shift_invert_general_cgls_fallback_on_a_closure(case):
    """test_shift_invert_general_cgls_fallback on matrix-free operators with
    no adjoint, in both packages: GMRES stagnates, every application falls
    back to CGLS, whose adjoint the reference derives by ``jax.vjp`` and the
    port by autograd (before the derived adjoint the port raised
    OperatorError here).  The results agree to 1e-10; each derived adjoint
    runs one forward product, counted apart from ``matvecs``."""
    rng = np.random.default_rng(0)
    calls = {"n": 0}
    if case == "dense_complex":
        n = 80
        A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        sigma, tol, kw = 0.5 + 0.2j, 1e-12, {}
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        got, ref, dt, jdt = torch.as_tensor(A), jnp.asarray(A), torch.complex128, jnp.complex128
    else:
        A = stencil()
        n = A.shape[0]
        # an interior shift of the stencil's spectrum with a small GMRES budget
        sigma, tol, kw = 7.1, 1e-12, dict(restart=8, cycles=60)
        x = rng.standard_normal(n)
        got = bsr_from_dense(A, (8, 8), device="cpu")
        ref = j_bsr_from_dense(A, (8, 8))
        dt, jdt = torch.float64, jnp.float64

    def mv(p, v):
        calls["n"] += 1
        return p.matvec(v) if case == "bsr_stencil" else p @ v

    op = LinearOperator(mv, got, A.shape, dt, "cpu")
    jop = JLinearOperator(container_matvec if case == "bsr_stencil" else (lambda p, v: p @ v),
                          ref, A.shape, jdt)
    si = shift_invert_operator_general(op, sigma, tol=tol, **kw)
    y = si.matvec(torch.as_tensor(x)).numpy()
    yj = jg.shift_invert_operator_general(jop, sigma, tol=tol, **kw).matvec(jnp.asarray(x))
    close(y, yj)
    assert np.linalg.norm(A @ y - sigma * y - x) / np.linalg.norm(x) < 1e-10
    st = si.stats
    assert st["applications"] == 1 and st["fallbacks"] == 1 and st["iterations"] > 0
    assert st["adjoint_forwards"] > 0 and calls["n"] == st["matvecs"]
    # the same operator with the explicit adjoint: the same counts but no extra forwards
    explicit = shift_invert_operator_general(
        LinearOperator(mv, got, A.shape, dt, "cpu",
                       rmatvec_fn=(lambda p, v: p.rmatvec(v)) if case == "bsr_stencil"
                       else (lambda p, v: p.conj().T @ v)), sigma, tol=tol, **kw)
    close(explicit.matvec(torch.as_tensor(x)).numpy(), y)
    assert explicit.stats["matvecs"] == st["matvecs"] and explicit.stats["adjoint_forwards"] == 0


def test_cgls_fallback_raises_where_autograd_cannot_see_the_product(monkeypatch):
    """The fault this slice repairs, shown on the CPU: a closure over a
    kernel product taken outside autograd, as a ctypes launch was before the
    kernels' autograd Functions, has no derivable adjoint, and the CGLS
    fallback raises OperatorError, as the port did for every closure before
    its adjoint was derived; with the Functions the same closure solves."""
    A = stencil()
    bsr = bsr_from_dense(A, (8, 8), device="cpu")
    x = np.random.default_rng(0).standard_normal(A.shape[0])
    kw = dict(tol=1e-12, restart=8, cycles=60)

    def launch(op, v):
        with torch.no_grad():
            return cuda_spmv.bsr_spmv_plain(op, v)

    monkeypatch.setitem(cuda_spmv._LAUNCH, "bsr_spmv", launch)
    op = LinearOperator(lambda p, v: cuda_spmv._product("bsr_spmv", p, v), bsr, bsr.shape,
                        torch.float64, "cpu")
    si = shift_invert_operator_general(op, 7.1, **kw)
    y = si.matvec(torch.as_tensor(x)).numpy()  # through the Functions
    assert si.stats["fallbacks"] == 1
    assert np.linalg.norm(A @ y - 7.1 * y - x) / np.linalg.norm(x) < 1e-10
    monkeypatch.setattr(cuda_spmv, "_product", lambda name, p, v: cuda_spmv._LAUNCH[name](p, v))
    with pytest.raises(OperatorError, match="rmatvec_fn"):
        shift_invert_operator_general(op, 7.1, **kw).matvec(torch.as_tensor(x))


def test_gmres_rejects_rectangular():
    with pytest.raises(EigenexError, match="square"):
        gmres_solve(torch.ones((3, 4), dtype=torch.float64), torch.ones(3, dtype=torch.float64))
    x, rel, cycles = gmres_solve(torch.eye(3, dtype=torch.float64), torch.zeros(3, dtype=torch.float64))
    assert rel == 0.0 and cycles == 0 and not x.any()
