"""CG, CGLS and MINRES of the port against the JAX package's loops, f64 on
the CPU, same numpy-seeded systems (mirrors the cg/minres/cgls cases of
``tests/test_cg_svd.py`` and ``tests/test_gmres.py``).

The port's loops read their stop condition on the host every
``CHECK_EVERY`` iterations and mask the steps past it; the iterate and the
iteration count must still be the reference's.  Tolerance: iterates 1e-10
relative, iteration counts equal.  MINRES stops at 1e-10, not 1e-12: there
its residual recursion meets its rounding floor, and the two packages' sums
(taken in other orders) can cross the stop a step apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eigenex_tpu.solvers.cg as jcg
from eigenex_tpu.core.operators import LinearOperator as JLinearOperator
from eigenex_tpu.core.operators import aslinearoperator as j_aslin
from eigenex_tpu_torch import (
    LinearOperator,
    aslinearoperator,
    cg_solve,
    cgls_solve,
    minres_solve,
    shift_invert_operator,
)
from eigenex_tpu_torch.solvers.cg import CHECK_EVERY
from eigenex_tpu_torch.utils.exceptions import EigenexError

torch.set_num_threads(1)


def close(x, ref, rel=1e-10):
    x, ref = np.asarray(x), np.asarray(ref)
    assert np.linalg.norm(x - ref) <= rel * np.linalg.norm(ref), np.linalg.norm(x - ref)


def spd(n, seed, shift=10.0):
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n, n))
    return (B + B.T) / 2 + shift * np.eye(n), rng.standard_normal(n)


def orthogonal_spectrum(lam, seed):
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((len(lam), len(lam))))[0]
    return Q @ np.diag(lam) @ Q.T, rng.standard_normal(len(lam))


def counting(A):
    """A dense operator that counts its matvecs."""
    calls = {"n": 0}

    def mv(m, x):
        calls["n"] += 1
        return m @ x

    return LinearOperator(mv, torch.as_tensor(A), A.shape, torch.float64, "cpu"), calls


@pytest.mark.parametrize("tol", [1e-12, 1e-6], ids=["tight", "loose"])
def test_cg_matches_reference(tol):
    A, b = spd(40, 0)
    xj, rj, ij = jcg.cg_solve(jnp.asarray(A), jnp.asarray(b), tol=tol)
    op, calls = counting(A)
    x, r, it = cg_solve(op, b, tol=tol)
    assert int(it) == int(ij)
    close(x.numpy(), xj)
    np.testing.assert_allclose(float(r), float(rj), rtol=1e-6)
    # masked steps: at most CHECK_EVERY - 1 applications past the stop
    assert int(it) + 1 <= calls["n"] <= int(it) + CHECK_EVERY


def test_cg_matrix_free():
    d = np.linspace(1.0, 5.0, 30)
    b = np.random.default_rng(1).standard_normal(30)
    op = LinearOperator(lambda p, x: p * x, torch.as_tensor(d), (30, 30), torch.float64, "cpu")
    x, _, _ = cg_solve(op, b, tol=1e-13)
    np.testing.assert_allclose(x.numpy(), b / d, atol=1e-10)


def test_cg_stops_at_max_iters():
    A, b = spd(60, 2, shift=0.5)
    xj, _, ij = jcg.cg_solve(jnp.asarray(A), jnp.asarray(b), tol=1e-14, max_iters=13)
    x, _, it = cg_solve(torch.as_tensor(A), b, tol=1e-14, max_iters=13)
    assert int(it) == int(ij) == 13
    close(x.numpy(), xj)


@pytest.mark.parametrize("case", ["least_squares", "indefinite"])
def test_cgls_matches_reference(case):
    rng = np.random.default_rng(0 if case == "least_squares" else 1)
    if case == "least_squares":
        A, b = rng.standard_normal((30, 12)), rng.standard_normal(30)
        tol, iters = 1e-13, 200
    else:
        lam = np.linspace(-3.0, 3.0, 40)
        lam[np.abs(lam) < 0.2] += 0.4
        A, b = orthogonal_spectrum(lam, 1)
        tol, iters = 1e-12, 2000
    xj, rj, ij = jcg.cgls_solve(j_aslin(jnp.asarray(A)), jnp.asarray(b), tol=tol, max_iters=iters)
    x, r, it = cgls_solve(aslinearoperator(torch.as_tensor(A)), b, tol=tol, max_iters=iters)
    assert int(it) == int(ij)
    close(x.numpy(), xj)
    if case == "least_squares":
        np.testing.assert_allclose(x.numpy(), np.linalg.lstsq(A, b, rcond=None)[0], atol=1e-9)
    else:
        assert np.linalg.norm(A @ x.numpy() - b) < 1e-10


@pytest.mark.parametrize("spectrum", ["definite", "indefinite"])
def test_minres_matches_reference(spectrum):
    lam = np.linspace(0.5, 5.0, 60) if spectrum == "definite" else np.linspace(-3.0, 3.0, 60) + 0.07
    A, b = orthogonal_spectrum(lam, 3)
    xj, rj, ij = jcg.minres_solve(j_aslin(jnp.asarray(A)), jnp.asarray(b), tol=1e-10, max_iters=2000)
    x, r, it = minres_solve(torch.as_tensor(A), b, tol=1e-10, max_iters=2000)
    assert int(it) == int(ij)
    close(x.numpy(), xj)
    # the recursion's |eta| near the stop is a product of rounding-level
    # rotations: both sides below the target, not equal to each other
    assert max(float(r), float(rj)) <= 1e-10 * np.linalg.norm(b)
    assert np.linalg.norm(A @ x.numpy() - b) < 1e-8


def test_minres_complex_hermitian():
    rng = np.random.default_rng(4)
    n = 40
    H = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    H = (H + H.conj().T) / 2 + np.eye(n) * 0.1
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    xj, _, ij = jcg.minres_solve(j_aslin(jnp.asarray(H)), jnp.asarray(b), tol=1e-10, max_iters=4000)
    x, _, it = minres_solve(torch.as_tensor(H), b, tol=1e-10, max_iters=4000)
    assert int(it) == int(ij)
    close(x.numpy(), xj)
    assert np.linalg.norm(H @ x.numpy() - b) < 1e-8


@pytest.mark.parametrize("solver", ["cg", "minres"])
def test_shift_invert_hermitian_interior(solver):
    """Interior (indefinite) shift with a cap that CG does not converge
    under: the MINRES fallback, warm-started from the CG iterate, rescues
    it; the result equals the reference's."""
    A, x = orthogonal_spectrum(np.linspace(-1.0, 1.0, 50) + 0.013, 0)
    sigma = 0.0
    sj = jcg.shift_invert_operator(j_aslin(jnp.asarray(A)), sigma, tol=1e-12, max_iters=70,
                                   solver=solver)
    st = shift_invert_operator(torch.as_tensor(A), sigma, tol=1e-12, max_iters=70, solver=solver)
    y = st.matvec(torch.as_tensor(x)).numpy()
    close(y, sj.matvec(jnp.asarray(x)))
    assert np.linalg.norm(A @ y - sigma * y - x) / np.linalg.norm(x) < 1e-9
    assert st.stats["applications"] == 1
    assert st.stats["fallbacks"] == (1 if solver == "cg" else 0)


def closure(A, dtype=torch.float64):
    """A matrix-free operator over A with no adjoint, in each package, and
    a count of the port's matvec calls."""
    calls = {"n": 0}

    def mv(m, v):
        calls["n"] += 1
        return m @ v

    jdt = jnp.complex128 if np.iscomplexobj(A) else jnp.float64
    return (LinearOperator(mv, torch.as_tensor(A), A.shape, dtype, "cpu"),
            JLinearOperator(lambda m, v: m @ v, jnp.asarray(A), A.shape, jdt), calls)


def test_cgls_on_a_closure_derives_the_adjoint():
    """test_cgls_matches_reference's indefinite case on an operator with no
    adjoint: both packages derive A^H (vjp / autograd); same iterations and
    iterate.  Each derived adjoint calls the matvec once (its forward)."""
    lam = np.linspace(-3.0, 3.0, 40)
    lam[np.abs(lam) < 0.2] += 0.4
    A, b = orthogonal_spectrum(lam, 1)
    op, jop, calls = closure(A)
    xj, _, ij = jcg.cgls_solve(jop, jnp.asarray(b), tol=1e-12, max_iters=2000)
    x, _, it = cgls_solve(op, b, tol=1e-12, max_iters=2000)
    assert int(it) == int(ij)
    close(x.numpy(), xj)
    assert np.linalg.norm(A @ x.numpy() - b) < 1e-10
    assert calls["n"] % 2 == 0 and calls["n"] >= 2 * (int(it) + 1)  # one matvec, one adjoint a step


@pytest.mark.parametrize("solver", ["cg", "minres"])
def test_shift_invert_hermitian_on_a_closure(solver):
    """test_shift_invert_hermitian_interior on a matrix-free operator with no
    adjoint, in both packages: CG under its cap at the interior sigma falls
    back (to MINRES, in both: neither needs the adjoint), and the result
    agrees with the reference's."""
    A, x = orthogonal_spectrum(np.linspace(-1.0, 1.0, 50) + 0.013, 0)
    sigma = 0.0
    op, jop, calls = closure(A)
    st = shift_invert_operator(op, sigma, tol=1e-12, max_iters=70, solver=solver)
    y = st.matvec(torch.as_tensor(x)).numpy()
    yj = jcg.shift_invert_operator(jop, sigma, tol=1e-12, max_iters=70,
                                   solver=solver).matvec(jnp.asarray(x))
    close(y, yj)
    assert np.linalg.norm(A @ y - sigma * y - x) / np.linalg.norm(x) < 1e-9
    assert st.stats["fallbacks"] == (1 if solver == "cg" else 0)
    assert st.stats["matvecs"] == calls["n"] and st.stats["adjoint_forwards"] == 0


def test_minres_rejects_rectangular():
    with pytest.raises(EigenexError):
        minres_solve(torch.ones((3, 4), dtype=torch.float64), torch.ones(3, dtype=torch.float64))
    with pytest.raises(EigenexError, match="solver"):
        shift_invert_operator(torch.eye(3, dtype=torch.float64), 0.5, solver="bicg")
