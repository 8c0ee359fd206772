"""LOBPCG parity in f64 on the CPU: the port against the JAX package on the
same numpy-seeded operators and the same start block.

Tolerances: eigenvalues to 1e-10 between the packages and against
``scipy.linalg.eigh``, with the same iteration count and termination.  The
solver tolerance is 1e-7: eigenvalue error is quadratic in the residual, and
below a residual of ~1e-8 the rank cutoff of the trial Gram (``rank_tol``)
drops directions by a rounding-order coin toss, so iteration counts of any two
implementations part there.  ``eigsh(M=)`` / ``eigsh(preconditioner=)`` take no
``v0``, so the two packages start from different random blocks: converged
pairs only, eigenvalues to 1e-8 against the dense pencil.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sl
import torch

import eigenex_tpu as ex
import eigenex_tpu_torch as ext
import eigenex_tpu.solvers.lobpcg  # noqa: F401  (the package re-exports the function under this name)
import eigenex_tpu_torch.solvers.lobpcg  # noqa: F401  (so does the port's)
from eigenex_tpu_torch.sparse.bsr import bsr_from_dense
from eigenex_tpu_torch.sparse.sym_bsr import sym_bsr_from_bsr
from eigenex_tpu_torch.utils.exceptions import EigenexError, LanczosError

torch.set_num_threads(1)
jl = sys.modules["eigenex_tpu.solvers.lobpcg"]
tl = sys.modules["eigenex_tpu_torch.solvers.lobpcg"]

N, K = 80, 4


def pencil(seed=0):
    """Diagonally dominant A (so the Jacobi preconditioner helps) and an SPD B."""
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((N, N))
    A = np.diag(np.arange(1, N + 1) * 1.0) + 0.05 * (noise + noise.T)
    nb = rng.standard_normal((N, N))
    B = np.eye(N) + 0.02 * (nb + nb.T)
    X0 = rng.standard_normal((N, K))
    return A, B, X0


@pytest.mark.parametrize("largest", [False, True], ids=["smallest", "largest"])
@pytest.mark.parametrize("use_b", [False, True], ids=["standard", "generalized"])
def test_lobpcg_matches_reference(largest, use_b):
    A, B, X0 = pencil()
    rj = jl.lobpcg(jnp.asarray(A), K, B=jnp.asarray(B) if use_b else None,
                   X0=jnp.asarray(X0), largest=largest, tol=1e-7)
    rt = tl.lobpcg(torch.as_tensor(A), K, B=torch.as_tensor(B) if use_b else None,
                   X0=X0, largest=largest, tol=1e-7)
    assert rt.converged and rt.termination == rj.termination == "converged"
    assert rt.iterations == rj.iterations
    np.testing.assert_allclose(rt.eigenvalues, np.asarray(rj.eigenvalues), rtol=0, atol=1e-10)
    w = sl.eigh(A, B if use_b else None, eigvals_only=True)
    want = w[-K:][::-1] if largest else w[:K]  # largest=: descending, as the reference
    np.testing.assert_allclose(rt.eigenvalues, want, rtol=0, atol=1e-10)
    # eigenvectors: B-orthonormal columns with small true residuals
    X = rt.eigenvectors.numpy()
    Bm = B if use_b else np.eye(N)
    np.testing.assert_allclose(X.T @ Bm @ X, np.eye(K), atol=1e-9)
    assert np.abs(A @ X - Bm @ X * rt.eigenvalues[None, :]).max() < 1e-5


def test_preconditioned_lobpcg_matches_reference():
    A, _, X0 = pencil(seed=1)
    rj = jl.lobpcg(jnp.asarray(A), K, X0=jnp.asarray(X0), tol=1e-7,
                   preconditioner=ex.jacobi_preconditioner(jnp.asarray(A)))
    rt = tl.lobpcg(torch.as_tensor(A), K, X0=X0, tol=1e-7,
                   preconditioner=ext.jacobi_preconditioner(torch.as_tensor(A)))
    assert rt.termination == rj.termination == "converged"
    assert rt.iterations == rj.iterations
    assert rt.iterations < 30  # unpreconditioned: about 70
    np.testing.assert_allclose(rt.eigenvalues, np.asarray(rj.eigenvalues), rtol=0, atol=1e-10)
    np.testing.assert_allclose(rt.eigenvalues, np.linalg.eigvalsh(A)[:K], rtol=0, atol=1e-10)


def test_trace_and_stages_match_reference_step_by_step():
    """The device stages on one trial block: Grams, update, residual norms."""
    A, B, X0 = pencil(seed=2)
    S = np.linalg.qr(np.random.default_rng(3).standard_normal((N, 3 * K)))[0]
    jop, jB = ex.aslinearoperator(jnp.asarray(A)), ex.aslinearoperator(jnp.asarray(B))
    top, tB = ext.aslinearoperator(torch.as_tensor(A)), ext.aslinearoperator(torch.as_tensor(B))
    _, _, jGA, jGB = jl._gram_stage(jop, jB, jnp.asarray(S), has_b=True)
    tAS, tBS, tGA, tGB = tl._gram_stage(top, tB, torch.as_tensor(S), has_b=True)
    np.testing.assert_allclose(tGA.numpy(), np.asarray(jGA), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tGB.numpy(), np.asarray(jGB), rtol=0, atol=1e-12)
    jr = jl._host_rayleigh_ritz(np.asarray(jGA), np.asarray(jGB), K, False, 1e-8)
    tr = tl._host_rayleigh_ritz(tGA.numpy(), tGB.numpy(), K, False, 1e-8)
    np.testing.assert_allclose(tr[0], jr[0], rtol=0, atol=1e-12)
    M = np.random.default_rng(4).standard_normal((N, K)) * np.array([1.0, 0.0, 3.0, 1e-3])
    np.testing.assert_allclose(tl._colnormalize(torch.as_tensor(M)).numpy(),
                               np.asarray(jl._colnormalize(jnp.asarray(M))), rtol=0, atol=1e-15)
    # rank-deficient Gram: no usable pencil
    assert tl._host_rayleigh_ritz(np.zeros((3, 3)), np.zeros((3, 3)), 2, False, 1e-8) is None
    assert tl._host_rayleigh_ritz(np.full((3, 3), np.nan), np.eye(3), 2, False, 1e-8) is None


@pytest.mark.parametrize("route", ["M", "preconditioner", "both"])
def test_eigsh_lobpcg_route_matches_reference(route):
    A, B, _ = pencil(seed=5)
    kw_j, kw_t = {}, {}
    if route in ("M", "both"):
        kw_j["M"], kw_t["M"] = jnp.asarray(B), B
    if route in ("preconditioner", "both"):
        kw_j["preconditioner"] = ex.jacobi_preconditioner(jnp.asarray(A))
        kw_t["preconditioner"] = ext.jacobi_preconditioner(A, device="cpu")
    rj = ex.eigsh(jnp.asarray(A), k=3, which="SA", tol=1e-8, **kw_j)
    rt = ext.eigsh(A, k=3, which="SA", tol=1e-8, device="cpu", **kw_t)
    assert rj.converged and rt.converged and rt.termination == "converged"
    w = sl.eigh(A, B if "M" in kw_t else None, eigvals_only=True)[:3]
    np.testing.assert_allclose(rt.eigenvalues, w, rtol=0, atol=1e-8)
    np.testing.assert_allclose(rt.eigenvalues, np.asarray(rj.eigenvalues), rtol=0, atol=1e-8)
    assert rt.eigenvectors.shape == (N, 3) and rt.eigenvectors.device.type == "cpu"


def test_eigsh_lobpcg_route_returns_largest_in_ascending_order():
    A, B, _ = pencil(seed=6)
    rt = ext.eigsh(A, k=3, which="LA", M=B, tol=1e-8, device="cpu", max_iterations=400)
    assert rt.converged
    w = sl.eigh(A, B, eigvals_only=True)[-3:]
    np.testing.assert_allclose(rt.eigenvalues, w, rtol=0, atol=1e-8)  # ascending, scipy order
    X = rt.eigenvectors.numpy()
    assert np.abs(A @ X - B @ X * rt.eigenvalues[None, :]).max() < 1e-4


def test_eigsh_lobpcg_route_on_a_container_uses_matmat():
    """A SymBSR operand: the block products go through ``matmat`` (the SpMM
    route on the card; the plain version here, so no launch is counted)."""
    from eigenex_tpu_torch.ops.cuda_spmv import launch_counts, reset_launch_counts

    A, _, _ = pencil(seed=7)
    sym = sym_bsr_from_bsr(bsr_from_dense(A, (8, 8), device="cpu"))
    reset_launch_counts()
    rt = ext.eigsh(sym, k=3, which="SA", tol=1e-8,
                   preconditioner=ext.jacobi_preconditioner(sym))
    assert rt.converged
    np.testing.assert_allclose(rt.eigenvalues, np.linalg.eigvalsh(A)[:3], rtol=0, atol=1e-8)
    assert not any(launch_counts().values())


@pytest.mark.parametrize(
    "kwargs,match",
    [
        (dict(v0=np.ones(N)), "v0= is not supported"),
        (dict(which="BE"), "spectrum extremes only"),
        (dict(which="LM"), "spectrum extremes only"),
        (dict(accelerate=True), "accelerate=True cannot combine"),
        (dict(sigma=1.0), "cannot be combined with sigma"),
        (dict(mesh=object()), "cannot be combined with sigma= or mesh="),
    ],
    ids=["v0", "BE", "LM", "accelerate", "sigma", "mesh"],
)
def test_eigsh_lobpcg_route_rejections(kwargs, match):
    A, B, _ = pencil(seed=8)
    with pytest.raises(EigenexError, match=match):
        ext.eigsh(A, k=2, M=B, device="cpu", **kwargs)


def test_solver_validation_errors():
    A, B, X0 = pencil(seed=9)
    with pytest.raises(LanczosError, match="no operator"):
        tl.LOBPCGSolver().compute()
    with pytest.raises(LanczosError, match="3\\*b <= n"):
        tl.lobpcg(torch.eye(8, dtype=torch.float64), 4)
    with pytest.raises(LanczosError, match="initial block"):
        tl.lobpcg(torch.as_tensor(A), K, X0=X0[:, :2])
    with pytest.raises(LanczosError, match="B shape"):
        tl.lobpcg(torch.as_tensor(A), K, B=torch.eye(N - 1, dtype=torch.float64))
    with pytest.raises(LanczosError, match="square"):
        tl.lobpcg(torch.ones(6, 8, dtype=torch.float64), 1)


def test_max_iterations_terminates_with_a_warning():
    A, _, X0 = pencil(seed=10)
    rt = tl.lobpcg(torch.as_tensor(A), K, X0=X0, tol=1e-12, max_iterations=3)
    assert not rt.converged and rt.termination == "max_iterations" and rt.iterations == 3
    assert rt.trace.has_warn() and len(rt.trace.residuals) == 3
