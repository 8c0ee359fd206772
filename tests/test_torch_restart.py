"""Thick-restart Lanczos parity in f64 with an explicit start vector: the
port against the JAX package on the same numpy-seeded operator.

Tolerance: eigenvalues to 1e-10 (the BASELINE.json correctness target),
against the reference and against dense ``eigvalsh``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigenex_tpu.solvers import restart as jr
from eigenex_tpu.sparse.bsr import bsr_from_dense as j_bsr_from_dense
from eigenex_tpu_torch.solvers import restart as tr
from eigenex_tpu_torch.sparse.bsr import bsr_from_dense
from eigenex_tpu_torch.utils.exceptions import LanczosError

torch.set_num_threads(1)


def operator_pair(n=256, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    A = np.triu(np.tril(A, 12), -12)
    A = (A + A.T) / 2 + np.diag(np.linspace(0, 3, n))
    jop = j_bsr_from_dense(A, (8, 8)).as_linear_operator(use_pallas=False)
    top = bsr_from_dense(A, (8, 8), device="cpu").as_linear_operator()
    return A, jop, top


def solve_both(jop, top, v0, **kw):
    jres = jr.ThickRestartLanczosEigenSolver(jop, jr.ThickRestartOptions(**kw)).set_initial_vector(
        jnp.asarray(v0)).compute()
    tres = tr.ThickRestartLanczosEigenSolver(top, tr.ThickRestartOptions(**kw)).set_initial_vector(
        torch.as_tensor(v0)).compute()
    return jres, tres


@pytest.mark.parametrize(
    "indices,num_kept",
    [((0, 1, 2), None), ((-2, -1), None), ((0, 1, -2, -1), None), ((0, 1), 6)],
    ids=["SA3", "LA2", "BE4", "SA2_keep6"],
)
def test_thick_restart_matches_reference(indices, num_kept):
    A, jop, top = operator_pair()
    v0 = np.random.default_rng(1).standard_normal(A.shape[0])
    jres, tres = solve_both(
        jop, top, v0, max_eigenvalues=len(indices), eigenvalue_indices=indices,
        tolerance=1e-12, max_subspace=40, max_restarts=300, num_kept=num_kept,
    )
    assert jres.converged and tres.converged and tres.termination == "converged"
    np.testing.assert_allclose(tres.eigenvalues, jres.eigenvalues, rtol=0, atol=1e-10)
    ev = np.linalg.eigvalsh(A)
    np.testing.assert_allclose(tres.eigenvalues, ev[list(indices)], rtol=0, atol=1e-10)
    X, Xref = tres.eigenvectors.numpy(), np.asarray(jres.eigenvectors)
    assert X.shape == (A.shape[0], len(indices))
    assert np.abs(np.abs(np.sum(X * Xref, axis=0)) - 1).max() < 1e-6  # up to sign
    assert tres.residual_norms(top).max() < 1e-8
    # restarts really happened, and the memory bound held
    assert tres.iterations > 40


def test_first_restart_cycle_is_step_for_step_the_reference():
    """Before rounding differences can steer a restart, both solvers do the
    same arithmetic: same iteration count and trace after few restarts."""
    A, jop, top = operator_pair(n=128, seed=2)
    v0 = np.random.default_rng(3).standard_normal(128)
    jres, tres = solve_both(jop, top, v0, max_eigenvalues=2, tolerance=1e-30,
                            max_subspace=24, max_restarts=2)
    assert not tres.converged and tres.termination == jres.termination == "max_restarts"
    assert tres.iterations == jres.iterations
    assert tres.trace.iterations == jres.trace.iterations
    np.testing.assert_allclose(tres.eigenvalues, jres.eigenvalues, rtol=0, atol=1e-10)
    assert tres.trace.has_warn()


def test_shift_is_subtracted_from_the_reported_eigenvalues():
    A, jop, top = operator_pair(n=128, seed=4)
    v0 = np.random.default_rng(5).standard_normal(128)
    jres, tres = solve_both(jop, top, v0, max_eigenvalues=2, tolerance=1e-12,
                            max_subspace=32, eigenvalue_shift=5.0)
    np.testing.assert_allclose(tres.eigenvalues, jres.eigenvalues, rtol=0, atol=1e-10)
    np.testing.assert_allclose(tres.eigenvalues, np.linalg.eigvalsh(A)[:2], rtol=0, atol=1e-10)


def test_configuration_errors():
    _, _, top = operator_pair(n=64)
    with pytest.raises(LanczosError):
        tr.ThickRestartLanczosEigenSolver(
            top, tr.ThickRestartOptions(max_eigenvalues=5, max_subspace=6)).compute()
    with pytest.raises(LanczosError):
        tr.ThickRestartLanczosEigenSolver().compute()
    with pytest.raises(LanczosError):
        tr.ThickRestartLanczosEigenSolver(top).eigenvalues


@pytest.mark.parametrize("solver", ["thick_restart", "krylov_schur"])
def test_rows_above_the_kept_ones_are_never_read(solver, monkeypatch):
    """A restart writes rows [:p + 1] of the basis in place and leaves the
    rows above as they were.  Filled with NaN right after each restart,
    they change nothing: the eigenvalues, iterations and trace are those of
    the solve that leaves them be."""
    from eigenex_tpu_torch.solvers import krylov_schur as tks

    rng = np.random.default_rng(6)
    A = rng.standard_normal((160, 160))
    if solver == "thick_restart":
        A = (A + A.T) / 2
        make = lambda: tr.ThickRestartLanczosEigenSolver(torch.as_tensor(A), tr.ThickRestartOptions(
            max_eigenvalues=3, tolerance=1e-10, max_subspace=20, max_restarts=200))
    else:
        make = lambda: tks.KrylovSchurArnoldiSolver(torch.as_tensor(A), tks.KrylovSchurOptions(
            max_eigenvalues=4, tolerance=1e-10, max_subspace=24, max_restarts=200))
    v0 = torch.as_tensor(rng.standard_normal(160))
    plain = make().set_initial_vector(v0).compute()
    write, poisoned_rows = tr._restart_into, []

    def poisoned(state, Yk, block, row):
        state = write(state, Yk, block, row)
        state.V[Yk.shape[1] + 1:] = float("nan")
        poisoned_rows.append(state.V.shape[0] - Yk.shape[1] - 1)
        return state

    monkeypatch.setattr(tr, "_restart_into", poisoned)
    res = make().set_initial_vector(v0).compute()
    assert len(poisoned_rows) >= 3 and min(poisoned_rows) > 0
    assert plain.converged and res.termination == plain.termination
    np.testing.assert_array_equal(res.eigenvalues, plain.eigenvalues)
    assert res.iterations == plain.iterations
    assert res.trace.iterations == plain.trace.iterations
    np.testing.assert_array_equal(res.trace.residuals, plain.trace.residuals)
    for got, want in zip(res.trace.ritz_values, plain.trace.ritz_values, strict=True):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(res.eigenvectors.numpy(), plain.eigenvectors.numpy())
