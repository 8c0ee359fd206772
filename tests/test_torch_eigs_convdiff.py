"""BASELINE config 2's request on the benchmark cell's path, at small sizes
on the CPU: the upwind convection-diffusion triplets of
``eigbench/configs/convdiff_316.py``, ``accelerate`` (the general 32x128
pack), then ``eigs(acc, k=4, which="LM", tol, max_restarts=400, v0)``.
Start vectors are drawn on the host from (seed, index), as
``tests/cpu_studies.py ks-convdiff`` draws them at nx = 316.

Every returned pair is held to its backward error ||A x - lam x|| /
(|lam| ||x||) on the float64 operator, as the cell's judge
(``eigbench/reference/convection_diffusion.py``) computes it, at most
2 tol: the stop test bounds beta |y[k-1]|, the residual of each returned
Ritz vector in the Arnoldi relation, by (tol - u) max |lambda(H)|, with u
the unit roundoff, and the true residual adds the relation's own rounding
(the float32 products, the orthogonalisation and the restarts' basis
compression, each near 1e-7 of ||A||).  The operator is far from
normal, so float32 moves its top values by far more than their gaps: the
eigenvalues are held only to lie near the top of the spectrum
(``shortfall``), except in float64 at nx = 20, where they are held to
SciPy ARPACK's from the same start vector.
"""

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import eigenex_tpu_torch as ext
from eigbench import core
from eigbench.reference import convection_diffusion

torch.set_num_threads(1)

CONFIG = core.load_module(core.BENCH / "configs" / "convdiff_316.py", "config")
SEED = 18
M, P = 48, 12  # eigs' default subspace for k = 4, and what a restart keeps: max(2k, k + 8)


def request(tol=1e-6):
    return {"k": 4, "which": "LM", "tol": tol, "max_restarts": 400}


def start(n, index, dtype=np.float32):
    return np.random.default_rng([SEED, index]).standard_normal(n).astype(dtype)


def solve(nx, index, dtype=torch.float32, tol=1e-6):
    params = {"nx": nx, "conv": 0.4}
    acc = ext.accelerate(CONFIG.operand(params), device="cpu", dtype=dtype)
    v0 = start(nx * nx, index, np.float32 if dtype == torch.float32 else np.float64)
    res = ext.eigs(acc, v0=torch.as_tensor(v0), **request(tol))
    numbers, _ = convection_diffusion.judge(params, request(tol),
                                            [(res.eigenvalues, res.eigenvectors)], "cpu", 0)
    return res, numbers["resid"][0], numbers["shortfall"][0]


@pytest.mark.parametrize("index", [0, 1, 2])
@pytest.mark.parametrize("nx", [24, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_returned_pairs_within_twice_tol_and_a_steady_kept_dimension(dtype, nx, index):
    res, resid, shortfall = solve(nx, index, dtype)
    assert res.converged and res.termination == "converged"
    assert resid <= 2e-6
    # a value 3 % below the closed-form top lies past the top dozen modes at
    # nx >= 24: the returned values come from the top of the spectrum
    assert shortfall <= 0.03
    # each restart keeps p vectors, or p + 1 where a complex pair sits at
    # the cut: the real Schur form never splits one
    kept = M - np.diff(res.trace.iterations)
    assert set(kept.tolist()) <= {P, P + 1}


@pytest.mark.parametrize("index", [8, 64], ids=["port_before", "reference"])
def test_start_vectors_that_returned_a_pair_above_tol_converge_within_it(index):
    """nx = 40, float32.  Index 8: the port's solver before the restart took
    its order from the Schur form's own diagonal and the stop test read the
    pairs it returns converged in 11 restarts to a pair of backward error
    2.28e-6.  Index 64: the JAX package's ``eigs`` (the same order and stop
    test as that solver) converged in 24 restarts to a pair of 8.58e-6, on
    the CPU; the port's ordering and stop test are a difference by design."""
    res, resid, _ = solve(40, index)
    assert res.converged and resid <= 1e-6


def closed_form_top(nx, conv, count):
    """The ``count`` largest eigenvalues of the stencil, with their
    multiplicity: 4 + 2 sqrt(1 - c^2) (cos j pi / (nx + 1) + cos k pi / (nx + 1))."""
    c = np.cos(np.arange(1, nx + 1) * np.pi / (nx + 1))
    values = 4 + 2 * np.sqrt(1 - conv * conv) * (c[:, None] + c[None, :])
    return np.sort(values.ravel())[::-1][:count]


@pytest.mark.parametrize("index", [0, 1, 2])
def test_f64_eigenvalues_match_arpack(index):
    """float64 at tol 1e-10 and nx = 20, where the top values' condition
    leaves them well defined: each returned value is, to 1e-7 of the top,
    one of the six largest eigenvalues of the closed form and one that ARPACK
    returns from the same start vector and subspace.  Either solve may find
    one copy of the double value lambda(1, 2) = lambda(2, 1) and the next
    value instead: from one start vector a Krylov space holds one vector of
    a double eigenvalue's space but for rounding.  Both solves stop at a
    backward error near 1e-10; the pack holds the operator's values as the
    packer rounds them."""
    nx = 20
    params = {"nx": nx, "conv": 0.4}
    res, resid, _ = solve(nx, index, torch.float64, tol=1e-10)
    ref = spla.eigs(convection_diffusion.operator(params), k=4, which="LM", tol=1e-10, ncv=M,
                    v0=start(nx * nx, index, np.float64), return_eigenvectors=False)
    top = convection_diffusion.dominant_magnitude(params)
    lam = np.asarray(res.eigenvalues)
    assert res.converged and resid <= 1e-7
    for values in (closed_form_top(nx, 0.4, 6), ref):
        assert np.abs(lam[:, None] - values[None, :]).min(axis=1).max() <= 1e-7 * top
    assert lam.real.max() == pytest.approx(top, abs=1e-7 * top)


def test_leading_pairs_take_the_most_wanted_blocks_of_an_unsorted_form():
    """Where the Schur form's wanted blocks lie out of order, the pairs the
    stop test reads and the extraction returns are still the most wanted:
    each is an eigenpair of T, and a complex pair comes whole."""
    from eigenex_tpu_torch.solvers import krylov_schur

    rng = np.random.default_rng(0)
    T = np.triu(rng.standard_normal((6, 6)))
    np.fill_diagonal(T, [1.0, 5.0, 2.0, 0.0, 0.0, 3.0])
    T[3:5, 3:5] = [[0.5, 4.0], [-1.0, 0.5]]  # a 2 x 2 block: 0.5 +- 2i, |value| 2.06
    theta, Z = krylov_schur._leading_pairs(T, 2, "LM")
    assert np.allclose(theta, [5.0, 3.0])
    theta, Z = krylov_schur._leading_pairs(T, 3, "LM")
    assert np.allclose(theta, [5.0, 3.0, 0.5 + 2j, 0.5 - 2j])
    assert np.allclose(T @ Z, Z * theta[None, :], atol=1e-12)
    assert np.allclose(np.linalg.norm(Z, axis=0), 1.0)


def test_a_schur_form_left_unsorted_still_converges_to_the_wanted_pairs(monkeypatch):
    """When LAPACK refuses a swap, ``_wanted_schur`` moves the wanted blocks
    to the front in one ``trsen``, in no set order among them.  Forced here
    at every restart that needs a swap (the first ``trsen`` of each ordering
    reports a refusal and leaves the form as it was): the solve still
    converges, to the values of the ordered run (float64 at nx = 20, where
    the top values are well defined, as for the ARPACK check above)."""
    from eigenex_tpu_torch.solvers import krylov_schur

    trsen = krylov_schur._trsen
    calls = []

    def refuse_first(select, T, Q):
        calls.append(len(calls) % 2 == 0)
        return (T, Q, False) if calls[-1] else trsen(select, T, Q)

    ordered, _, _ = solve(20, 0, torch.float64, tol=1e-10)
    monkeypatch.setattr(krylov_schur, "_trsen", refuse_first)
    res, resid, _ = solve(20, 0, torch.float64, tol=1e-10)
    assert sum(calls) >= 2
    assert res.converged and resid <= 1e-7
    top = convection_diffusion.dominant_magnitude({"nx": 20, "conv": 0.4})
    assert np.abs(res.eigenvalues - ordered.eigenvalues).max() <= 1e-7 * top
