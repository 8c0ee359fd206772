"""The slice as a whole: ``eigsh`` of the port against ``eigsh`` of the JAX
package in f64 on the CPU, on COO, BSR, SymBSR and accelerated operands
built from the same numpy-seeded matrix, with an explicit start vector.

Tolerance: eigenvalues to 1e-10 (the BASELINE.json correctness target);
eigenvectors agree up to sign.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import eigenex_tpu.native as j_native
import eigenex_tpu_torch.native as t_native
import eigenex_tpu_torch as ext
from eigenex_tpu.solvers.api import eigsh as j_eigsh
from eigenex_tpu.sparse.accelerate import accelerate as j_accelerate
from eigenex_tpu.sparse.bsr import bsr_from_dense as j_bsr_from_dense
from eigenex_tpu.sparse.coo import coo_from_dense as j_coo_from_dense
from eigenex_tpu.sparse.sym_bsr import sym_bsr_from_bsr as j_sym_bsr_from_bsr
from eigenex_tpu_torch.ops.cuda_spmv import launch_counts, reset_launch_counts
from eigenex_tpu_torch.utils.exceptions import EigenexError

torch.set_num_threads(1)

N = 240
EIG_TOL = 1e-10


def matrix(seed=0, n=N):
    """Banded symmetric matrix with dyadic entries (exact in every storage)."""
    rng = np.random.default_rng(seed)
    A = np.round(rng.standard_normal((n, n)) * 8) / 8
    A = np.triu(np.tril(A, 10), -10)
    A = (A + A.T) / 2
    return A + np.diag(np.round(np.linspace(0, 4, n) * 16) / 16)


def operands(A, kind):
    """(reference operand, port operand) of one kind, both f64 on the CPU."""
    if kind == "dense":
        return jnp.asarray(A), torch.as_tensor(A)
    if kind == "coo":
        return j_coo_from_dense(A), ext.coo_from_dense(A, device="cpu")
    jb, tb = j_bsr_from_dense(A, (8, 8)), ext.bsr_from_dense(A, (8, 8), device="cpu")
    if kind == "bsr":
        return jb, tb
    assert kind == "sym"
    return j_sym_bsr_from_bsr(jb), ext.sym_bsr_from_bsr(tb)


def same_up_to_sign(X, Xref, tol=1e-6):
    X = X.numpy() if isinstance(X, torch.Tensor) else np.asarray(X)
    Xref = np.asarray(Xref)
    assert X.shape == Xref.shape
    return np.abs(np.abs(np.sum(X * Xref, axis=0)) - 1).max() < tol


@pytest.mark.parametrize("kind", ["dense", "coo", "bsr", "sym"])
def test_eigsh_matches_reference_on_every_operand(kind):
    A = matrix()
    jA, tA = operands(A, kind)
    v0 = np.random.default_rng(1).standard_normal(N)
    kw = dict(k=3, which="SA", tol=1e-12, max_subspace=48)
    jres = j_eigsh(jA, v0=jnp.asarray(v0), **kw)
    tres = ext.eigsh(tA, v0=torch.as_tensor(v0), device="cpu", **kw)
    assert tres.converged and jres.converged
    np.testing.assert_allclose(tres.eigenvalues, jres.eigenvalues, rtol=0, atol=EIG_TOL)
    np.testing.assert_allclose(tres.eigenvalues, np.linalg.eigvalsh(A)[:3], rtol=0, atol=EIG_TOL)
    assert same_up_to_sign(tres.eigenvectors, jres.eigenvectors)
    assert tres.eigenvectors.dtype == torch.float64


@pytest.mark.parametrize("which,k", [("SA", 2), ("LA", 3), ("BE", 3), ("BE", 4), ("LM", 3)])
def test_which_modes_match_reference(which, k):
    A = matrix(seed=2) - 1.5 * np.eye(N)  # both signs present: LM has to choose
    jA, tA = operands(A, "sym")
    v0 = np.random.default_rng(3).standard_normal(N)
    kw = dict(k=k, which=which, tol=1e-12, max_subspace=56)
    jres = j_eigsh(jA, v0=jnp.asarray(v0), **kw)
    tres = ext.eigsh(tA, v0=torch.as_tensor(v0), **kw)  # device: where the container lives
    np.testing.assert_allclose(tres.eigenvalues, jres.eigenvalues, rtol=0, atol=EIG_TOL)
    ev = np.linalg.eigvalsh(A)
    want = {
        "SA": ev[:k], "LA": ev[-k:],
        "BE": np.concatenate([ev[: k // 2], ev[-(k - k // 2):]]),
        "LM": np.sort(ev[np.argsort(-np.abs(ev))[:k]]),
    }[which]
    np.testing.assert_allclose(tres.eigenvalues, want, rtol=0, atol=EIG_TOL)
    assert np.all(np.diff(tres.eigenvalues) >= 0)  # ascending, scipy convention
    assert same_up_to_sign(tres.eigenvectors, jres.eigenvectors)


def test_full_subspace_takes_plain_lanczos_like_the_reference():
    A = matrix(seed=4, n=48)
    v0 = np.random.default_rng(5).standard_normal(48)
    jres = j_eigsh(jnp.asarray(A), k=2, v0=jnp.asarray(v0), tol=1e-13)
    tres = ext.eigsh(A, k=2, v0=v0, tol=1e-13, device="cpu")  # a numpy operand
    assert tres.termination == jres.termination and tres.iterations == jres.iterations
    np.testing.assert_allclose(tres.eigenvalues, jres.eigenvalues, rtol=0, atol=EIG_TOL)


@pytest.mark.parametrize("route", ["flag", "operator"])
def test_accelerated_eigsh_matches_reference(monkeypatch, route):
    monkeypatch.setattr(j_native, "native_available", lambda: False)
    monkeypatch.setattr(t_native, "native_available", lambda: False)
    A = matrix(seed=6)
    relabel = np.random.default_rng(7).permutation(N)
    A = A[np.ix_(relabel, relabel)]  # scatter the band: RCM has to find it again
    S = sp.coo_matrix(A)
    trip = (S.row, S.col, S.data, S.shape)
    v0 = np.random.default_rng(8).standard_normal(N)
    kw = dict(k=3, which="SA", tol=1e-12, max_subspace=48)
    jacc = j_accelerate(trip, block=8, dtype=jnp.float64)
    jres = j_eigsh(jacc, v0=v0, **kw)
    if route == "operator":
        tacc = ext.accelerate(trip, block=8, dtype=torch.float64, device="cpu")
        assert np.array_equal(tacc.perm, jacc.perm)
        tres = ext.eigsh(tacc, v0=v0, **kw)
    else:  # accelerate=True packs at the auto dtype (bf16 here: dyadic values), f32 solve
        tres = ext.eigsh(S, accelerate=True, v0=v0, device="cpu", k=3, which="SA", tol=1e-6,
                         max_subspace=48)
    tol = EIG_TOL if route == "operator" else 1e-4
    np.testing.assert_allclose(tres.eigenvalues, jres.eigenvalues, rtol=0, atol=tol)
    np.testing.assert_allclose(tres.eigenvalues, np.linalg.eigvalsh(A)[:3], rtol=0, atol=tol)
    # eigenvectors come back in ORIGINAL coordinates, as host arrays
    X = tres.eigenvectors
    assert isinstance(X, np.ndarray) and X.shape == (N, 3)
    assert same_up_to_sign(X, jres.eigenvectors, 1e-6 if route == "operator" else 1e-2)
    resid = np.linalg.norm(A @ X - X * tres.eigenvalues[None, :], axis=0)
    assert resid.max() < (1e-8 if route == "operator" else 1e-3)


def test_accelerated_seeded_start_stays_out_of_the_padding():
    """Without v0 the start vector is drawn from the seed and is zero on the
    pad rows, so no spurious zero eigenvalue of the padding enters."""
    A = matrix(seed=9) + 6.0 * np.eye(N)  # spectrum well above the pad's 0
    S = sp.coo_matrix(A)
    acc = ext.accelerate((S.row, S.col, S.data, S.shape), block=8, dtype=torch.float64,
                         device="cpu")
    assert acc.shape[0] > N
    res = ext.eigsh(acc, k=2, which="SA", tol=1e-12, max_subspace=48, seed=4)
    np.testing.assert_allclose(res.eigenvalues, np.linalg.eigvalsh(A)[:2], rtol=0, atol=EIG_TOL)


def test_f32_and_bf16_storage_solve_in_f32_on_the_plain_route():
    A = matrix(seed=10)
    sym = operands(A, "sym")[1]
    ev = np.linalg.eigvalsh(A)[:2]
    reset_launch_counts()
    for storage in (torch.float32, torch.bfloat16):  # dyadic entries: both exact
        res = ext.eigsh(sym.astype(storage), k=2, tol=1e-6, max_subspace=48, seed=1)
        assert res.eigenvectors.dtype == torch.float32
        np.testing.assert_allclose(res.eigenvalues, ev, rtol=0, atol=2e-4)
    assert launch_counts() == {"bsr_spmv": 0, "sym_bsr_spmv": 0, "bsr_spmm": 0, "sym_bsr_spmm": 0,
                               "csr_spmv": 0}  # CPU: no kernel


@pytest.mark.parametrize(
    "kwargs",
    # mesh= is ported: on a dense operand, whatever it is combined with, the
    # port refuses it as the reference does (the distributed drivers split a
    # sparse operand's rows; the LOBPCG route takes no mesh) -- the same
    # error, word for word
    [dict(sigma=0.5, mesh=object()), dict(which="SM", mesh=object()),
     dict(M=np.eye(4), mesh=object()), dict(preconditioner=lambda x: x, mesh=object()),
     dict(mesh=object()), dict(refine=True, mesh=object())],
    ids=["sigma", "SM", "M", "preconditioner", "mesh", "refine"],
)
def test_unported_arguments_raise(kwargs):
    import jax
    from jax.sharding import Mesh as JMesh

    kw = {k: v for k, v in kwargs.items() if k != "mesh"}
    with pytest.raises(Exception) as ref:  # the reference's own EigenexError
        j_eigsh(jnp.eye(4), k=1, mesh=JMesh(np.array(jax.devices("cpu")[:2]), ("rows",)), **kw)
    with pytest.raises(EigenexError) as got:
        ext.eigsh(np.eye(4), k=1, device="cpu", mesh=ext.make_mesh(devices=["cpu"] * 2), **kw)
    assert str(got.value) == str(ref.value)
    assert "not ported" not in str(got.value)


def test_argument_errors():
    with pytest.raises(EigenexError, match="which"):
        ext.eigsh(np.eye(4), k=1, which="XX", device="cpu")
    with pytest.raises(EigenexError, match="square"):
        ext.eigsh(np.ones((4, 5)), k=1, device="cpu")
