"""Krylov-Schur of the port against the JAX package's, f64 on the CPU, with
the same numpy-seeded operators and the same explicit start vector (mirrors
``tests/test_krylov_schur.py``).

Tolerances: the restart's pieces (the ordered Schur form, the restart write
fed the reference's coefficients) 1e-12; eigenvalues 1e-10 against the
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
from eigenex_tpu_torch.solvers.arnoldi import ArnoldiState
from eigenex_tpu_torch.solvers.restart import _restart_into
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
    """The port's ``_which_key`` is the reference's, bit for bit.  The port's
    ordered Schur form (``_wanted_schur``) is a real Schur form of H, so it
    ranks a conjugate pair as one block, by its member that the reference's
    key ranks first: its leading blocks hold the blocks so ranked first,
    until they hold 5 values (6 where a pair sits at the cut)."""
    rng = np.random.default_rng(2)
    H = np.triu(rng.standard_normal((12, 12)), -1)  # upper Hessenberg, real
    evals = np.linalg.eigvals(H)
    np.testing.assert_array_equal(tks._which_key(evals, which), jks._which_key(evals, which))
    T, Q, kept, _ = tks._wanted_schur(H, 5, which)
    np.testing.assert_allclose(Q @ T @ Q.T, H, rtol=0, atol=1e-12)
    blocks = evals[evals.imag >= 0]  # a real value, or a pair's member above the axis
    rank = [jks._which_key(np.array([v, np.conj(v)]), which).min() for v in blocks]
    want = []
    for v in blocks[np.argsort(rank, kind="stable")]:
        if len(want) >= 5:
            break
        want += [v, np.conj(v)] if v.imag > 0 else [v]
    assert kept == len(want)
    np.testing.assert_allclose(canon(np.linalg.eigvals(T[:kept, :kept])), canon(want),
                               rtol=0, atol=1e-12)
    with pytest.raises(ArnoldiError, match="which"):
        tks._which_key(evals, "XX")


@pytest.mark.parametrize("complex_basis", [False, True], ids=["real_basis", "complex_basis"])
def test_restart_compression_matches(complex_basis):
    """The port's restart write, fed the reference's restart coefficients
    (the leading Schur vectors of ``_ordered_schur`` for a complex basis;
    for a real one the real span of them, by SVD with a rank cut of 1e-10,
    their count reduced until it fits m - 2, as the reference's loop does),
    writes rows [:p + 1] as the reference's ``_compress_basis`` does: qs^T V,
    then the residual row.  The rows above p are not compared: the
    reference zeroes them, the port leaves them as they were, since no
    Arnoldi step reads a row before it writes it."""
    rng = np.random.default_rng(3)
    k, m, n = 12, 13, 50  # 2 x 7 kept vectors > m - 2: the count is reduced
    H = np.triu(rng.standard_normal((k, k)), -1)
    _, Q, _ = jks._ordered_schur(H, 7, "LM")
    if complex_basis:
        qs = Q[:, :7]
    else:
        # the reference's loop, as written in eigenex_tpu/solvers/krylov_schur.py
        for pk_try in range(7, 0, -1):
            Qk = Q[:, :pk_try]
            span = np.concatenate([Qk.real, Qk.imag], axis=1)
            u, s, _ = np.linalg.svd(span, full_matrices=False)
            qs = u[:, : int(np.sum(s > s[0] * 1e-10))]
            if qs.shape[1] <= m - 2:
                break
        assert qs.shape[1] <= m - 2 and np.isrealobj(qs)
    p = qs.shape[1]
    V = rng.standard_normal((m + 1, n))
    if complex_basis:
        V = V + 1j * rng.standard_normal((m + 1, n))
    want = np.asarray(j_compress(jnp.asarray(V), jnp.asarray(qs), jnp.asarray(V[k])))
    dtype = torch.as_tensor(V).dtype
    state = ArnoldiState(V=torch.as_tensor(V.copy()), H=torch.ones((m + 1, m), dtype=dtype),
                         k=torch.tensor(k), breakdown=torch.tensor(True),
                         residue=torch.tensor(0.5), failed=torch.tensor(True))
    addresses = [t.data_ptr() for t in (state.V, state.H)]
    block, row = np.diag(np.arange(1.0, p + 1)), np.full(p, 0.25)
    out = _restart_into(state, qs, block, row)
    assert out is state and [t.data_ptr() for t in (out.V, out.H)] == addresses
    np.testing.assert_allclose(out.V[:p + 1].numpy(), want[:p + 1], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(out.V[p + 1:].numpy(), V[p + 1:])
    H_want = np.zeros((m + 1, m))
    H_want[:p, :p], H_want[p, :p] = block, row
    np.testing.assert_array_equal(out.H.numpy(), H_want)
    assert out.host_flags() == (p, False, False) and float(out.residue) == 0.5


def test_rejects_too_small_subspace():
    with pytest.raises(ArnoldiError, match="too small"):
        KrylovSchurArnoldiSolver(torch.eye(10, dtype=torch.float64),
                                 KrylovSchurOptions(max_eigenvalues=5, max_subspace=6)).compute()
