"""Block Lanczos parity in f64 on the CPU with an explicit start block: the
band-projected matrix of ``block_lanczos_steps`` and the eigenvalues of
``BlockLanczosEigenSolver`` of the port against the JAX package, on the same
numpy-seeded operator.

Tolerances: H and V to 1e-11 over 6 block steps (block CGS2 and the thin QR
with its phase fix are kept, so the two differ by rounding order only);
eigenvalues to 1e-10 with the same iteration count and termination.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eigenex_tpu as ex
import eigenex_tpu_torch as ext
from eigenex_tpu.solvers import block_lanczos as jb
from eigenex_tpu_torch.core.operators import LinearOperator
from eigenex_tpu_torch.solvers import block_lanczos as tb
from eigenex_tpu_torch.utils.exceptions import LanczosError

torch.set_num_threads(1)

N, B = 96, 4


def matrix(seed=0):
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((N, N))
    return np.diag(np.arange(1, N + 1) * 1.0) + 0.05 * (noise + noise.T)


def start(seed=1):
    return np.random.default_rng(seed).standard_normal((B, N))


def test_steps_match_reference_across_chunks():
    A, v0 = matrix(), start()
    jop, top = ex.aslinearoperator(jnp.asarray(A)), ext.aslinearoperator(torch.as_tensor(A))
    js = jb.init_block_lanczos_state(jop, 40, B, jnp.asarray(v0))
    ts = tb.init_block_lanczos_state(top, 40, B, v0)
    for _ in range(3):  # three chunks of two block steps: the state is carried
        js = jb.block_lanczos_steps(jop, js, 2, block_size=B, shift=0.25)
        ts = tb.block_lanczos_steps(top, ts, 2, block_size=B, shift=0.25)
    assert int(js.k) == 7 * B and ts.host_flags() == (7 * B, False, False)
    np.testing.assert_allclose(ts.H.numpy(), np.asarray(js.H), rtol=0, atol=1e-11)
    np.testing.assert_allclose(ts.V.numpy(), np.asarray(js.V), rtol=0, atol=1e-11)
    V = ts.V[:7 * B].numpy()
    assert np.abs(V @ V.T - np.eye(7 * B)).max() < 1e-13
    # the projected matrix is the band V A V^T (+ shift)
    Hk = ts.H[:6 * B, :6 * B].numpy()
    want = V[:6 * B] @ (A + 0.25 * np.eye(N)) @ V[:6 * B].T
    np.testing.assert_allclose((Hk + Hk.T) / 2, want, rtol=0, atol=1e-11)


def outlier_matrix(seed):
    """Three separated eigenvalues at each end of a dense cluster: the tracked
    Ritz values settle well inside the subspace."""
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((N, N)))[0]
    w = np.concatenate([[-10.0, -8.0, -6.0], np.linspace(0, 1, N - 6), [7.0, 9.0, 11.0]])
    A = (Q * w) @ Q.T
    return (A + A.T) / 2


@pytest.mark.parametrize("indices", [(0, 1, 2), (-3, -2, -1)], ids=["lowest", "highest"])
def test_solver_matches_reference(indices):
    A, v0 = outlier_matrix(seed=2), start(3)
    kw = dict(block_size=B, max_subspace=64, max_eigenvalues=3, eigenvalue_indices=indices,
              tolerance=1e-13)
    rj = (ex.BlockLanczosEigenSolver(jnp.asarray(A), ex.BlockLanczosOptions(**kw))
          .set_initial_block(jnp.asarray(v0)).compute())
    rt = (ext.BlockLanczosEigenSolver(torch.as_tensor(A), ext.BlockLanczosOptions(**kw))
          .set_initial_block(v0).compute())
    assert rt.converged and rt.termination == rj.termination
    assert rt.iterations == rj.iterations
    np.testing.assert_allclose(rt.eigenvalues, np.asarray(rj.eigenvalues), rtol=0, atol=1e-10)
    np.testing.assert_allclose(rt.eigenvalues, np.linalg.eigvalsh(A)[list(indices)],
                               rtol=0, atol=1e-10)
    X = rt.eigenvectors.numpy()
    assert np.abs(A @ X - X * rt.eigenvalues[None, :]).max() < 1e-6


def test_max_subspace_stops_like_the_reference():
    A, v0 = matrix(seed=4), start(5)
    kw = dict(block_size=B, max_subspace=24, max_eigenvalues=2, tolerance=1e-14)
    rj = (ex.BlockLanczosEigenSolver(jnp.asarray(A), ex.BlockLanczosOptions(**kw))
          .set_initial_block(jnp.asarray(v0)).compute())
    rt = (ext.BlockLanczosEigenSolver(torch.as_tensor(A), ext.BlockLanczosOptions(**kw))
          .set_initial_block(v0).compute())
    assert rt.termination == rj.termination == "max_iterations" and not rt.converged
    assert rt.iterations == rj.iterations == 24
    np.testing.assert_allclose(rt.eigenvalues, np.asarray(rj.eigenvalues), rtol=0, atol=1e-10)


def test_degenerate_eigenvalues_are_resolved_like_the_reference():
    """A triple eigenvalue: one Krylov vector finds one copy, a block finds all."""
    rng = np.random.default_rng(6)
    Q = np.linalg.qr(rng.standard_normal((N, N)))[0]
    w = np.concatenate([[-5.0, -5.0, -5.0], np.linspace(0, 10, N - 3)])
    A = (Q * w) @ Q.T
    A = (A + A.T) / 2
    v0 = start(7)
    kw = dict(block_size=B, max_subspace=N, max_eigenvalues=4, tolerance=1e-13)
    rj = (ex.BlockLanczosEigenSolver(jnp.asarray(A), ex.BlockLanczosOptions(**kw))
          .set_initial_block(jnp.asarray(v0)).compute())
    rt = (ext.BlockLanczosEigenSolver(torch.as_tensor(A), ext.BlockLanczosOptions(**kw))
          .set_initial_block(v0).compute())
    np.testing.assert_allclose(rt.eigenvalues, [-5, -5, -5, 0], rtol=0, atol=1e-9)
    np.testing.assert_allclose(rt.eigenvalues, np.asarray(rj.eigenvalues), rtol=0, atol=1e-9)
    assert rt.termination == rj.termination


def test_breakdown_on_an_invariant_block_matches_reference():
    """A start block that spans an invariant subspace: the first residual
    block is rank-deficient."""
    A = np.diag(np.arange(1, N + 1) * 1.0)
    v0 = np.zeros((B, N))
    v0[np.arange(B), np.arange(B)] = 1.0
    kw = dict(block_size=B, max_subspace=32, max_eigenvalues=2)
    rj = (ex.BlockLanczosEigenSolver(jnp.asarray(A), ex.BlockLanczosOptions(**kw))
          .set_initial_block(jnp.asarray(v0)).compute())
    rt = (ext.BlockLanczosEigenSolver(torch.as_tensor(A), ext.BlockLanczosOptions(**kw))
          .set_initial_block(v0).compute())
    assert rt.termination == rj.termination == "breakdown"
    assert rt.iterations == rj.iterations == B
    np.testing.assert_allclose(rt.eigenvalues, [1.0, 2.0], rtol=0, atol=1e-12)
    np.testing.assert_allclose(rt.eigenvalues, np.asarray(rj.eigenvalues), rtol=0, atol=1e-12)


def test_nan_operator_fails_cleanly():
    def bad(_, X):
        return X * float("nan")

    op = LinearOperator(lambda _, x: x * float("nan"), None, (N, N), torch.float64, "cpu",
                        matmat_fn=bad)
    with pytest.raises(LanczosError, match="first block-Lanczos step"):
        tb.BlockLanczosEigenSolver(op, tb.BlockLanczosOptions(block_size=B, max_subspace=16)
                                   ).set_initial_block(start(8)).compute()


def test_masked_steps_after_breakdown_change_nothing():
    A = np.diag(np.arange(1, N + 1) * 1.0)
    top = ext.aslinearoperator(torch.as_tensor(A))
    v0 = np.zeros((B, N))
    v0[np.arange(B), np.arange(B)] = 1.0
    ts = tb.init_block_lanczos_state(top, 32, B, v0)
    ts = tb.block_lanczos_steps(top, ts, 3, block_size=B)  # breaks down in step 1 of 3
    assert ts.host_flags() == (2 * B, True, False)
    H, V = ts.H.clone(), ts.V.clone()
    ts = tb.block_lanczos_steps(top, ts, 2, block_size=B)
    assert ts.host_flags() == (2 * B, True, False)
    assert torch.equal(ts.H, H) and torch.equal(ts.V, V)


def test_validation_errors():
    top = ext.aslinearoperator(torch.eye(N, dtype=torch.float64))
    with pytest.raises(LanczosError, match="too small"):
        tb.init_block_lanczos_state(top, 6, B)
    with pytest.raises(LanczosError, match="initial block"):
        tb.init_block_lanczos_state(top, 32, B, np.ones((B + 1, N)))
    with pytest.raises(LanczosError, match="block_size required"):
        tb.block_lanczos_steps(top, tb.init_block_lanczos_state(top, 32, B, seed=1), 1)
    with pytest.raises(LanczosError, match="no operator"):
        tb.BlockLanczosEigenSolver().compute()
