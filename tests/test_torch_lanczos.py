"""Lanczos parity in f64 with an explicit start vector: the recurrence
coefficients of ``lanczos_steps`` and the eigenvalues of
``LanczosEigenSolver`` of the port against the JAX package, on the same
numpy-seeded operator.

Tolerances: alpha/beta to 1e-12 over 32 steps (the fused CGS2 arithmetic is
kept, so the two recurrences differ by rounding order only); eigenvalues to
1e-10, the correctness target of BASELINE.json.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigenex_tpu.solvers import arnoldi as ja
from eigenex_tpu.solvers import block_lanczos as jb
from eigenex_tpu.solvers import lanczos as jl
from eigenex_tpu.sparse.bsr import bsr_from_dense as j_bsr_from_dense
from eigenex_tpu_torch.core.operators import LinearOperator, aslinearoperator
from eigenex_tpu_torch.solvers import arnoldi as ta
from eigenex_tpu_torch.solvers import block_lanczos as tb
from eigenex_tpu_torch.solvers import lanczos as tl
from eigenex_tpu_torch.sparse.bsr import bsr_from_dense
from eigenex_tpu_torch.utils import profiling
from eigenex_tpu_torch.utils.exceptions import LanczosError
from eigenex_tpu_torch.utils.tolerance import default_breakdown_threshold

torch.set_num_threads(1)


def operator_pair(n=192, seed=0, block=8):
    """The same banded symmetric f64 operator as a BSR container of each package."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    A = np.triu(np.tril(A, 20), -20)
    A = (A + A.T) / 2
    jop = j_bsr_from_dense(A, (block, block)).as_linear_operator(use_pallas=False)
    top = bsr_from_dense(A, (block, block), device="cpu").as_linear_operator()
    return A, jop, top


def start(n, seed=1):
    return np.random.default_rng(seed).standard_normal(n)


@pytest.mark.parametrize("interval", [1, 3, 0])
def test_alpha_beta_match_reference_over_32_steps(interval):
    A, jop, top = operator_pair()
    v0 = start(A.shape[0])
    js = jl.init_lanczos_state(jop, 40, jnp.asarray(v0))
    ts = tl.init_lanczos_state(top, 40, torch.as_tensor(v0))
    for _ in range(4):  # four chunks of 8: the state is carried across chunks
        js = jl.lanczos_steps(jop, js, 8, reorthogonalize_interval=interval)
        ts = tl.lanczos_steps(top, ts, 8, reorthogonalize_interval=interval)
    assert int(js.k) == 32 and ts.host_flags() == (32, False, False)
    np.testing.assert_allclose(ts.alpha.numpy(), np.asarray(js.alpha), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ts.beta.numpy(), np.asarray(js.beta), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ts.V[:33].numpy(), np.asarray(js.V[:33]), rtol=0, atol=1e-11)
    if interval == 1:
        G = ts.V[:33].numpy() @ ts.V[:33].numpy().T
        assert np.abs(G - np.eye(33)).max() < 1e-13


def test_shift_and_deflation_match_reference():
    A, jop, top = operator_pair(seed=3)
    n = A.shape[0]
    v0 = start(n, 4)
    D = np.linalg.qr(np.random.default_rng(5).standard_normal((n, 2)))[0].T
    js = jl.init_lanczos_state(jop, 16, jnp.asarray(v0), deflate=jnp.asarray(D))
    ts = tl.init_lanczos_state(top, 16, torch.as_tensor(v0), deflate=torch.as_tensor(D))
    js = jl.lanczos_steps(jop, js, 16, shift=0.75, deflate=jnp.asarray(D))
    ts = tl.lanczos_steps(top, ts, 16, shift=0.75, deflate=torch.as_tensor(D))
    np.testing.assert_allclose(ts.alpha.numpy(), np.asarray(js.alpha), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ts.beta.numpy(), np.asarray(js.beta), rtol=0, atol=1e-12)
    assert np.abs(D @ ts.V[:17].numpy().T).max() < 1e-13


def test_steps_stop_at_the_preallocated_subspace():
    A, jop, top = operator_pair(n=64)
    ts = tl.init_lanczos_state(top, 10, torch.as_tensor(start(64)))
    ts = tl.lanczos_steps(top, ts, 25)
    assert ts.host_flags() == (10, False, False)
    again = tl.lanczos_steps(top, ts, 5)  # nothing left to run
    assert again.host_flags() == (10, False, False)


def test_chunk_updates_the_basis_in_place():
    A, jop, top = operator_pair(n=64)
    ts = tl.init_lanczos_state(top, 8, torch.as_tensor(start(64)))
    out = tl.lanczos_steps(top, ts, 4)
    assert out.V.data_ptr() == ts.V.data_ptr() and out.alpha.data_ptr() == ts.alpha.data_ptr()


def test_breakdown_is_a_flag_and_later_steps_are_no_ops():
    # v0 inside a 3-dimensional invariant subspace: beta_3 = 0
    d = np.arange(1.0, 21.0)
    v0 = np.zeros(20)
    v0[[2, 7, 11]] = [1.0, -2.0, 0.5]
    jop = jl.aslinearoperator(jnp.asarray(np.diag(d)))
    top = aslinearoperator(np.diag(d), device="cpu")
    js = jl.lanczos_steps(jop, jl.init_lanczos_state(jop, 12, jnp.asarray(v0)), 8)
    ts = tl.lanczos_steps(top, tl.init_lanczos_state(top, 12, torch.as_tensor(v0)), 8)
    assert ts.host_flags() == (int(js.k), bool(js.breakdown), bool(js.failed)) == (3, True, False)
    np.testing.assert_allclose(ts.alpha.numpy(), np.asarray(js.alpha), atol=1e-12)
    np.testing.assert_allclose(ts.beta.numpy(), np.asarray(js.beta), atol=1e-12)
    assert torch.all(ts.V[4:] == 0)
    res = (tl.LanczosEigenSolver(top, tl.LanczosOptions(max_eigenvalues=3, max_subspace=12))
           .set_initial_vector(v0).compute())
    assert res.termination == "breakdown" and res.converged
    np.testing.assert_allclose(res.eigenvalues, [3.0, 8.0, 12.0], atol=1e-12)


def test_non_finite_operator_sets_failed_without_spreading_nans():
    n = 16
    d = torch.arange(1.0, n + 1, dtype=torch.float64)
    calls = {"n": 0}

    def matvec(_, x):  # the third application overflows into NaN
        calls["n"] += 1
        y = d * x
        return y if calls["n"] < 3 else y * float("nan")

    op = LinearOperator(matvec, None, (n, n), torch.float64, "cpu")
    ts = tl.init_lanczos_state(op, 8, torch.as_tensor(start(n)))
    ts = tl.lanczos_steps(op, ts, 6)
    assert ts.host_flags() == (2, False, True)  # two finite steps kept, then stop
    assert calls["n"] == 6  # later steps of the chunk still run, masked into no-ops
    assert torch.isfinite(ts.alpha).all() and torch.isfinite(ts.beta).all()
    assert torch.isfinite(ts.V).all()
    calls["n"] = 0
    solver = tl.LanczosEigenSolver(op, tl.LanczosOptions(max_subspace=8, check_every=4))
    res = solver.set_initial_vector(start(n)).compute()
    assert res.termination == "numerical_failure" and not res.converged
    assert res.iterations == 2 and solver.has_error()


def test_initial_vector_errors():
    _, _, top = operator_pair(n=64)
    with pytest.raises(LanczosError):
        tl.init_lanczos_state(top, 8, torch.zeros(64, dtype=torch.float64))
    with pytest.raises(LanczosError):
        tl.init_lanczos_state(top, 8, torch.full((64,), float("nan"), dtype=torch.float64))
    with pytest.raises(LanczosError):
        tl.init_lanczos_state(top, 8, torch.ones(63, dtype=torch.float64))


def test_seeded_start_vector_is_reproducible_and_unit_norm():
    _, _, top = operator_pair(n=64)
    a = tl.init_lanczos_state(top, 4, seed=5).V[0]
    b = tl.init_lanczos_state(top, 4, seed=5).V[0]
    c = tl.init_lanczos_state(top, 4, seed=6).V[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert abs(float(torch.linalg.vector_norm(a)) - 1) < 1e-14


@pytest.mark.parametrize("indices", [(0, 1, 2), (-3, -2, -1), (0, -1)])
def test_lanczos_eigensolver_matches_reference(indices):
    A, jop, top = operator_pair(n=160, seed=7)
    v0 = start(160, 8)
    kw = dict(max_eigenvalues=len(indices), eigenvalue_indices=indices, tolerance=1e-13,
              max_subspace=160)
    jres = jl.LanczosEigenSolver(jop, jl.LanczosOptions(**kw)).set_initial_vector(
        jnp.asarray(v0)).compute()
    tres = tl.LanczosEigenSolver(top, tl.LanczosOptions(**kw)).set_initial_vector(
        torch.as_tensor(v0)).compute()
    assert tres.converged and tres.termination == jres.termination
    assert tres.iterations == jres.iterations
    np.testing.assert_allclose(tres.eigenvalues, jres.eigenvalues, rtol=0, atol=1e-10)
    ev = np.linalg.eigvalsh(A)
    np.testing.assert_allclose(tres.eigenvalues, ev[list(indices)], rtol=0, atol=1e-10)
    X, Xref = tres.eigenvectors.numpy(), np.asarray(jres.eigenvectors)
    assert np.abs(np.abs(np.sum(X * Xref, axis=0)) - 1).max() < 1e-8  # same vectors up to sign
    assert tres.residual_norms(top).max() < 1e-8
    assert len(tres.trace.iterations) == len(jres.trace.iterations)


def test_continue_to_compute_grows_the_subspace():
    A, _, top = operator_pair(n=96, seed=9)
    solver = tl.LanczosEigenSolver(top, tl.LanczosOptions(tolerance=1e-14, max_subspace=16))
    solver.set_initial_vector(start(96, 2))
    first = solver.compute()
    assert first.termination == "max_iterations" and solver.has_warn()
    res = solver.set_max_subspace(96).continue_to_compute()
    assert res.iterations > 16 and res.converged
    assert abs(res.eigenvalues[0] - np.linalg.eigvalsh(A)[0]) < 1e-10


def test_arnoldi_steps_match_reference():
    A, jop, top = operator_pair(seed=11)
    v0 = start(A.shape[0], 12)
    js = ja.arnoldi_steps(jop, ja.init_arnoldi_state(jop, 24, jnp.asarray(v0)), 24)
    ts = ta.arnoldi_steps(top, ta.init_arnoldi_state(top, 24, torch.as_tensor(v0)), 24)
    assert ts.host_flags() == (24, False, False)
    np.testing.assert_allclose(ts.H.numpy(), np.asarray(js.H), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ts.V.numpy(), np.asarray(js.V), rtol=0, atol=1e-11)
    assert abs(float(ts.residue) - float(js.residue)) < 1e-12


BLOCK = 4
CHUNKS = ["arnoldi", "lanczos", "lanczos_every_3", "block_lanczos"]


def chunk_case(kind, first, steps, arnoldi_chunk=ta._arnoldi_chunk_body):
    """On a dense f64 operator of n = 96: the port's state after ``first``
    steps of chunk ``kind`` (block Lanczos: with ``first`` filled rows), the
    basis rows that state holds, the rows ``steps`` more steps leave filled,
    a function that runs those steps as one chunk on a given state, and the
    outputs of the JAX package's masked chunks over the same steps."""
    A, _, _ = operator_pair(n=96, seed=5)
    jop, top = jl.aslinearoperator(jnp.asarray(A)), aslinearoperator(A, device="cpu")
    bd = default_breakdown_threshold(torch.float64)
    if kind == "block_lanczos":
        v0 = np.random.default_rng(6).standard_normal((BLOCK, 96))
        js = jb.init_block_lanczos_state(jop, 40, BLOCK, jnp.asarray(v0))
        js = jb.block_lanczos_steps(jop, js, first // BLOCK - 1, block_size=BLOCK)
        state = tb.init_block_lanczos_state(top, 40, BLOCK, v0)
        state = tb.block_lanczos_steps(top, state, first // BLOCK - 1, block_size=BLOCK)
        js = jb.block_lanczos_steps(jop, js, steps, block_size=BLOCK)
        live = first + BLOCK * steps
        return (state, first, live,
                lambda st: tb._block_chunk(top, st, 0.0, bd, k_start=first, num_steps=steps,
                                           block_size=BLOCK),
                (js.V[:live], js.H))
    v0 = start(96, 7)
    if kind == "arnoldi":
        state = ta.arnoldi_steps(top, ta.init_arnoldi_state(top, 16, torch.as_tensor(v0)), first)
        js = ja.arnoldi_steps(jop, ja.init_arnoldi_state(jop, 16, jnp.asarray(v0)), first)
        js = ja.arnoldi_steps(jop, js, steps)
        return (state, first + 1, first + steps + 1,
                lambda st: arnoldi_chunk(top, st, 0.0, bd, None, k_start=first,
                                         num_steps=steps),
                (js.V[:first + steps + 1], js.H, js.residue))
    every = 3 if kind == "lanczos_every_3" else 1
    state = tl.lanczos_steps(top, tl.init_lanczos_state(top, 16, torch.as_tensor(v0)), first,
                             reorthogonalize_interval=every)
    js = jl.lanczos_steps(jop, jl.init_lanczos_state(jop, 16, jnp.asarray(v0)), first,
                          reorthogonalize_interval=every)
    js = jl.lanczos_steps(jop, js, steps, reorthogonalize_interval=every)
    return (state, first + 1, first + steps + 1,
            lambda st: tl._lanczos_chunk(top, st, 0.0, bd, None, k_start=first, num_steps=steps,
                                         reorthogonalize_interval=every),
            (js.V[:first + steps + 1], js.alpha, js.beta))


def outputs(kind, state, live):
    if kind == "block_lanczos":
        return state.V[:live], state.H
    if kind == "arnoldi":
        return state.V[:live], state.H, state.residue
    return state.V[:live], state.alpha, state.beta


@pytest.mark.parametrize("kind", CHUNKS)
def test_a_chunk_reads_no_basis_row_above_the_live_ones(kind):
    """Rows above the live basis hold NaN, as stale rows after a restart may:
    the chunk's output is finite, equal to the run with those rows zeroed,
    and within 1e-6 of the JAX package's masked chunk over the same steps."""
    first = 8 if kind == "block_lanczos" else 5
    state, filled, live, run, reference = chunk_case(kind, first, 3)
    got = {}
    for name, fill in (("zeroed", 0.0), ("stale", float("nan"))):
        st = dataclasses.replace(state, **{f.name: getattr(state, f.name).clone()
                                           for f in dataclasses.fields(state)})
        st.V[filled:] = fill
        out = run(st)
        assert out.host_flags() == (live - (0 if kind == "block_lanczos" else 1), False, False)
        got[name] = outputs(kind, out, live)
    for stale, zeroed, ref in zip(got["stale"], got["zeroed"], reference):
        assert torch.isfinite(stale).all()
        assert torch.equal(stale, zeroed)
        ref = np.asarray(ref)
        assert np.linalg.norm(stale.numpy() - ref) <= 1e-6 * np.linalg.norm(ref)


@pytest.mark.parametrize("kind, first, steps, rows", [
    ("arnoldi", 3, 5, 4 + 5 + 6 + 7 + 8),
    ("lanczos", 3, 5, 4 + 5 + 6 + 7 + 8),
    ("lanczos_every_3", 3, 5, 6),  # CGS2 at step 5 alone, over rows 0..5
    ("block_lanczos", 4, 2, 4 + 8),  # block steps at k = 4 and 8, over rows < k
])
def test_a_chunk_counts_the_rows_its_cgs2_reads(kind, first, steps, rows):
    # Arnoldi through its dispatch, which counts where graph replays pass too
    state, _, _, run, _ = chunk_case(kind, first, steps, arnoldi_chunk=ta._arnoldi_chunk)
    profiling.reset_counters("cgs2.")
    run(state)
    assert profiling.counters("cgs2.") == {"cgs2.rows": rows, "cgs2.steps": steps}
