"""The graph set of a solve on the CPU (``eigenex_tpu_torch.solvers.chunk_graph``).

No graph is made here (no card), but every chunk of a thick-restart, a
Krylov-Schur and a GMRES solve still goes through the set: it runs on the
state tensors the solver keeps for the whole solve, and the solver writes its
restarts into them with ``copy_``.  These tests hold each such chunk bit for
bit to ``_arnoldi_chunk_body`` run on a copy of its input, count the keys a
small solve makes against the count the module's design predicts, and check
which operators say they may be captured.  The captures themselves, replays
and their launch counts are card-only (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from eigenex_tpu_torch.core.operators import LinearOperator, aslinearoperator
from eigenex_tpu_torch.convert import bsr_from_numpy
from eigenex_tpu_torch.parallel import make_mesh, mesh_operator
from eigenex_tpu_torch.solvers import arnoldi as arnoldi_mod
from eigenex_tpu_torch.solvers import chunk_graph
from eigenex_tpu_torch.solvers import gmres as gmres_mod
from eigenex_tpu_torch.solvers.arnoldi import ArnoldiState, _arnoldi_chunk_body
from eigenex_tpu_torch.solvers.cg import _Counted, _new_stats
from eigenex_tpu_torch.solvers.krylov_schur import KrylovSchurArnoldiSolver, KrylovSchurOptions
from eigenex_tpu_torch.solvers.restart import ThickRestartLanczosEigenSolver, ThickRestartOptions
from eigenex_tpu_torch.sparse.coo import coo_from_dense
from eigenex_tpu_torch.sparse.csr import csr_from_dense
from eigenex_tpu_torch.sparse.sym_bsr import sym_bsr_from_bsr

N = 96


def dense(seed, symmetric):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N, N))
    return torch.as_tensor((A + A.T) / 2 if symmetric else A + 4 * np.eye(N))


fields = chunk_graph.state_tensors


def snapshot(state):
    return ArnoldiState(*(t.clone() for t in fields(state)))


@pytest.fixture
def recorded(monkeypatch):
    """Every chunk the dispatch runs: (input copy, arguments, result copy,
    addresses of the result's tensors)."""
    calls = []
    dispatch = arnoldi_mod._arnoldi_chunk

    def record(op, state, shift, bd, deflate, *, k_start, num_steps, comm=None):
        before = snapshot(state)
        out = dispatch(op, state, shift, bd, deflate, k_start=k_start, num_steps=num_steps,
                       comm=comm)
        calls.append((op, before, (shift, bd, deflate, k_start, num_steps), snapshot(out),
                      tuple(t.data_ptr() for t in fields(out))))
        return out

    monkeypatch.setattr(arnoldi_mod, "_arnoldi_chunk", record)
    monkeypatch.setattr(gmres_mod, "_arnoldi_chunk", record)
    return calls


def assert_chunks_are_the_body(calls):
    """Each chunk's result equals the body run on a copy of its input, bit
    for bit, and all of a solve's chunks ran on the same six tensors."""
    for op, before, (shift, bd, deflate, k_start, num_steps), after, _ in calls:
        plain = _arnoldi_chunk_body(op, snapshot(before), shift, bd, deflate,
                                    k_start=k_start, num_steps=num_steps)
        for got, want in zip(fields(after), fields(plain)):
            assert torch.equal(got, want)
    assert len({addresses for *_, addresses in calls}) == 1


def test_a_thick_restart_runs_its_chunks_on_the_static_buffers(recorded):
    chunk_graph.reset_graph_counts()
    solver = ThickRestartLanczosEigenSolver(
        dense(0, True), ThickRestartOptions(max_eigenvalues=2, max_subspace=16, num_kept=6,
                                            tolerance=1e-12, max_restarts=4, seed=1))
    solver.compute()
    assert len(recorded) == 5  # the first chunk and 4 restarts: not converged by then
    assert_chunks_are_the_body(recorded)
    # keys: (0, m) once, then (p, m - p) at every restart; nothing captured on the CPU
    counts = chunk_graph.graph_counts()
    assert counts["keys"] == 2 and counts["solves"] == 1
    assert counts["eager"] == 5 and counts["captures"] == counts["replays"] == 0


def test_a_krylov_schur_restart_runs_on_the_static_buffers(recorded):
    chunk_graph.reset_graph_counts()
    solver = KrylovSchurArnoldiSolver(
        dense(1, False), KrylovSchurOptions(max_eigenvalues=2, max_subspace=14,
                                            tolerance=1e-12, max_restarts=3, seed=2))
    solver.compute()
    assert len(recorded) == 4
    assert_chunks_are_the_body(recorded)
    # (0, m), then (p', m - p') with p' the kept count: p, or one less where a
    # conjugate pair would split; 2 or 3 keys
    assert 2 <= chunk_graph.graph_counts()["keys"] <= 3


def test_two_gmres_cycles_run_on_the_static_buffers(recorded):
    chunk_graph.reset_graph_counts()
    A = dense(2, False)
    shifted = _Counted(aslinearoperator(A), 0.5, _new_stats()).operator()
    b = torch.as_tensor(np.random.default_rng(3).standard_normal(N))
    x = gmres_mod.gmres_solve_jit(shifted, b, restart=10, cycles=2, tol=0.0)
    assert len(recorded) == 2
    assert_chunks_are_the_body(recorded)
    counts = chunk_graph.graph_counts()
    assert counts["keys"] == 1 and counts["eager"] == 2
    # the same solve with no set: the cycles' states made anew, the body called
    # directly, as before the graphs
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gmres_mod, "_arnoldi_chunk", arnoldi_mod._arnoldi_chunk_body)
        mp.setattr(gmres_mod, "_cycle_state", lambda op, m: ArnoldiState(
            V=torch.zeros((m + 1, N), dtype=op.dtype), H=torch.zeros((m + 1, m), dtype=op.dtype),
            k=torch.zeros((), dtype=torch.int64), breakdown=torch.zeros((), dtype=torch.bool),
            residue=torch.zeros((), dtype=op.dtype), failed=torch.zeros((), dtype=torch.bool)))
        assert torch.equal(gmres_mod.gmres_solve_jit(shifted, b, restart=10, cycles=2, tol=0.0), x)


def test_an_inner_gmres_solve_joins_the_set_of_its_outer_solve():
    chunk_graph.reset_graph_counts()
    with chunk_graph.solve_graphs() as outer:
        shifted = _Counted(aslinearoperator(dense(4, False)), 0.1, _new_stats()).operator()
        b = torch.ones(N, dtype=torch.float64)
        for _ in range(3):
            gmres_mod.gmres_solve_jit(shifted, b, restart=6, cycles=1)
            assert chunk_graph.current() is outer
    assert chunk_graph.current() is None
    counts = chunk_graph.graph_counts()
    assert counts["solves"] == 1 and counts["keys"] == 1 and counts["eager"] == 3


def banded_bsr(device="cpu"):
    rng = np.random.default_rng(5)
    nbr, b = 4, 8
    data = np.zeros((nbr, 2, b, b), np.float32)
    cols = np.zeros((nbr, 2), np.int32)
    for r in range(nbr):
        data[r, 0], cols[r, 0] = np.eye(b) * 2, r
        if r + 1 < nbr:
            data[r, 1], cols[r, 1] = rng.standard_normal((b, b)), r + 1
    return bsr_from_numpy(data, cols, (nbr * b, nbr * b), device=device)


def test_which_operators_say_they_may_be_captured():
    bsr = banded_bsr()
    A = dense(6, False)
    # the block containers only on CUDA and in a kernel storage: here on the CPU
    # neither is; on the card tests/test_torch_cuda.py sees both say so
    assert not bsr.as_linear_operator().capturable
    assert not sym_bsr_from_bsr(bsr).as_linear_operator().capturable
    for op in (coo_from_dense(A.numpy(), device="cpu").as_linear_operator(),
               csr_from_dense(A.numpy(), device="cpu").as_linear_operator(),
               aslinearoperator(A),
               LinearOperator(lambda _, x: A @ x, None, A.shape, A.dtype, "cpu")):
        assert not op.capturable
    mesh = make_mesh(devices=["cpu"] * 2)
    assert not mesh_operator(bsr, mesh, matvec_mode="allgather").capturable
    # GMRES's shifted operator keeps its base operator's flag
    for flag in (True, False):
        base = LinearOperator(lambda _, x: A @ x, None, A.shape, A.dtype, "cpu", capturable=flag)
        assert _Counted(base, 0.5, _new_stats()).operator().capturable is flag


def test_eager_chunks_switches_graphs_off_and_back():
    assert chunk_graph._eager_depth == 0
    with chunk_graph.eager_chunks():
        assert chunk_graph._eager_depth > 0
        with chunk_graph.eager_chunks():
            assert chunk_graph._eager_depth > 0
        assert chunk_graph._eager_depth > 0
    assert chunk_graph._eager_depth == 0
    with pytest.raises(RuntimeError, match="inside"):
        with chunk_graph.eager_chunks():
            raise RuntimeError("inside")
    assert chunk_graph._eager_depth == 0
