"""Worker file of the port's cross-process tests: the port's worker
(:func:`eigenex_tpu_torch.parallel.multiproc.main`) with two scenarios of
the tests' own, ``routes`` (every ``mesh=`` front end) and ``fail`` (a
process that raises or stalls).  :func:`spawn` runs it with
``worker=__file__``; the tests also call :func:`scenario_routes` in one
process for the comparison."""

import tempfile
import time

import numpy as np
import torch

import eigenex_tpu_torch as ext
from eigenex_tpu_torch.parallel.distributed import distributed_lanczos_steps
from eigenex_tpu_torch.parallel.multiproc import main
from eigenex_tpu_torch.parallel.shard_map import P, shard_map
from eigenex_tpu_torch.utils.checkpoint import load_state, save_state, shard_state


def _banded_dense(n: int, seed: int, bw: int = 6) -> np.ndarray:
    """A banded symmetric matrix with dyadic entries."""
    rng = np.random.default_rng(seed)
    A = np.round(rng.standard_normal((n, n)) * 8) / 8
    A = np.triu(np.tril(A, bw), -bw)
    A = (A + A.T) / 2
    return A + np.diag(np.round(np.linspace(0, 6, n) * 16) / 16)


def scenario_routes(mesh, n=64, seed=11):
    """Every ``mesh=`` front end on the global mesh, on numpy-seeded f64
    operands: ``eigsh`` (halo; an accelerated pack on the sym_halo ring),
    ``eigs`` (allgather, and the 2-D panel grid of the same shards),
    ``svds``, ``eigsh_window``, ``eigsh_range``, the KPM moments, and a
    state placed by ``shard_state`` / ``load_state(mesh=)`` driven by
    ``distributed_lanczos_steps``.  Every result is replicated."""
    dev = mesh.first_device
    A = _banded_dense(n, seed)
    coo = ext.coo_from_dense(A, device=dev)
    r, c = np.nonzero(A)
    bsr = ext.bsr_from_coo_arrays(r, c, A[r, c], A.shape, (4, 4), device=dev)
    rng = np.random.default_rng(seed)
    G = np.round(rng.standard_normal((n, n)) * 8) / 8 * (rng.random((n, n)) < 0.1) + np.diag(
        np.linspace(1, 4, n))
    gcoo = ext.coo_from_dense(G, device=dev)
    grid = mesh.reshape((2, mesh.size // 2), ("rows", "cols"))
    ev = np.linalg.eigvalsh(A)
    out = {}
    out["eigsh_halo"] = ext.eigsh(coo, k=3, tol=1e-12, mesh=mesh, matvec_mode="halo").eigenvalues
    acc = ext.accelerate((r, c, A[r, c], A.shape), dtype=torch.float64, device=dev)
    out["eigsh_accelerated"] = ext.eigsh(acc, k=2, which="SA", tol=1e-12, mesh=mesh).eigenvalues
    out["eigs_allgather"] = ext.eigs(gcoo, k=3, which="LM", tol=1e-12, mesh=mesh).eigenvalues
    out["eigs_grid"] = ext.eigs(gcoo, k=3, which="LM", tol=1e-12, mesh=grid).eigenvalues
    out["svds"] = ext.svds(gcoo, k=3, tol=1e-12, mesh=mesh, return_singular_vectors=False)
    win = (float(ev[0] - 0.5), float((ev[3] + ev[4]) / 2))
    out["eigsh_window"] = ext.eigsh_window(bsr, win, block_size=8, degree=30, tol=1e-10,
                                           max_iterations=80, mesh=mesh,
                                           matvec_mode="sym_halo").eigenvalues
    iv = (float(ev[0] - 0.5), float((ev[4] + ev[5]) / 2))
    out["eigsh_range"] = ext.eigsh_range(bsr, iv, block_size=10, slack=3, degree=30, tol=1e-10,
                                         n_moments=60, max_iterations=80, mesh=mesh).eigenvalues
    out["moments"] = ext.chebyshev_moments(bsr, 40, mesh=mesh, spectral_bounds=(-10, 10))[0]
    op = coo.as_linear_operator()
    state = ext.lanczos_steps(op, ext.init_lanczos_state(op, 12, v0=torch.ones(n, dtype=op.dtype,
                                                                              device=dev)), 4)
    placed = distributed_lanczos_steps(bsr, shard_state(state, mesh), 4, mesh)
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/state.npz"
        save_state(path, state)
        loaded = distributed_lanczos_steps(bsr, load_state(path, mesh=mesh), 4, mesh)
    out["shard_state_alpha"] = placed.alpha
    out["load_state_alpha"] = loaded.alpha
    out["exact"] = ev[:6]

    def plain(v):  # complex values as (real, imag) pairs, for JSON
        a = np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
        return (np.stack([a.real, a.imag], -1) if np.iscomplexobj(a) else a).tolist()

    return {k: plain(v) for k, v in out.items()}


def scenario_fail(mesh, fail_rank=1, stall=0.0):
    """Every process enters a ``shard_map`` whose bodies psum once; the
    shards of ``fail_rank`` then raise (or, with ``stall`` seconds, sleep
    past the collective timeout) while the others wait at their second
    psum: every process must raise, none may hang."""
    def body(c, v):
        v = c.psum(v, mesh.axis_names[0])
        if mesh.process_index == fail_rank:
            if not stall:
                raise RuntimeError(f"deliberate failure on process {fail_rank}")
            time.sleep(stall)
        return c.psum(v, mesh.axis_names[0])

    shard_map(body, mesh, (P(mesh.axis_names[0]),), P(mesh.axis_names[0]))(
        torch.ones(mesh.size * 4, device=mesh.first_device))
    return {}


if __name__ == "__main__":
    main(scenarios={"routes": scenario_routes, "fail": scenario_fail})
