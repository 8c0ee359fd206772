"""Restarted GMRES for general (non-Hermitian) matrix-free operators.

Counterpart of ``eigenex_tpu/solvers/gmres.py``: GMRES(m) is the
shift-invert inner solve for *Arnoldi* eigenproblems and general linear
systems.  Each cycle builds the Krylov basis and Hessenberg with the
Arnoldi chunk (:mod:`eigenex_tpu_torch.solvers.arnoldi`, CGS2 over the
live rows on the device; on the card one CUDA graph replayed every cycle,
the cycle's state written anew into the same tensors), solves the tiny (m+1, m)
least-squares problem on the host in float64 by a complete orthogonal
factorisation (LAPACK ``gelsy``, QR with column pivoting, through
``scipy.linalg.lstsq``: the minimum-norm solution, so it stays right when the
Hessenberg loses rank at breakdown, where the card's QR-only
``torch.linalg.lstsq`` would not; a quarter of the host time of the SVD
route, ``gelsd``), and updates the iterate with one basis product.

:func:`gmres_solve_jit` keeps the reference's name: in the JAX package it
is the jittable, residual-controlled variant whose cycles run inside a
``lax.while_loop``.  Here nothing is jitted; it is the variant that reads
the residual of each cycle off the small least-squares problem, with no
extra matvec, and stops on it.  Its host reads the Hessenberg once per
cycle (the least-squares solve needs it), and that read is also its stop
test, so an f32 inner solve stops on its residual after the cycle that
reaches it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.operators import LinearOperator, aslinearoperator
from ..utils import profiling
from ..utils.exceptions import EigenexError
from ..utils.precision import highest_f32_matmul
from ..utils.tolerance import default_tolerance, real_dtype_of
from . import chunk_graph
from .arnoldi import ArnoldiState, _arnoldi_chunk, arnoldi_steps, init_arnoldi_state
from .cg import _cgls_loop, _Counted, _new_stats, _scalar_for

__all__ = ["gmres_solve", "gmres_solve_jit", "shift_invert_operator_general"]


def _lstsq_host(H: torch.Tensor, beta: float):
    """(y, H, beta e1) on the host in float64/complex128, y = argmin_y
    ||beta e1 - H y|| of least norm for the (k+1, k) Hessenberg (``gelsy``,
    any rank: the pivoted QR's rank cut at ``eps * (k + 1)``, the relative
    cutoff ``numpy.linalg.lstsq`` gives its SVD).
    The span ``eigenex.gmres.lstsq`` covers the Hessenberg's read and the
    solve; counter ``gmres.host_ms`` adds their host ms, profiler or not."""
    from scipy.linalg import lstsq

    with profiling.annotate("eigenex.gmres.lstsq"):
        t0 = time.perf_counter()
        Hh = H.to(torch.complex128 if H.is_complex() else torch.float64).cpu().numpy()
        e1 = np.zeros(Hh.shape[0], Hh.dtype)
        e1[0] = beta
        y = lstsq(Hh, e1, cond=np.finfo(np.float64).eps * max(Hh.shape),
                  lapack_driver="gelsy", check_finite=False)[0]
        profiling.count("gmres.host_ms", (time.perf_counter() - t0) * 1e3)
    return y, Hh, e1


def _cycle_state(op: LinearOperator, m: int) -> ArnoldiState:
    """The state tensors of GMRES(m) on ``op``, made once a solve by the
    solve's graph set and written anew at each cycle, so that the cycle's
    chunk graph keeps its addresses."""
    n, dtype, dev = op.shape[1], op.dtype, op.device

    def make():
        return ArnoldiState(
            V=torch.zeros((m + 1, n), dtype=dtype, device=dev),
            H=torch.zeros((m + 1, m), dtype=dtype, device=dev),
            k=torch.zeros((), dtype=torch.int64, device=dev),
            breakdown=torch.zeros((), dtype=torch.bool, device=dev),
            residue=torch.zeros((), dtype=real_dtype_of(dtype), device=dev),
            failed=torch.zeros((), dtype=torch.bool, device=dev),
        )

    return chunk_graph.current().buffers(op, ("gmres", m), make)


@highest_f32_matmul()
@chunk_graph.solve_graphs()
@torch.no_grad()
def gmres_solve(op, b, x0=None, *, restart: int = 32, tol: float | None = None,
                max_restarts: int = 100):
    """Solve A x = b with restarted GMRES(m).

    Returns (x, relative_residual, cycles); x is a device tensor."""
    op = aslinearoperator(op)
    if op.shape[0] != op.shape[1]:
        raise EigenexError("GMRES requires a square operator")
    if tol is None:
        tol = max(default_tolerance(op.dtype), 1e-14)
    b = torch.as_tensor(b).to(device=op.device, dtype=op.dtype)
    x = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0).to(b)
    bnorm = float(torch.linalg.vector_norm(b))
    if bnorm == 0:
        return torch.zeros_like(b), 0.0, 0

    rel = np.inf
    x_prev = x
    for cycle in range(max_restarts):
        r = b - op.matvec(x)
        beta = float(torch.linalg.vector_norm(r))
        rel = beta / bnorm
        if not np.isfinite(rel):
            # numerical failure: return the last finite iterate, flagged
            return x_prev, float("inf"), cycle
        if rel <= tol:
            return x, rel, cycle
        x_prev = x
        m = min(restart, op.shape[0])
        # breakdown_threshold=0: ||r|| is already known > 0 (rel > tol) and
        # the absolute dtype default would spuriously reject small-norm
        # residuals of well-scaled systems
        fresh = init_arnoldi_state(op, m, v0=r, breakdown_threshold=0.0)
        state = _cycle_state(op, m)
        for buffer, value in zip(*map(chunk_graph.state_tensors, (state, fresh))):
            buffer.copy_(value)
        state = arnoldi_steps(op, state, m, breakdown_threshold=0.0)
        profiling.count("gmres.cycles")
        k = int(state.k)
        y, _, _ = _lstsq_host(state.H[: k + 1, :k], beta)
        x = x + state.V[:k].T @ torch.as_tensor(y).to(device=x.device, dtype=x.dtype)
    r = b - op.matvec(x)
    rel = float(torch.linalg.vector_norm(r)) / bnorm
    return x, rel, max_restarts


@highest_f32_matmul()
@chunk_graph.solve_graphs()
@torch.no_grad()
def gmres_solve_jit(op, b, x0=None, *, restart: int = 32, cycles: int = 10, tol=0.0):
    """GMRES(m) with residual-controlled restart cycles: at most ``cycles``
    cycles, stopping early once the relative residual reaches ``tol``.

    The residual is read off the small least-squares problem
    (||b - A x_new|| = min_y ||beta e1 - H y||, the GMRES identity), so the
    stopping test costs no extra matvec.  ``tol=0`` runs the whole
    budget.  A non-finite iterate (operator overflow) ends the loop with
    the last finite ``x``.  Returns x, a device tensor."""
    op = aslinearoperator(op)
    m = min(int(restart), op.shape[0])
    n = op.shape[1]
    dtype = op.dtype
    rdt = real_dtype_of(dtype)
    dev = op.device
    b = torch.as_tensor(b).to(device=dev, dtype=dtype)
    x = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0).to(b)
    bnorm = float(torch.linalg.vector_norm(b))
    safe_bnorm = bnorm if bnorm > 0 else 1.0
    tol = float(tol)
    # the initial "residual" is FINITE and larger than any meaningful tol
    rel = float(torch.finfo(rdt).max)
    for _ in range(int(cycles)):
        if not (rel > tol and np.isfinite(rel)):
            break
        r = b - op.matvec(x)
        beta_t = torch.linalg.vector_norm(r).to(rdt)
        safe = torch.where(beta_t > 0, beta_t, torch.ones_like(beta_t))
        state = _cycle_state(op, m)
        state.V.zero_()
        state.V[0] = r / safe.to(dtype)
        state.H.zero_()
        state.k.zero_()
        state.breakdown.copy_(beta_t <= 0)
        state.residue.copy_(beta_t)
        state.failed.zero_()
        state = _arnoldi_chunk(op, state, 0.0, 1e-30, None, k_start=0, num_steps=m)
        profiling.count("gmres.cycles")
        beta = float(beta_t)
        y, Hh, e1 = _lstsq_host(state.H, beta)
        res_small = float(np.linalg.norm(Hh @ y - e1))
        x_new = x + state.V[:m].T @ torch.as_tensor(y).to(device=dev, dtype=dtype)
        if bool(torch.isfinite(x_new).all()) and not bool(state.failed):
            x, rel = x_new, res_small / safe_bnorm
        else:
            rel = float("inf")
    return x


def shift_invert_operator_general(
    op, sigma, *, restart: int = 48, cycles: int = 24, tol: float | None = None
) -> LinearOperator:
    """(A - sigma I)^-1 for a general operator, inner-solved with
    residual-controlled GMRES(restart) -- feeds :class:`ArnoldiEigenSolver`
    and Krylov-Schur for interior eigenvalues of nonsymmetric operators.

    ``tol``: inner relative-residual target per applied matvec; the outer
    Ritz accuracy is bounded below by this, so it defaults to the dtype
    tolerance (1e-12 f64 / 1e-4 f32, cf. lanczos.hpp:67-78).  ``cycles``
    is only a cap.  Restarted GMRES(m) can STAGNATE on nonnormal operators,
    and a silently wrong inner solve poisons every outer Ritz pair, so the
    true residual is checked after GMRES and, when it misses ``tol``, the
    solve falls back to CGLS (normal equations, monotone residual; takes
    ``op.rmatvec``, derived by autograd when ``op`` has no explicit
    adjoint), warm-started from the GMRES iterate.  The operator's
    ``stats`` dict counts its applications, the matvecs of A and A^H inside
    them, the fallbacks, the CGLS iterations they took, and the extra
    forward products of derived adjoints (``adjoint_forwards``).

    Each application is the span ``eigenex.si.apply``, its true-residual
    product and read ``eigenex.si.check``, a fallback ``eigenex.cgls``; the
    counter store adds ``si.applications``, ``si.matvecs``,
    ``si.fallbacks`` and ``si.cgls_iterations`` (the ``stats`` of every such
    operator, summed) and ``si.apply_ms``, the host ms inside the span."""
    op = aslinearoperator(op)
    restart = int(restart)
    cycles = int(cycles)
    if tol is None:
        tol = default_tolerance(op.dtype)
    tol = float(tol)
    stats = _new_stats()
    shifted = _Counted(op, _scalar_for(op, sigma), stats).operator()

    def si_matvec(_, x):
        with profiling.annotate("eigenex.si.apply"):
            t0 = time.perf_counter()
            matvecs = stats["matvecs"]
            stats["applications"] += 1
            y = gmres_solve_jit(shifted, x, restart=restart, cycles=cycles, tol=tol)
            with profiling.annotate("eigenex.si.check"):
                rel = float(torch.linalg.vector_norm(x - shifted.matvec(y))
                            / torch.linalg.vector_norm(x))
            if not (np.isfinite(rel) and rel <= tol):
                stats["fallbacks"] += 1
                y_safe = y if bool(torch.isfinite(y).all()) else torch.zeros_like(y)
                with profiling.annotate("eigenex.cgls"):
                    y, _, it = _cgls_loop(shifted, x, y_safe, tol, max_iters=restart * cycles)
                    it = int(it)
                stats["iterations"] += it
                profiling.count("si.fallbacks")
                profiling.count("si.cgls_iterations", it)
            profiling.count("si.applications")
            profiling.count("si.matvecs", stats["matvecs"] - matvecs)
            profiling.count("si.apply_ms", (time.perf_counter() - t0) * 1e3)
        return y

    si = LinearOperator(si_matvec, None, op.shape, op.dtype, op.device)
    si.stats = stats
    return si
