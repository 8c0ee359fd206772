"""Restarted Arnoldi: the restart loop of thick-restart Lanczos and
Krylov-Schur, and thick-restart Lanczos (TRLM) for Hermitian operators.

Counterpart of ``eigenex_tpu/solvers/restart.py``.  The reference can
only grow its Krylov basis until memory/iteration limits
(lanczos.hpp:744-768).  Thick restart (Wu & Simon 2000) bounds memory at
``max_subspace`` while retaining the convergence of a long run: when the
subspace fills, the best ``num_kept`` Ritz vectors are compressed into
the leading basis slots (one matmul), the residual vector is appended,
and iteration continues with the arrowhead-projected matrix.  Hermiticity
is recovered on the host by symmetrising the tiny projected matrix before
its ``eigh`` in float64; convergence uses the Lanczos residual bound
|beta_m y_{m,i}| <= tol * scale rather than the reference's
successive-value test.

:class:`_RestartedArnoldi` is the loop of both restarted solvers; each
brings its projected problem and its extraction (Krylov-Schur:
:mod:`eigenex_tpu_torch.solvers.krylov_schur`).  The engine is the
*Arnoldi* chunk (:func:`eigenex_tpu_torch.solvers.arnoldi.arnoldi_steps`),
whose per-step CGS2 over the live basis rows computes exactly the
projected-matrix column needed after a restart.  One chunk fills the
subspace, so the host and the device synchronise once per restart.  A
solve keeps one state and :func:`_restart_into` writes each restart into
it in place, so that on the card every restart's chunk (the same
``(k_start, num_steps)`` each time) replays one CUDA graph
(:mod:`eigenex_tpu_torch.solvers.chunk_graph`).  Each pass of the loop runs
under spans (:mod:`eigenex_tpu_torch.utils.profiling`): ``eigenex.wait``
where the host waits for the device, ``eigenex.ritz`` for the projected
eigenproblem and the convergence test, ``eigenex.restart`` for the
restart itself (counted in ``solver.restarts``), ``eigenex.extract`` for
the Ritz vectors at the end.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core.operators import aslinearoperator
from ..utils.exceptions import LanczosError
from ..utils import profiling
from ..utils.precision import highest_f32_matmul
from ..utils.profiling import annotate
from ..utils.tolerance import default_breakdown_threshold, default_tolerance
from ..utils.trace import ConvergenceTrace, Severity
from . import chunk_graph
from .arnoldi import ArnoldiState, arnoldi_steps, init_arnoldi_state
from .lanczos import LanczosOptions, LanczosResult, _ritz_vectors

__all__ = ["ThickRestartLanczosEigenSolver", "ThickRestartOptions"]


@dataclasses.dataclass(frozen=True)
class ThickRestartOptions(LanczosOptions):
    """LanczosOptions plus restart knobs.

    num_kept: Ritz vectors retained at each restart (None -> a standard
        heuristic, min(max(2*nev, nev+8), m-2)).
    max_restarts: restart cycles before giving up.
    """

    num_kept: int | None = None
    max_restarts: int = 100


@torch.no_grad()
def _restart_into(state: ArnoldiState, Yk, block, row) -> ArnoldiState:
    """A restart written into ``state``'s own tensors, so that the solve's
    chunk graphs keep their addresses: ``V[:p] = Yk^T V[:m]`` for the (m, p)
    coefficients ``Yk``, ``V[p] = V[m]`` (the residual row), ``block`` and
    the coupling ``row`` under it as the projected matrix, ``k = p``, the
    flags cleared.  The rows above p stay as they are: step ``kh`` reads
    ``V[:kh + 1]`` alone, so none is read before it is written.  A basis in
    per-shard panels (the mesh solvers, whose chunks return new tensors and
    run eagerly) is written panel by panel, and the state bound anew."""
    m = state.H.shape[1]
    p = Yk.shape[1]
    H = np.zeros((m + 1, m), np.result_type(block, row))
    H[:p, :p] = block
    H[p, :p] = row
    H = torch.as_tensor(H).to(device=state.V.device, dtype=state.H.dtype)

    def write(V):
        Y = torch.as_tensor(np.asarray(Yk)).to(device=V.device, dtype=V.dtype)
        kept = Y.T @ V[:Y.shape[0]]  # every row read before one is written
        V[:p].copy_(kept)
        V[p].copy_(V[Y.shape[0]])
        return V

    if not isinstance(state.V, torch.Tensor):
        dev = H.device
        return ArnoldiState(
            V=state.V.map(write),
            H=H,
            k=torch.full((), p, dtype=torch.int64, device=dev),
            breakdown=torch.zeros((), dtype=torch.bool, device=dev),
            residue=state.residue,
            failed=torch.zeros((), dtype=torch.bool, device=dev),
        )
    write(state.V)
    state.H.copy_(H)
    state.k.fill_(p)
    state.breakdown.zero_()
    state.failed.zero_()
    return state


def _projected(H: torch.Tensor, k: int) -> np.ndarray:
    """Leading k x k block of the projected matrix on the host, in
    float64/complex128, with its Hermiticity restored."""
    Hk = H[:k, :k].to(torch.complex128 if H.is_complex() else torch.float64).cpu().numpy()
    return (Hk + Hk.conj().T) / 2


class _RestartedArnoldi:
    """The restart loop: a chunk fills the subspace, the host solves the
    projected problem, and its kept part starts the next chunk.  A solver
    brings ``_project`` (the tracked values, their Ritz estimates, the stop
    test, and the restart's coefficients, block and coupling row),
    ``_extract``, and the types of its options, result and errors."""

    _options_type = ThickRestartOptions
    _result_type = LanczosResult
    _error = LanczosError
    _step = "Lanczos"  # the step a failure on the first one names

    def __init__(self, operator=None, options=None):
        self.operator = aslinearoperator(operator) if operator is not None else None
        self.options = options or self._options_type()
        self.trace = ConvergenceTrace()
        self._initial_vector = None
        self._result = None

    def set_initial_vector(self, v0):
        self._initial_vector = v0
        return self

    @highest_f32_matmul()
    @chunk_graph.solve_graphs()
    def compute(self, operator=None):
        if operator is not None:
            self.operator = aslinearoperator(operator)
        op = self.operator
        if op is None:
            raise self._error("no operator set")
        if op.shape[0] != op.shape[1]:
            raise self._error(f"requires a square operator, got {op.shape}")
        o = self.options
        n = op.shape[1]
        nev = o.max_eigenvalues
        m = min(o.max_subspace, n)
        if m < nev + 2:
            raise self._error(f"max_subspace={m} too small for {nev} eigenpairs")
        p = o.num_kept if o.num_kept is not None else min(max(2 * nev, nev + 8), m - 2)
        p = min(p, m - 2)
        tol = o.tolerance if o.tolerance is not None else default_tolerance(op.dtype)
        bd = (
            o.breakdown_threshold
            if o.breakdown_threshold is not None
            else default_breakdown_threshold(op.dtype)
        )
        self.trace = ConvergenceTrace()
        t0 = time.perf_counter()

        state = init_arnoldi_state(op, m, self._initial_vector, seed=o.seed, breakdown_threshold=bd)
        k = 0
        total = 0
        termination = "max_restarts"
        terms = None

        for restart in range(o.max_restarts + 1):
            k0 = k
            state = self._run_arnoldi_chunk(op, state, m - k0, bd)
            # the host/device synchronisation point, once per restart
            with annotate("eigenex.wait"):
                k, has_broken, has_failed = state.host_flags()
            total += k - k0
            self._chunk_ran(k - k0)
            if has_failed:
                termination = "numerical_failure"
                terms = None
                self.trace.log(
                    Severity.ERROR,
                    f"numerical failure at {total} iterations: non-finite "
                    "projected matrix (operator overflow or NaN)",
                )
                if k == 0:
                    raise self._error(f"numerical failure on the first {self._step} step")
                break
            with annotate("eigenex.ritz"):
                with annotate("eigenex.wait"):
                    beta = float(self.state_residue(state))
                values, estimates, done, kept, terms = self._project(state, k, beta, p, tol)
                worst = float(np.max(estimates)) if len(estimates) else np.nan
                self.trace.record(total, values, worst, time.perf_counter() - t0)

            if has_broken:
                termination = "breakdown"
                self.trace.log(Severity.INFO, f"breakdown at {total} iterations")
                break
            if done:
                termination = "converged"
                self.trace.log(
                    Severity.INFO,
                    f"converged after {restart} restarts / {total} iterations "
                    f"(max residual estimate {worst:.3e})",
                )
                break
            if restart == o.max_restarts:
                self.trace.log(Severity.WARN, f"stopped at max_restarts={o.max_restarts}")
                break

            with annotate("eigenex.restart"):
                state = _restart_into(state, *kept)
                k = kept[0].shape[1]
            profiling.count("solver.restarts")
            self._restarted(k)

        with annotate("eigenex.extract"):
            evals, vecs = self._extract(state, k, terms)
        self._result = self._result_type(
            eigenvalues=evals,
            eigenvectors=vecs,
            iterations=total,
            converged=termination in ("breakdown", "converged"),
            termination=termination,
            trace=self.trace,
        )
        return self._result

    def _chunk_ran(self, steps: int) -> None:
        """Told the steps of each chunk, once the host has them."""

    def _restarted(self, kept: int) -> None:
        """Told the kept dimension of each restart, once it is written."""

    def _run_arnoldi_chunk(self, op, state, num_steps, breakdown_threshold):
        """One Arnoldi chunk (the distributed solvers run it over a mesh)."""
        return arnoldi_steps(
            op,
            state,
            num_steps,
            shift=self.options.eigenvalue_shift,
            breakdown_threshold=breakdown_threshold,
        )

    @staticmethod
    def state_residue(state: ArnoldiState) -> float:
        """||w|| after the last orthogonalisation: the beta_m of the
        residual bound and of the coupling row."""
        return float(state.residue)

    @property
    def eigenvalues(self):
        if self._result is None:
            raise self._error("compute() has not been run")
        return self._result.eigenvalues

    @property
    def eigenvectors(self):
        if self._result is None:
            raise self._error("compute() has not been run")
        return self._result.eigenvectors


class ThickRestartLanczosEigenSolver(_RestartedArnoldi):
    """Hermitian eigensolver with bounded memory via thick restarts.

    Drop-in alternative to :class:`LanczosEigenSolver` when
    ``max_subspace`` is far below what plain Lanczos would need (clustered
    spectra, huge n).  Tracks the ``eigenvalue_indices`` of the ascending
    Ritz ordering (negatives from the top), like the plain solver."""

    def _tracked(self, k: int) -> list[int]:
        """The tracked indices that lie in [0, k), negatives from the top."""
        idx = [i if i >= 0 else k + i for i in self.options.tracked_indices()]
        return [i for i in idx if 0 <= i < k]

    def _project(self, state, k, beta_m, p, tol):
        """``eigh`` of the symmetrised projected matrix; each tracked pair's
        Lanczos residual bound |beta_m y_{m-1,i}| against tol times the
        spread of the Ritz values.  A restart keeps the tracked pairs and
        their nearest neighbours, with the arrowhead coupling row <r, A u_i>
        = beta_m y_{m-1,i}."""
        theta, Y = np.linalg.eigh(_projected(state.H, k))
        resid = np.abs(beta_m * Y[k - 1, :])
        idx = self._tracked(k)
        spread = float(theta[-1] - theta[0]) if k > 1 else 1.0
        scale = max(spread, float(np.max(np.abs(theta))) if k else 1.0, 1e-300)
        done = bool(idx) and bool(np.all(resid[idx] <= tol * scale))
        keep = self._select_keep(theta, idx, p, k)
        kept = Y[:, keep], np.diag(theta[keep]), beta_m * Y[k - 1, keep]
        return theta[idx] if idx else np.zeros(0), resid[idx], done, kept, None

    def _extract(self, state, k, terms):
        o = self.options
        theta, Y = np.linalg.eigh(_projected(state.H, k))
        sel = self._tracked(k) or list(range(min(o.max_eigenvalues, k)))
        vecs = _ritz_vectors(state.V, Y[:, sel], k) if o.compute_eigenvectors else None
        return theta[sel] - np.real(o.eigenvalue_shift), vecs

    @staticmethod
    def _select_keep(theta: np.ndarray, tracked_idx: list[int], p: int, k: int) -> list[int]:
        """Tracked Ritz indices first, then nearest neighbours by position
        (keeps the restart subspace centred on the wanted part of the
        spectrum)."""
        keep = list(dict.fromkeys(tracked_idx))
        lo = min(keep) if keep else 0
        hi = max(keep) if keep else -1
        grow_lo, grow_hi = lo - 1, hi + 1
        while len(keep) < min(p, k - 1):
            if grow_lo >= 0:
                keep.append(grow_lo)
                grow_lo -= 1
            elif grow_hi < k:
                keep.append(grow_hi)
                grow_hi += 1
            else:
                break
            if len(keep) < min(p, k - 1) and grow_hi < k:
                keep.append(grow_hi)
                grow_hi += 1
        return sorted(set(keep))
