"""Thick-restart Lanczos (TRLM) for Hermitian operators.

Counterpart of ``eigenex_tpu/solvers/restart.py``.  The reference can
only grow its Krylov basis until memory/iteration limits
(lanczos.hpp:744-768).  Thick restart (Wu & Simon 2000) bounds memory at
``max_subspace`` while retaining the convergence of a long run: when the
subspace fills, the best ``num_kept`` Ritz vectors are compressed into
the leading basis slots (one matmul), the residual vector is appended,
and iteration continues with the arrowhead-projected matrix.

The engine is the *Arnoldi* chunk
(:func:`eigenex_tpu_torch.solvers.arnoldi.arnoldi_steps`) -- its
per-step CGS2 over the live basis rows computes exactly the
projected-matrix column needed after a restart; Hermiticity is recovered
on the host by symmetrising the tiny projected matrix before its
``eigh`` in float64.  One chunk fills the subspace, so the host and the
device synchronise once per restart.  A solve keeps one state and writes
each restart into it, so that on the card every restart's chunk (the same
``(k_start, num_steps)`` each time) replays one CUDA graph
(:mod:`eigenex_tpu_torch.solvers.chunk_graph`).  Each pass of the loop runs
under spans (:mod:`eigenex_tpu_torch.utils.profiling`): ``eigenex.wait``
where the host waits for the device, ``eigenex.ritz`` for the projected
eigenproblem and the convergence test, ``eigenex.restart`` for the
restart itself (counted in ``solver.restarts``), ``eigenex.extract`` for
the Ritz vectors at the end.  Convergence uses the Lanczos
residual bound |beta_m y_{m,i}| <= tol * scale rather than the
reference's successive-value test.
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
from .arnoldi import ArnoldiState, _restart_into, arnoldi_steps, init_arnoldi_state
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
def _compress_basis(V: torch.Tensor, Yk, r: torch.Tensor) -> torch.Tensor:
    """V_new[0:p] = Yk^T V[:m];  V_new[p] = r;  rest zero -- one matmul
    (one a panel for a basis in per-shard column panels)."""
    if not isinstance(V, torch.Tensor):
        return V.map(lambda piece, r_piece: _compress_basis(piece, Yk, r_piece), r)
    Yk = torch.as_tensor(np.asarray(Yk)).to(device=V.device, dtype=V.dtype)
    m, p = Yk.shape
    out = torch.zeros_like(V)
    out[:p] = Yk.T @ V[:m]
    out[p] = r
    return out


def _projected(H: torch.Tensor, k: int) -> np.ndarray:
    """Leading k x k block of the projected matrix on the host, in
    float64/complex128, with its Hermiticity restored."""
    Hk = H[:k, :k].to(torch.complex128 if H.is_complex() else torch.float64).cpu().numpy()
    return (Hk + Hk.conj().T) / 2


class ThickRestartLanczosEigenSolver:
    """Hermitian eigensolver with bounded memory via thick restarts.

    Drop-in alternative to :class:`LanczosEigenSolver` when
    ``max_subspace`` is far below what plain Lanczos would need (clustered
    spectra, huge n).  Tracks the ``eigenvalue_indices`` of the ascending
    Ritz ordering (negatives from the top), like the plain solver."""

    def __init__(self, operator=None, options: ThickRestartOptions | None = None):
        self.operator = aslinearoperator(operator) if operator is not None else None
        self.options = options or ThickRestartOptions()
        self.trace = ConvergenceTrace()
        self._initial_vector = None
        self._result: LanczosResult | None = None

    def set_initial_vector(self, v0):
        self._initial_vector = v0
        return self

    @highest_f32_matmul()
    @chunk_graph.solve_graphs()
    def compute(self, operator=None) -> LanczosResult:
        if operator is not None:
            self.operator = aslinearoperator(operator)
        op = self.operator
        if op is None:
            raise LanczosError("no operator set")
        if op.shape[0] != op.shape[1]:
            raise LanczosError(f"requires a square operator, got {op.shape}")
        o = self.options
        n = op.shape[1]
        nev = o.max_eigenvalues
        m = min(o.max_subspace, n)
        if m < nev + 2:
            raise LanczosError(f"max_subspace={m} too small for {nev} eigenpairs")
        p = o.num_kept if o.num_kept is not None else min(max(2 * nev, nev + 8), m - 2)
        p = min(p, m - 2)
        tol = o.tolerance if o.tolerance is not None else default_tolerance(op.dtype)
        bd = (
            o.breakdown_threshold
            if o.breakdown_threshold is not None
            else default_breakdown_threshold(op.dtype)
        )
        tracked = o.tracked_indices()
        self.trace = ConvergenceTrace()
        t0 = time.perf_counter()

        state = init_arnoldi_state(op, m, self._initial_vector, seed=o.seed, breakdown_threshold=bd)
        k = 0
        total_iters = 0
        termination = "max_restarts"
        converged = False

        for restart in range(o.max_restarts + 1):
            k0 = k
            state = self._run_arnoldi_chunk(op, state, m - k0, bd)
            # the host/device synchronisation point, once per restart
            with annotate("eigenex.wait"):
                k, has_broken, has_failed = state.host_flags()
            total_iters += k - k0
            if has_failed:
                termination = "numerical_failure"
                converged = False
                self.trace.log(
                    Severity.ERROR,
                    f"numerical failure at {total_iters} total iterations: "
                    "non-finite projection (operator overflow or NaN)",
                )
                if k == 0:
                    raise LanczosError("numerical failure on the first Lanczos step")
                break
            with annotate("eigenex.ritz"):
                Hk = _projected(state.H, k)
                theta, Y = np.linalg.eigh(Hk)
                with annotate("eigenex.wait"):
                    beta_m = float(self.state_residue(state))
                # Lanczos residual bound per Ritz pair: |beta_m y_{m-1,i}|
                resid = np.abs(beta_m * Y[k - 1, :])
                idx = [i if i >= 0 else k + i for i in tracked]
                idx = [i for i in idx if 0 <= i < k]
                spread = float(theta[-1] - theta[0]) if k > 1 else 1.0
                scale = max(spread, float(np.max(np.abs(theta))) if k else 1.0, 1e-300)
                cur = theta[idx] if idx else np.zeros(0)
                self.trace.record(total_iters, cur,
                                  float(np.max(resid[idx]) if idx else np.nan),
                                  time.perf_counter() - t0)

            if has_broken:
                termination = "breakdown"
                converged = True
                self.trace.log(Severity.INFO, f"breakdown at {total_iters} total iterations")
                break
            if idx and np.all(resid[idx] <= tol * scale):
                termination = "converged"
                converged = True
                self.trace.log(
                    Severity.INFO,
                    f"converged after {restart} restarts / {total_iters} iterations "
                    f"(max residual bound {float(np.max(resid[idx])):.3e})",
                )
                break
            if restart == o.max_restarts:
                self.trace.log(Severity.WARN, f"stopped at max_restarts={o.max_restarts}")
                break

            # ---- thick restart: keep the tracked pairs + nearest extras ----
            with annotate("eigenex.restart"):
                keep = self._select_keep(theta, idx, p, k)
                r = state.V[k].clone()  # unit residual direction
                V_new = _compress_basis(state.V, Y[:, keep], r)
                pk = len(keep)
                H_new = np.zeros((m + 1, m), Hk.dtype)
                H_new[:pk, :pk] = np.diag(theta[keep])
                # arrowhead coupling row: <r, A u_i> = beta_m y_{m-1,i}
                H_new[pk, :pk] = beta_m * Y[k - 1, keep]
                dev = state.V.device
                state = _restart_into(
                    state, V_new, torch.as_tensor(H_new).to(device=dev, dtype=state.H.dtype), pk)
                k = pk
            profiling.count("solver.restarts")

        # ---- extraction ----
        with annotate("eigenex.extract"):
            theta, Y = np.linalg.eigh(_projected(state.H, k))
            sel = [i if i >= 0 else k + i for i in tracked]
            sel = [i for i in sel if 0 <= i < k] or list(range(min(nev, k)))
            evals = theta[sel] - np.real(o.eigenvalue_shift)
            vecs = None
            if o.compute_eigenvectors:
                vecs = _ritz_vectors(state.V, Y[:, sel], k)
        self._result = LanczosResult(
            eigenvalues=evals,
            eigenvectors=vecs,
            iterations=total_iters,
            converged=converged,
            termination=termination,
            trace=self.trace,
        )
        return self._result

    def _run_arnoldi_chunk(self, op, state, num_steps, breakdown_threshold):
        """One Arnoldi chunk."""
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
        residual bound and of the arrowhead coupling row."""
        return float(state.residue)

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

    @property
    def eigenvalues(self):
        if self._result is None:
            raise LanczosError("compute() has not been run")
        return self._result.eigenvalues

    @property
    def eigenvectors(self):
        if self._result is None:
            raise LanczosError("compute() has not been run")
        return self._result.eigenvectors
