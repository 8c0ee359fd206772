"""Krylov-Schur restarted Arnoldi for general (non-Hermitian) operators.

Counterpart of ``eigenex_tpu/solvers/krylov_schur.py``: the
non-Hermitian counterpart of thick-restart Lanczos
(:mod:`eigenex_tpu_torch.solvers.restart`).  When the Arnoldi subspace
fills, the projected Hessenberg is reduced to (complex) Schur form, the
wanted part of the ordered Schur basis is compressed into the leading
basis slots (one matmul on the device), and iteration continues --
bounded memory, restart-accelerated convergence for clustered dominant
spectra (Stewart 2001).

One chunk fills the subspace, so the host and the device synchronise
once per restart; the restarts are written into the one state of the
solve, whose chunks replay CUDA graphs on the card
(:mod:`eigenex_tpu_torch.solvers.chunk_graph`).  All small-matrix work
(Schur, ordering, residual bounds, the real-basis span reduction) is host
LAPACK on float64 /
complex128 copies of the Hessenberg, as in the reference; the device
does the Arnoldi chunk and the (p, m) x (m, n) basis compression.  The
loop's spans and its ``solver.restarts`` count are those of
:mod:`eigenex_tpu_torch.solvers.restart`.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core.operators import aslinearoperator
from ..utils.exceptions import ArnoldiError
from ..utils import profiling
from ..utils.precision import highest_f32_matmul
from ..utils.profiling import annotate
from ..utils.tolerance import default_breakdown_threshold, default_tolerance
from ..utils.trace import ConvergenceTrace, Severity
from . import chunk_graph
from .arnoldi import (ArnoldiResult, ArnoldiState, _lift_ritz, _restart_into, arnoldi_steps,
                      init_arnoldi_state)
from .lanczos import LanczosOptions
from .restart import _compress_basis

__all__ = ["KrylovSchurArnoldiSolver", "KrylovSchurOptions"]


@dataclasses.dataclass(frozen=True)
class KrylovSchurOptions(LanczosOptions):
    """Arnoldi options plus restart knobs; ``eigenvalue_indices`` refer to
    the ``which``-ordered spectrum (|lambda|-descending dominant pairs by
    default).  ``which`` follows the scipy ``eigs`` convention:
    "LM"/"SM" (largest/smallest magnitude), "LR"/"SR" (largest/smallest
    real part), "LI"/"SI" (largest/smallest imaginary part) -- the restart
    compression keeps, and convergence tracks, that end of the spectrum."""

    num_kept: int | None = None
    max_restarts: int = 100
    which: str = "LM"


def _which_key(evals: np.ndarray, which: str) -> np.ndarray:
    """Sort key (ascending = most wanted first) for scipy-style ``which``."""
    if which == "LM":
        return -np.abs(evals)
    if which == "SM":
        return np.abs(evals)
    if which == "LR":
        return -np.real(evals)
    if which == "SR":
        return np.real(evals)
    if which == "LI":
        return -np.imag(evals)
    if which == "SI":
        return np.imag(evals)
    raise ArnoldiError(
        f"which must be one of 'LM','SM','LR','SR','LI','SI', got {which!r}"
    )


def _ordered_schur(H: np.ndarray, n_wanted: int, which: str = "LM"):
    """Complex Schur form of H with (at least) the ``n_wanted``
    most-wanted values (per ``which``) ordered into the leading block.
    Returns (T, Q, evals_sorted_wanted_first)."""
    from scipy.linalg import schur

    evals = np.linalg.eigvals(H.astype(np.complex128))
    keys = _which_key(evals, which)
    order = np.argsort(keys, kind="stable")
    wanted_first = evals[order]
    scale = float(np.max(np.abs(evals))) if len(evals) else 1.0
    cutoff = keys[order[min(n_wanted, len(evals)) - 1]] if len(evals) else 0.0
    eps = 1e-12 * max(scale, 1.0)
    T, Q, sdim = schur(
        H.astype(np.complex128),
        output="complex",
        sort=lambda x: bool(_which_key(np.asarray([x]), which)[0] <= cutoff + eps),
    )
    return T, Q, wanted_first


def _restart_coefficients(Q: np.ndarray, pk: int, m: int, complex_basis: bool) -> np.ndarray:
    """The orthonormal (k, p') coefficient matrix a restart compresses the
    basis with.  A complex basis keeps the leading ``pk`` Schur vectors.  A
    real basis keeps the real span of {Re q_i, Im q_i}, whose rank can reach
    2 pk: truncating it would break the Arnoldi decomposition, so the number
    of kept Schur vectors is reduced until the whole span fits ``m - 2``."""
    if complex_basis:
        return Q[:, :pk]
    for pk_try in range(pk, 0, -1):
        Qk = Q[:, :pk_try]
        if np.allclose(Qk.imag, 0, atol=1e-14):
            cand = np.ascontiguousarray(Qk.real)
        else:
            span = np.concatenate([Qk.real, Qk.imag], axis=1)
            u, s, _ = np.linalg.svd(span, full_matrices=False)
            rank = int(np.sum(s > (s[0] if s.size else 1) * 1e-10))
            cand = u[:, :rank]
        if cand.shape[1] <= m - 2:
            return cand
    return np.zeros((Q.shape[0], 0))  # pathological; restart from the residual alone


class KrylovSchurArnoldiSolver:
    """Dominant-eigenpair solver with bounded memory via Krylov-Schur
    restarts; drop-in alternative to :class:`ArnoldiEigenSolver` when the
    spectrum is clustered or the basis must stay small."""

    def __init__(self, operator=None, options: KrylovSchurOptions | None = None):
        self.operator = aslinearoperator(operator) if operator is not None else None
        self.options = options or KrylovSchurOptions()
        self.trace = ConvergenceTrace()
        self._initial_vector = None
        self._result: ArnoldiResult | None = None

    def set_initial_vector(self, v0):
        self._initial_vector = v0
        return self

    @highest_f32_matmul()
    @chunk_graph.solve_graphs()
    def compute(self, operator=None) -> ArnoldiResult:
        if operator is not None:
            self.operator = aslinearoperator(operator)
        op = self.operator
        if op is None:
            raise ArnoldiError("no operator set")
        if op.shape[0] != op.shape[1]:
            raise ArnoldiError(f"requires a square operator, got {op.shape}")
        o = self.options
        n = op.shape[1]
        nev = o.max_eigenvalues
        m = min(o.max_subspace, n)
        if m < nev + 2:
            raise ArnoldiError(f"max_subspace={m} too small for {nev} eigenpairs")
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
        complex_basis = state.V.is_complex()
        k = 0
        total = 0
        termination = "max_restarts"
        converged = False

        for restart in range(o.max_restarts + 1):
            k0 = k
            state = self._run_arnoldi_chunk(op, state, m - k0, bd)
            # the host/device synchronisation point, once per restart
            with annotate("eigenex.wait"):
                k, has_broken, has_failed = state.host_flags()
            total += k - k0
            if has_failed:
                termination = "numerical_failure"
                converged = False
                self.trace.log(
                    Severity.ERROR,
                    f"numerical failure at {total} iterations: non-finite "
                    "Hessenberg (operator overflow or NaN)",
                )
                if k == 0:
                    raise ArnoldiError("numerical failure on the first Arnoldi step")
                break
            with annotate("eigenex.ritz"):
                H = state.H[:k, :k].to(torch.complex128).cpu().numpy()
                with annotate("eigenex.wait"):
                    beta = float(self.state_residue(state))
                T, Q, evals_desc = _ordered_schur(H, min(p, k - 1), o.which)
                # residual bound per Schur vector: |beta Q[k-1, i]|
                resid = np.abs(beta * Q[k - 1, :])
                nev_eff = min(nev, k)
                cur = np.diag(T)[:nev_eff]
                scale = max(float(np.max(np.abs(evals_desc))) if len(evals_desc) else 1.0, 1e-300)
                self.trace.record(
                    total, cur, float(np.max(resid[:nev_eff])) if nev_eff else np.nan,
                    time.perf_counter() - t0,
                )

            if has_broken:
                termination = "breakdown"
                converged = True
                self.trace.log(Severity.INFO, f"breakdown at {total} iterations")
                break
            if nev_eff == nev and np.all(resid[:nev] <= tol * scale):
                termination = "converged"
                converged = True
                self.trace.log(
                    Severity.INFO,
                    f"converged after {restart} restarts / {total} iterations "
                    f"(max residual {float(np.max(resid[:nev])):.3e})",
                )
                break
            if restart == o.max_restarts:
                self.trace.log(Severity.WARN, f"stopped at max_restarts={o.max_restarts}")
                break

            # ---- Krylov-Schur restart (coefficient-space formulation) ----
            # Any orthonormal coefficient matrix qs (k, p') compresses the
            # decomposition exactly: A (qs^T V) rows project to
            # qs^H H[:k,:k] qs with coupling row <r, A w_i> = beta qs[k-1, i]
            # -- no extra matvecs, real and complex alike.
            with annotate("eigenex.restart"):
                qs = _restart_coefficients(Q, min(p, k - 1), m, complex_basis)
                pk2 = qs.shape[1]
                H_new = np.zeros((m + 1, m), np.complex128 if complex_basis else np.float64)
                Hp = qs.conj().T @ H @ qs
                H_new[:pk2, :pk2] = Hp if complex_basis else Hp.real
                coup = beta * qs[k - 1, :]
                H_new[pk2, :pk2] = coup if complex_basis else coup.real
                dev = state.V.device
                state = _restart_into(
                    state, _compress_basis(state.V, qs, state.V[k].clone()),
                    torch.as_tensor(H_new).to(device=dev, dtype=state.H.dtype), pk2)
                k = pk2
            profiling.count("solver.restarts")

        # ---- extraction ----
        with annotate("eigenex.extract"):
            H = state.H[:k, :k].to(torch.complex128).cpu().numpy()
            evals, Y = np.linalg.eig(H)
            order = np.argsort(_which_key(evals, o.which), kind="stable")
            sel = order[: min(o.max_eigenvalues, k)]
            evals_out = evals[sel] - complex(o.eigenvalue_shift)
            vecs = None
            if o.compute_eigenvectors:
                vecs = _lift_ritz(state.V, Y[:, sel], k)
        self._result = ArnoldiResult(
            eigenvalues=evals_out,
            eigenvectors=vecs,
            iterations=total,
            converged=converged,
            termination=termination,
            trace=self.trace,
        )
        return self._result

    def _run_arnoldi_chunk(self, op, state, num_steps, breakdown_threshold):
        """One Arnoldi chunk (the distributed solver runs it over a mesh)."""
        return arnoldi_steps(
            op, state, num_steps, shift=self.options.eigenvalue_shift,
            breakdown_threshold=breakdown_threshold,
        )

    @staticmethod
    def state_residue(state: ArnoldiState) -> float:
        """||w|| after the last orthogonalisation: the beta of the residual
        bound and of the coupling row."""
        return float(state.residue)

    @property
    def eigenvalues(self):
        if self._result is None:
            raise ArnoldiError("compute() has not been run")
        return self._result.eigenvalues

    @property
    def eigenvectors(self):
        if self._result is None:
            raise ArnoldiError("compute() has not been run")
        return self._result.eigenvectors
