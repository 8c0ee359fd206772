"""Arnoldi eigensolver for general (non-Hermitian) matrix-free operators.

Counterpart of ``eigenex_tpu/solvers/arnoldi.py`` (the reference's
Arnoldi stack, arnoldi.hpp: ``ArnoldiBase`` :54 with its
Hessenberg-building full Gram-Schmidt loop :312-396, and
``ArnoldiEigenSolver`` :445 with dominant-|lambda| sorting :813-819,
eigenvector lift V y :841-851 and phase fixing :853-865).  Thick-restart
Lanczos (:mod:`eigenex_tpu_torch.solvers.restart`), Krylov-Schur
(:mod:`eigenex_tpu_torch.solvers.krylov_schur`) and GMRES
(:mod:`eigenex_tpu_torch.solvers.gmres`) are built on the same chunk: the
per-step CGS2 over the live basis rows computes exactly the Hessenberg
column.

Same execution model as :mod:`eigenex_tpu_torch.solvers.lanczos`:
preallocated ``(m+1, n)`` basis and ``(m+1, m)`` Hessenberg updated in
place, device flags for breakdown and failure, one host synchronisation
per chunk.  The dense Hessenberg eigenproblem runs on the host in
float64/complex128 once per chunk.  A complex operator takes a complex
basis; a real operator a real one, whose complex Ritz vectors are lifted
on the device in the complex dtype of the basis.

The loop is :func:`_arnoldi_chunk_body`; :func:`_arnoldi_chunk`, which
every caller runs, replays it as a CUDA graph inside a solve's graph set
(:mod:`eigenex_tpu_torch.solvers.chunk_graph`, the counterpart of the
reference's ``jax.jit`` of the chunk).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core.operators import LinearOperator, aslinearoperator
from ..ops import arnoldi_step
from ..ops.orthogonalize import cgs2, norm_psum, project_out
from ..utils import profiling
from ..utils.exceptions import ArnoldiError
from ..utils.precision import highest_f32_matmul
from ..utils.profiling import annotate
from ..utils.tolerance import default_breakdown_threshold, default_tolerance, real_dtype_of
from ..utils.trace import ConvergenceTrace, Severity
from . import chunk_graph
from .lanczos import UNLIMITED, LanczosOptions, _formal_indices, _host_flags, _phase_fix, _start_vector

__all__ = [
    "ArnoldiOptions",
    "ArnoldiState",
    "ArnoldiResult",
    "ArnoldiEigenSolver",
    "arnoldi_steps",
    "init_arnoldi_state",
]


# Arnoldi reuses the Lanczos option surface (the reference shares the
# fluent config between solvers, arnoldi.hpp:6,208-218); only the
# tracked-index semantics differ: indices refer to the |lambda|-descending
# order (arnoldi.hpp:813-819).
ArnoldiOptions = LanczosOptions


@dataclasses.dataclass
class ArnoldiState:
    """Carried Arnoldi state (basis + Hessenberg; cf. arnoldi.hpp:190-206).
    The chunk updates ``V`` and ``H`` in place."""

    V: torch.Tensor  # (m+1, n) orthonormal basis rows
    H: torch.Tensor  # (m+1, m) Hessenberg
    k: torch.Tensor  # () int64 completed steps
    breakdown: torch.Tensor  # () bool
    residue: torch.Tensor  # () real -- ||w|| after last orthogonalisation (arnoldi.hpp:348)
    failed: torch.Tensor  # () bool -- NaN/Inf detected (numerical failure)

    def host_flags(self) -> tuple[int, bool, bool]:
        """``(k, breakdown, failed)`` on the host, in one transfer."""
        return _host_flags(self.k, self.breakdown, self.failed)


@dataclasses.dataclass
class ArnoldiResult:
    """Eigenpairs + diagnostics of a general solve."""

    eigenvalues: np.ndarray  # (p,) complex
    eigenvectors: torch.Tensor | np.ndarray | None  # (n, p) complex columns
    iterations: int
    converged: bool
    termination: str
    trace: ConvergenceTrace
    #: the ``stats`` of the shift-invert operator on the ``sigma=`` routes
    #: of :func:`~eigenex_tpu_torch.solvers.api.eigs` (applications, matvecs
    #: of A inside them, CGLS fallbacks and their iterations), else None
    inner_stats: dict | None = None

    def residual_norms(self, op) -> np.ndarray:
        """||A x - lambda x|| per pair -- the ||A P - P D|| ~ 0 acceptance
        identity (sample_arnoldi.cpp:42-52).  Complex Ritz vectors of a
        real operator go through it as their real and imaginary parts."""
        if self.eigenvectors is None:
            raise ArnoldiError("eigenvectors were not computed")
        op = aslinearoperator(op)
        X = torch.as_tensor(self.eigenvectors).to(op.device)
        lam = torch.as_tensor(np.asarray(self.eigenvalues)).to(op.device)
        if X.is_complex() and not op.dtype.is_complex:
            ax = torch.complex(op.matmat(X.real.to(op.dtype).contiguous()),
                               op.matmat(X.imag.to(op.dtype).contiguous()))
            X = X.to(ax.dtype)
        else:
            ax = op.matmat(X.to(op.dtype))
            if not X.is_complex():
                lam = lam.real
        r = ax - X * lam.to(ax.dtype)[None, :]
        return torch.linalg.vector_norm(r, dim=0).cpu().numpy()


def init_arnoldi_state(
    op: LinearOperator,
    max_subspace: int,
    v0=None,
    *,
    seed: int = 0,
    deflate=None,
    breakdown_threshold: float | None = None,
) -> ArnoldiState:
    """cf. setInitialArnoldivector arnoldi.hpp:246-275."""
    n = op.shape[1]
    m = int(max_subspace)
    dev = op.device
    rdt = real_dtype_of(op.dtype)
    v0, nrm = _start_vector(op, v0, seed, deflate, breakdown_threshold, ArnoldiError)
    V = torch.zeros((m + 1, n), dtype=op.dtype, device=dev)
    V[0] = v0
    return ArnoldiState(
        V=V,
        H=torch.zeros((m + 1, m), dtype=op.dtype, device=dev),
        k=torch.zeros((), dtype=torch.int64, device=dev),
        breakdown=torch.zeros((), dtype=torch.bool, device=dev),
        residue=torch.as_tensor(nrm, dtype=rdt, device=dev),
        failed=torch.zeros((), dtype=torch.bool, device=dev),
    )


@torch.no_grad()
def _arnoldi_chunk_body(
    op: LinearOperator,
    state: ArnoldiState,
    shift,
    breakdown_threshold: float,
    deflate,
    *,
    k_start: int,
    num_steps: int,
    comm=None,
) -> ArnoldiState:
    """The hot loop of updateArnoldiSteps (arnoldi.hpp:312-396): matvec +
    shift (:369-372), deflation (:373-375), full GS Hessenberg column
    (:377-384) via CGS2 over the live rows, residue (:348,385).

    ``k_start`` and the bound on ``num_steps`` come from the caller, as
    in the Lanczos chunk: step ``j`` works on row ``k_start + j`` for as
    long as neither device flag is set, and is a no-op afterwards.  Step
    ``kh`` projects against ``V[:kh + 1]`` alone, so the rows above it
    (zeros, or stale rows after a restart) are never read.
    ``comm``: as for the Lanczos chunk (the JAX body's ``axis_name``)."""
    V, H = state.V, state.H
    k, breakdown, failed, residue_prev = state.k, state.breakdown, state.failed, state.residue
    rdt = residue_prev.dtype
    has_shift = not (isinstance(shift, (int, float, complex)) and shift == 0)
    # the step's tail (flags, guards, the column of H and the next row of V)
    # in one launch on the card where the basis is real, on one device
    tail = arnoldi_step.step_tail if comm is None else arnoldi_step.step_tail_plain

    for kh in range(int(k_start), int(k_start) + int(num_steps)):
        vk = V[kh]
        w = op.matvec(vk)
        if has_shift:
            w = w + shift * vk
        if deflate is not None:
            w = project_out(deflate, w, comm=comm)
        w, c = cgs2(V[:kh + 1], w, comm=comm)
        if deflate is not None:
            # re-deflate after the O(1)-coefficient projection: it
            # reintroduces a deflate component proportional to the basis'
            # accumulated deflate drift, which otherwise grows
            # geometrically (cf. arnoldi.hpp:373-375)
            w = project_out(deflate, w, comm=comm)
        residue = norm_psum(w, comm).to(rdt)
        k, breakdown, residue_prev, failed = tail(
            V, H, c, w, residue, breakdown_threshold, kh, k, breakdown, residue_prev, failed)

    return ArnoldiState(V=V, H=H, k=k, breakdown=breakdown, residue=residue_prev, failed=failed)


def _arnoldi_chunk(
    op: LinearOperator,
    state: ArnoldiState,
    shift,
    breakdown_threshold: float,
    deflate,
    *,
    k_start: int,
    num_steps: int,
    comm=None,
) -> ArnoldiState:
    """The chunk every caller runs (the reference's jitted
    ``_arnoldi_chunk``, arnoldi.py:236-238).  Inside a solve's graph set
    (:mod:`~eigenex_tpu_torch.solvers.chunk_graph`) it runs on the set's
    terms: ``state``'s tensors are updated in place and ``state`` returned,
    through a CUDA graph of :func:`_arnoldi_chunk_body` where the operator is
    capturable on the card.  Outside a set, and on a mesh (``comm``), it is
    the body.

    The chunk's CGS2 work is counted here, which replays pass through too:
    ``cgs2.rows`` adds the rows one pass reads at each step (``kh + 1`` at
    step ``kh``), ``cgs2.steps`` the steps; on a mesh each shard counts its
    own chunk.  ``arnoldi.fused_steps`` counts the steps whose tail is one
    launch of the kernel of :mod:`~eigenex_tpu_torch.ops.arnoldi_step`."""
    k_start, num_steps = int(k_start), int(num_steps)
    profiling.count("cgs2.rows", num_steps * (2 * k_start + num_steps + 1) // 2)
    profiling.count("cgs2.steps", num_steps)
    if comm is None and arnoldi_step.fused(state.V):
        profiling.count("arnoldi.fused_steps", num_steps)

    def body():
        return _arnoldi_chunk_body(op, state, shift, breakdown_threshold, deflate,
                                   k_start=k_start, num_steps=num_steps, comm=comm)

    graphs = chunk_graph.current()
    if graphs is None or comm is not None:
        with annotate("eigenex.chunk.eager"):
            return body()
    key = (k_start, num_steps, shift, float(breakdown_threshold), deflate)
    return graphs.run(op, state, key, body)


def arnoldi_steps(
    op: LinearOperator,
    state: ArnoldiState,
    num_steps: int,
    *,
    shift=0.0,
    breakdown_threshold: float | None = None,
    deflate=None,
) -> ArnoldiState:
    """Public fixed-step basis/Hessenberg routine (the ``ArnoldiBase``
    role, arnoldi.hpp:54-443).  Updates the tensors of ``state`` in place
    and returns a state that shares them; reads ``k`` once, before the
    chunk, and runs no step past the preallocated subspace."""
    if breakdown_threshold is None:
        breakdown_threshold = default_breakdown_threshold(op.dtype)
    m = state.H.shape[1]
    k_start = int(state.k)
    num_steps = max(min(int(num_steps), m - k_start), 0)
    if deflate is not None:
        deflate = torch.as_tensor(deflate).to(device=op.device, dtype=op.dtype)
    return _arnoldi_chunk(
        op,
        state,
        shift,
        float(breakdown_threshold),
        deflate,
        k_start=k_start,
        num_steps=num_steps,
    )


# ---------------------------------------------------------------------------
# Host-side Hessenberg eigenproblem and the solver
# ---------------------------------------------------------------------------
def _hessenberg(H: torch.Tensor, k: int) -> np.ndarray:
    """Leading k x k block of the Hessenberg on the host, float64 or
    complex128."""
    return H[:k, :k].to(torch.complex128 if H.is_complex() else torch.float64).cpu().numpy()


def _sorted_desc_indices(evals: np.ndarray) -> np.ndarray:
    """Stable sort by |lambda| descending (cf. compute_sorted_indices
    arnoldi.hpp:893-913)."""
    return np.argsort(-np.abs(evals), kind="stable")


@torch.no_grad()
def _lift_ritz(V: torch.Tensor, Y, k: int) -> torch.Tensor:
    """x_j = sum_m Y[m, j] V[m] (arnoldi.hpp:841-851), then normalise and
    phase-fix (:853-865): one matmul on the basis' device, in the complex
    dtype of the basis."""
    cdt = V.dtype if V.is_complex() else (
        torch.complex128 if V.dtype == torch.float64 else torch.complex64)
    Yt = torch.as_tensor(np.asarray(Y)).to(device=V.device, dtype=cdt)
    if isinstance(V, torch.Tensor):
        X = V[:k].T.to(cdt) @ Yt
    else:  # a basis in per-shard column panels: each panel's rows, joined
        X = V.combine(lambda piece: piece[:k].T.to(cdt) @ Yt.to(piece.device), dim=0)
    X = X / torch.linalg.vector_norm(X, dim=0, keepdim=True)
    return _phase_fix(X)


class ArnoldiEigenSolver:
    """General eigensolver driver for dominant eigenpairs
    (cf. ArnoldiEigenSolver arnoldi.hpp:445).

    ``eigenvalue_indices`` index into the |lambda|-descending ordering; the
    default tracks the ``max_eigenvalues`` most dominant pairs."""

    def __init__(self, operator=None, options: ArnoldiOptions | None = None):
        self.operator = aslinearoperator(operator) if operator is not None else None
        self.options = options or ArnoldiOptions()
        self.state: ArnoldiState | None = None
        self.trace = ConvergenceTrace()
        self._initial_vector = None
        self._deflate = None
        self._result: ArnoldiResult | None = None

    # fluent configuration, same surface as Lanczos (arnoldi.hpp:545-679)
    def _set(self, **kw):
        self.options = dataclasses.replace(self.options, **kw)
        return self

    def set_tolerance(self, tol):
        return self._set(tolerance=tol)

    def set_min_iterations(self, n):
        return self._set(min_iterations=n)

    def set_max_iterations(self, n):
        return self._set(max_iterations=n)

    def set_max_subspace(self, n):
        return self._set(max_subspace=n)

    def set_max_eigenvalues(self, n):
        return self._set(max_eigenvalues=n)

    def set_eigenvalue_indices(self, idx):
        return self._set(eigenvalue_indices=tuple(idx))

    def set_eigenvalue_shift(self, s):
        return self._set(eigenvalue_shift=s)

    def set_breakdown_threshold(self, t):
        return self._set(breakdown_threshold=t)

    def set_check_every(self, n):
        return self._set(check_every=n)

    def set_seed(self, s):
        return self._set(seed=s)

    def set_initial_vector(self, v0):
        self._initial_vector = v0
        return self

    def set_orthogonalizing_vectors(self, D):
        self._deflate = D
        return self

    def set_all_settings_default(self):
        self.options = ArnoldiOptions()
        return self

    def _resolved(self, op):
        n = op.shape[1]
        o = self.options
        tol = o.tolerance if o.tolerance is not None else default_tolerance(op.dtype)
        bd = (
            o.breakdown_threshold
            if o.breakdown_threshold is not None
            else default_breakdown_threshold(op.dtype)
        )
        max_iters = o.max_iterations if o.max_iterations != UNLIMITED else n
        m = min(o.max_subspace, n, max_iters) if max_iters > 0 else min(o.max_subspace, n)
        return tol, bd, m, max(o.min_iterations, 0)

    @highest_f32_matmul()
    def compute(self, operator=None) -> ArnoldiResult:
        """cf. compute arnoldi.hpp:741-762"""
        if operator is not None:
            self.operator = aslinearoperator(operator)
        if self.operator is None:
            raise ArnoldiError("no operator set")
        op = self.operator
        if op.shape[0] != op.shape[1]:
            raise ArnoldiError(f"Arnoldi requires a square operator, got {op.shape}")
        self.trace = ConvergenceTrace()
        _, bd, m, _ = self._resolved(op)
        self.state = init_arnoldi_state(
            op,
            m,
            self._initial_vector,
            seed=self.options.seed,
            deflate=self._deflate,
            breakdown_threshold=bd,
        )
        self.trace.log(Severity.INFO, "compute: start")
        return self._main_loop()

    @highest_f32_matmul()
    def continue_to_compute(self) -> ArnoldiResult:
        """cf. continueToCompute arnoldi.hpp:720-736 (operator must be
        unchanged)."""
        if self.state is None:
            return self.compute()
        _, _, m, _ = self._resolved(self.operator)
        cur_m = self.state.H.shape[1]
        if m > cur_m:
            s = self.state
            H = s.H.new_zeros((m + 1, m))
            H[: cur_m + 1, :cur_m] = s.H
            self.state = ArnoldiState(
                V=torch.cat([s.V, s.V.new_zeros((m - cur_m, s.V.shape[1]))], 0),
                H=H,
                k=s.k,
                breakdown=s.breakdown,
                residue=s.residue,
                failed=s.failed,
            )
        self.trace.log(Severity.INFO, "continueToCompute: resuming")
        return self._main_loop()

    def _main_loop(self) -> ArnoldiResult:
        op = self.operator
        o = self.options
        tol, bd, m, min_iters = self._resolved(op)
        tracked = o.tracked_indices()
        n = op.shape[1]
        t0 = time.perf_counter()
        prev_tracked = None
        termination = None
        converged = False

        while True:
            # the host/device synchronisation point, once per chunk
            k, has_broken, has_failed = self.state.host_flags()
            if k:
                evals = np.linalg.eigvals(_hessenberg(self.state.H, k))
                evals_sorted = evals[_sorted_desc_indices(evals)]
            else:
                evals_sorted = np.zeros(0, np.complex128)
            idx = _formal_indices(tracked, k)
            cur_tracked = evals_sorted[idx] if idx else np.zeros(0, np.complex128)
            self.trace.record(k, cur_tracked, float(self.state.residue), time.perf_counter() - t0)

            if has_failed:
                termination = "numerical_failure"
                converged = False
                self.trace.log(
                    Severity.ERROR,
                    f"numerical failure at k={k}: non-finite Hessenberg/residue "
                    "(operator overflow or NaN)",
                )
                if k == 0:
                    raise ArnoldiError(
                        "numerical failure on the first Arnoldi step: the "
                        "operator produced non-finite values (overflow/NaN)"
                    )
                break
            if has_broken:
                termination = "breakdown"
                converged = bool(idx)
                self.trace.log(
                    Severity.INFO,
                    f"breakdown at k={k}: residue <= {bd:.1e} (invariant subspace)",
                )
                break
            if k >= m:
                termination = "full_subspace" if m >= n else "max_iterations"
                if termination == "max_iterations":
                    self.trace.log(Severity.WARN, f"stopped at max_iterations={m}")
                converged = termination == "full_subspace"
                break
            if (
                k >= min_iters
                and idx
                and prev_tracked is not None
                and len(prev_tracked) == len(cur_tracked)
            ):
                # successive-eigenvalue test scaled by dominant magnitude
                # (cf. arnoldi.hpp:954-996)
                scale = max(float(np.max(np.abs(evals_sorted))), 1e-300)
                delta = float(np.max(np.abs(cur_tracked - prev_tracked))) / scale
                if delta <= tol:
                    termination = "converged"
                    converged = True
                    self.trace.log(
                        Severity.INFO, f"converged at k={k}: max rel dlambda {delta:.3e} <= {tol:.1e}"
                    )
                    break
            prev_tracked = cur_tracked if idx else None

            self.state = arnoldi_steps(
                op,
                self.state,
                o.check_every,
                shift=o.eigenvalue_shift,
                breakdown_threshold=bd,
                deflate=self._deflate,
            )

        # extraction: Hessenberg eigendecomposition, |lambda|-desc sort,
        # shift-back, eigenvector lift (arnoldi.hpp:805-865)
        k = int(self.state.k)
        if k == 0:
            raise ArnoldiError("no Arnoldi steps were performed")
        evals, Y = np.linalg.eig(_hessenberg(self.state.H, k))
        order = _sorted_desc_indices(evals)
        sel = _formal_indices(tracked, k)
        if not sel:
            sel = list(range(min(o.max_eigenvalues, k)))
        chosen = order[sel]
        evals_out = evals[chosen] - complex(o.eigenvalue_shift)
        vecs = None
        if o.compute_eigenvectors:
            vecs = _lift_ritz(self.state.V, Y[:, chosen], k)
        self._result = ArnoldiResult(
            eigenvalues=evals_out,
            eigenvectors=vecs,
            iterations=k,
            converged=converged,
            termination=termination,
            trace=self.trace,
        )
        return self._result

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

    def has_error(self):
        return self.trace.has_error()

    def has_warn(self):
        return self.trace.has_warn()
