"""Lanczos eigensolver for Hermitian matrix-free operators.

Counterpart of ``eigenex_tpu/solvers/lanczos.py`` (the reference's
Lanczos stack, include/cmpt/eigen_ex/lanczos.hpp: ``LanczosBase`` :105,
``LanczosEigenSolver`` :469, fluent configuration :517-622, convergence
machinery :853-896, breakdown semantics :316-347,433-437).

Execution model, kept from the JAX package:

- The Krylov basis is a **preallocated** ``(m+1, n)`` tensor.  Where the
  JAX chunk builds a new array with ``V.at[k+1].set(...)``, the port
  writes the row **in place** (``index_copy_``): a chunk mutates the
  tensors of the state it is given and hands the same tensors back.
- The per-step selective reorthogonalisation loop of k sequential dots
  (lanczos.hpp:411-426) is **CGS2 over the live rows**: two basis
  products against ``V[:k + 1]``
  (:func:`eigenex_tpu_torch.ops.orthogonalize.cgs2`), never against the
  rows above ``k``.
- The host drives fixed-size step *chunks* and synchronises with the
  device **once per chunk**, not per matvec.  Inside a chunk ``k``,
  ``breakdown`` and ``failed`` are 0-d device tensors; a step after
  breakdown or failure is masked into a no-op with ``torch.where``
  (selection, not multiplication, so NaNs do not spread).  Rows are
  addressed with host integers counted from the ``k`` the chunk started
  at, which is exact for as long as those flags are clear, so no step
  needs a value back from the device.
- The tridiagonal eigenproblem is O(k^2)-O(k^3) on k <= a few hundred and
  stays on the host in float64, which gives 1e-10-grade eigenvalues
  whatever the device dtype.
- Breakdown (beta <= threshold => invariant subspace,
  lanczos.hpp:331-347,433-437) is surfaced as
  ``termination="breakdown"``, never as an exception from the hot loop.

All device compute is dtype-generic (f32/f64/c64/c128); the recurrence
coefficients alpha/beta are kept in the real dtype of the operator.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from ..core.operators import LinearOperator, aslinearoperator
from ..ops.orthogonalize import cgs2, norm_psum, project_out
from ..utils import profiling
from ..utils.exceptions import LanczosError
from ..utils.precision import highest_f32_matmul
from ..utils.prng import make_generator, random_vector
from ..utils.tolerance import (
    default_breakdown_threshold,
    default_tolerance,
    real_dtype_of,
)
from ..utils.trace import ConvergenceTrace, Severity

__all__ = [
    "UNLIMITED",
    "LanczosOptions",
    "LanczosState",
    "LanczosResult",
    "LanczosEigenSolver",
    "lanczos_steps",
    "init_lanczos_state",
    "tridiagonal_eigh",
]

#: sentinel for "no limit" (cf. LanczosEigenSolver::unlimited lanczos.hpp:493)
UNLIMITED = -1


# ---------------------------------------------------------------------------
# Options (cf. fluent setters lanczos.hpp:517-622 and defaults :260-271,657-668)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LanczosOptions:
    """Configuration knobs, mirroring the reference's setter surface
    (sample_lanczos2.cpp:42-56 enumerates it).

    tolerance: relative successive-Ritz-change threshold; None -> dtype
        default (1e-12 f64 / 1e-4 f32, lanczos.hpp:67-78).
    min_iterations / max_iterations: iteration bounds; UNLIMITED = -1
        means no minimum / run to the full subspace (lanczos.hpp:493).
    max_subspace: preallocation bound on the Krylov dimension (capped at n).
    reorthogonalize_interval: CGS2 against every basis row built so far
        every this many steps; 1 = full reorthogonalisation, 0 = never
        (cf. reorthogonalizeInterval lanczos.hpp:411-426).
    max_eigenvalues: how many eigenpairs to return (lanczos.hpp:786-795).
    eigenvalue_indices: which (sorted-ascending) Ritz indices to track
        for convergence; negatives count from the top
        (cf. getFormalIndex lanczos.hpp:837-851).  None -> first
        ``max_eigenvalues`` indices.
    eigenvalue_shift: sigma applied as A+sigma*I during iteration and
        subtracted from reported eigenvalues (lanczos.hpp:155,390-392,786).
    breakdown_threshold: beta below this => invariant subspace
        (lanczos.hpp:433-437); None -> dtype default.
    check_every: host convergence-check interval in iterations -- the
        chunk length, and so the number of matvecs between two
        host/device synchronisations.
    compute_eigenvectors: build Ritz vectors (lanczos.hpp:798-817).
    seed: seed of the random initial vector (lanczos.hpp:125-135).
    """

    tolerance: float | None = None
    min_iterations: int = UNLIMITED
    max_iterations: int = UNLIMITED
    max_subspace: int = 256
    reorthogonalize_interval: int = 1
    max_eigenvalues: int = 1
    eigenvalue_indices: tuple[int, ...] | None = None
    eigenvalue_shift: float | complex = 0.0
    breakdown_threshold: float | None = None
    check_every: int = 8
    compute_eigenvectors: bool = True
    seed: int = 0

    def tracked_indices(self) -> tuple[int, ...]:
        if self.eigenvalue_indices is not None:
            return tuple(self.eigenvalue_indices)
        return tuple(range(self.max_eigenvalues))


# ---------------------------------------------------------------------------
# State & result
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class LanczosState:
    """Carried Krylov state (the reference's in-memory
    ``continueToCompute`` state, lanczos.hpp:235-245,696-712).  The
    chunk updates ``V``, ``alpha`` and ``beta`` in place."""

    V: torch.Tensor  # (m+1, n) orthonormal basis rows (rows > k are zero or stale)
    alpha: torch.Tensor  # (m,) real diagonal
    beta: torch.Tensor  # (m,) real off-diagonal; beta[k-1] links V[k-1], V[k]
    k: torch.Tensor  # () int64, number of completed steps
    breakdown: torch.Tensor  # () bool
    failed: torch.Tensor  # () bool -- NaN/Inf detected (numerical failure)

    def host_flags(self) -> tuple[int, bool, bool]:
        """``(k, breakdown, failed)`` on the host, in one transfer."""
        return _host_flags(self.k, self.breakdown, self.failed)


def _host_flags(k, breakdown, failed) -> tuple[int, bool, bool]:
    packed = torch.stack([k, breakdown.to(k.dtype), failed.to(k.dtype)]).tolist()
    return int(packed[0]), bool(packed[1]), bool(packed[2])


@dataclasses.dataclass
class LanczosResult:
    """Eigenpairs + diagnostics (cf. eigenvalues()/eigenvectors() accessors
    lanczos.hpp:633-654 and termination bookkeeping :743-768)."""

    eigenvalues: np.ndarray  # (p,) ascending
    eigenvectors: torch.Tensor | np.ndarray | None  # (n, p) columns, or None
    iterations: int
    converged: bool
    termination: str  # "converged" | "breakdown" | "max_iterations" | "full_subspace" | ...
    trace: ConvergenceTrace

    def residual_norms(self, op) -> np.ndarray:
        """||A x_i - lambda_i x_i|| for each returned pair -- the acceptance
        check of the reference samples (sample_arnoldi.cpp:42-52)."""
        if self.eigenvectors is None:
            raise LanczosError("eigenvectors were not computed")
        op = aslinearoperator(op)
        X = torch.as_tensor(self.eigenvectors).to(device=op.device, dtype=op.dtype)
        lam = torch.as_tensor(np.asarray(self.eigenvalues)).to(device=op.device, dtype=op.dtype)
        r = op.matmat(X) - X * lam[None, :]
        return torch.linalg.vector_norm(r, dim=0).cpu().numpy()


# ---------------------------------------------------------------------------
# The Krylov chunk
# ---------------------------------------------------------------------------
def _start_vector(op: LinearOperator, v0, seed, deflate, breakdown_threshold, error):
    """(unit start vector, its norm before normalisation); shared with
    the Arnoldi state (cf. setInitialLanczosvector lanczos.hpp:299-329)."""
    n = op.shape[1]
    dtype = op.dtype
    if v0 is None:
        v0 = random_vector(make_generator(seed), n, dtype, normalize=False, device=op.device)
    v0 = torch.as_tensor(v0).to(device=op.device, dtype=dtype)
    if v0.shape != (n,):
        raise error(f"initial vector must have shape ({n},), got {tuple(v0.shape)}")
    if deflate is not None:
        # deflation against user "orthogonalizingVectors" (lanczos.hpp:312-314)
        v0 = project_out(torch.as_tensor(deflate).to(device=op.device, dtype=dtype), v0)
    nrm = float(torch.linalg.vector_norm(v0))
    thr = breakdown_threshold
    if thr is None:
        thr = default_breakdown_threshold(dtype)
    if not np.isfinite(nrm):
        raise error(f"initial vector is not finite (norm {nrm})")
    if nrm <= thr:
        # initial-vector breakdown is a *configuration* failure and can be
        # raised eagerly on host (cf. lanczos.hpp:316-321)
        raise error(
            f"initial vector has (post-deflation) norm {nrm:.3e} <= breakdown "
            f"threshold {thr:.3e}"
        )
    return v0 / nrm, nrm


def init_lanczos_state(
    op: LinearOperator,
    max_subspace: int,
    v0=None,
    *,
    seed: int = 0,
    deflate=None,
    breakdown_threshold: float | None = None,
) -> LanczosState:
    """Allocate state on the operator's device and set the (deflated,
    normalised) initial vector."""
    n = op.shape[1]
    m = int(max_subspace)
    dev = op.device
    rdt = real_dtype_of(op.dtype)
    v0, _ = _start_vector(op, v0, seed, deflate, breakdown_threshold, LanczosError)
    V = torch.zeros((m + 1, n), dtype=op.dtype, device=dev)
    V[0] = v0
    return LanczosState(
        V=V,
        alpha=torch.zeros((m,), dtype=rdt, device=dev),
        beta=torch.zeros((m,), dtype=rdt, device=dev),
        k=torch.zeros((), dtype=torch.int64, device=dev),
        breakdown=torch.zeros((), dtype=torch.bool, device=dev),
        failed=torch.zeros((), dtype=torch.bool, device=dev),
    )


def _real(x: torch.Tensor) -> torch.Tensor:
    return x.real if x.is_complex() else x


@torch.no_grad()
def _lanczos_chunk(
    op: LinearOperator,
    state: LanczosState,
    shift,
    breakdown_threshold: float,
    deflate,
    *,
    k_start: int,
    num_steps: int,
    reorthogonalize_interval: int,
    comm=None,
) -> LanczosState:
    """Run up to ``num_steps`` Lanczos three-term-recurrence steps.

    Implements the hot loop of updateLanczosSteps (lanczos.hpp:371-450):
    matvec + shift (:389-392), recurrence (:404-407), reorthogonalisation
    by CGS2 over the live rows ``V[:kh + 1]`` (:411-426), beta breakdown
    check (:429-437).

    ``k_start`` is the value of ``state.k`` when the chunk begins, read
    by the caller, which also bounds ``num_steps`` so that
    ``k_start + num_steps <= m``.  The loop itself reads nothing back
    from the device: while no step has broken down or failed, step ``j``
    works on row ``k_start + j``, so rows are addressed with host
    integers; once ``breakdown`` or ``failed`` is set on the device,
    every later step of the chunk is masked into a no-op, whatever row it
    was aimed at.

    ``comm`` (the JAX chunk's ``axis_name``): inside ``shard_map`` the
    basis rows and vectors are this shard's column panel, the operator is
    the shard-local one, and every inner product is completed with
    ``comm.psum`` -- the single-device chunk with collectives injected.

    The chunk is never captured in a graph, so it counts its CGS2 work once
    at its end (``cgs2.rows``: the rows one pass reads, summed over the
    steps that run CGS2; ``cgs2.steps``: its steps).
    """
    V, alpha, beta = state.V, state.alpha, state.beta
    k, breakdown, failed = state.k, state.breakdown, state.failed
    rdt = alpha.dtype
    dtype = V.dtype
    dev = V.device
    thr = torch.as_tensor(breakdown_threshold, dtype=rdt, device=dev)
    one = torch.ones((), dtype=rdt, device=dev)
    zero = torch.zeros((), dtype=rdt, device=dev)
    has_shift = not (isinstance(shift, (int, float, complex)) and shift == 0)
    rows_read = 0

    for kh in range(int(k_start), int(k_start) + int(num_steps)):
        active = torch.logical_not(breakdown | failed)
        vk = V[kh]
        w = op.matvec(vk)
        if has_shift:
            w = w + shift * vk
        if reorthogonalize_interval == 1:
            # fused path: the CGS2 coefficients against rows <= k
            # CONTAIN the recurrence -- c[k] = <v_k, w> is alpha_k and
            # c[k-1] the beta_prev term -- so no separate alpha dot-product
            # and no explicit three-term subtraction (it is the k, k-1 part
            # of the projection).  Numerically this is exactly Arnoldi's
            # Hessenberg-column CGS2 specialised to a Hermitian operator.
            w, c = cgs2(V[:kh + 1], w, comm=comm)
            rows_read += kh + 1
            alpha_k = _real(c[kh]).to(rdt)
            if deflate is not None:
                # deflate AFTER the projection: the CGS coefficients are
                # O(1) here, so projecting against V re-introduces a
                # deflate component that would otherwise amplify
                # geometrically step over step (lanczos.hpp:421-425)
                w = project_out(deflate, w, comm=comm)
        else:
            if deflate is not None:
                # keep iterates out of the user-supplied deflation space
                # (lanczos.hpp:421-425)
                w = project_out(deflate, w, comm=comm)
            dot = torch.vdot(vk, w)
            alpha_k = _real(comm.psum(dot) if comm is not None else dot).to(rdt)
            # three-term recurrence (no beta[k-1] term at k == 0)
            w = w - alpha_k.to(dtype) * vk
            if kh > 0:
                w = w - beta[kh - 1].to(dtype) * V[kh - 1]
            if reorthogonalize_interval > 0 and (kh + 1) % reorthogonalize_interval == 0:
                w, _c = cgs2(V[:kh + 1], w, comm=comm)
                rows_read += kh + 1
        beta_k = norm_psum(w, comm).to(rdt)
        # NaN/Inf guard (cf. the reference's failure-first design,
        # lanczos.hpp:316-347,433-437): a non-finite alpha/beta means the
        # matvec overflowed or produced NaN -- stop, don't iterate garbage.
        failed_now = torch.logical_not(torch.isfinite(alpha_k) & torch.isfinite(beta_k))
        broke = torch.logical_not(failed_now) & (beta_k <= thr)
        ok = torch.logical_not(broke | failed_now)
        safe = torch.where(ok, beta_k, one)
        # on breakdown/failure the next row is written as zeros and never
        # read (k stops advancing); selection keeps NaNs out
        v_next = torch.where(ok, w / safe.to(dtype), torch.zeros_like(w))
        # in-place single-row writes (the JAX chunk's V.at[k+1].set); an
        # inactive step writes back what the row already holds
        V[kh + 1] = torch.where(active, v_next, V[kh + 1])
        alpha[kh] = torch.where(active, torch.where(failed_now, zero, alpha_k), alpha[kh])
        beta[kh] = torch.where(active, torch.where(ok, beta_k, zero), beta[kh])
        k = k + (active & torch.logical_not(failed_now)).to(k.dtype)
        breakdown = breakdown | (active & broke)
        failed = failed | (active & failed_now)

    profiling.count("cgs2.rows", rows_read)
    profiling.count("cgs2.steps", int(num_steps))
    return LanczosState(V=V, alpha=alpha, beta=beta, k=k, breakdown=breakdown, failed=failed)


def lanczos_steps(
    op: LinearOperator,
    state: LanczosState,
    num_steps: int,
    *,
    shift=0.0,
    breakdown_threshold: float | None = None,
    reorthogonalize_interval: int = 1,
    deflate=None,
) -> LanczosState:
    """Public fixed-step basis routine (the ``LanczosBase`` role,
    lanczos.hpp:105-465).  Updates the tensors of ``state`` in place and
    returns a state that shares them.  Steps past the preallocated
    subspace are not run: this reads ``k`` once, before the chunk."""
    if breakdown_threshold is None:
        breakdown_threshold = default_breakdown_threshold(op.dtype)
    m = state.alpha.shape[0]
    k_start = int(state.k)
    num_steps = max(min(int(num_steps), m - k_start), 0)
    if deflate is not None:
        deflate = torch.as_tensor(deflate).to(device=op.device, dtype=op.dtype)
    return _lanczos_chunk(
        op,
        state,
        shift,
        float(breakdown_threshold),
        deflate,
        k_start=k_start,
        num_steps=num_steps,
        reorthogonalize_interval=int(reorthogonalize_interval),
    )


# ---------------------------------------------------------------------------
# Host-side tridiagonal eigenproblem + convergence logic
# ---------------------------------------------------------------------------
def tridiagonal_eigh(alpha: np.ndarray, beta: np.ndarray, eigvals_only=False):
    """Eigendecomposition of the k x k symmetric tridiagonal T(alpha, beta)
    on host float64 (the replacement for
    SelfAdjointEigenSolver::computeFromTridiagonal, lanczos.hpp:779-781)."""
    from scipy.linalg import eigh_tridiagonal

    alpha = np.asarray(alpha, np.float64)
    beta = np.asarray(beta, np.float64)
    k = alpha.shape[0]
    if eigvals_only:
        return eigh_tridiagonal(alpha, beta[: k - 1], eigvals_only=True)
    return eigh_tridiagonal(alpha, beta[: k - 1])


def _formal_indices(indices: Sequence[int], count: int) -> list[int]:
    """Map tracked indices (negatives from the top) into [0, count)
    (cf. getFormalIndex lanczos.hpp:837-851)."""
    out = []
    for i in indices:
        j = i if i >= 0 else count + i
        if 0 <= j < count:
            out.append(j)
        else:
            return []  # not enough Ritz values yet to track all requested
    return out


def _phase_fix(X: torch.Tensor) -> torch.Tensor:
    """Make the first significantly-nonzero coefficient of each column
    real-positive (cf. lanczos.hpp:806-816)."""
    absX = X.abs()
    thresh = absX.amax(dim=0, keepdim=True) * 1e-6
    sig = (absX > thresh).to(torch.uint8)
    first = torch.argmax(sig, dim=0)  # first True per column
    lead = X.gather(0, first[None, :]).squeeze(0)
    denom = lead.abs()
    phase = torch.where(
        denom > 0, lead / torch.where(denom > 0, denom, torch.ones_like(denom)),
        torch.ones_like(lead),
    )
    return X * phase.conj()[None, :]


@torch.no_grad()
def _ritz_vectors(V: torch.Tensor, Y, k: int) -> torch.Tensor:
    """x_j = sum_m Y[m, j] V[m]  (lanczos.hpp:798-804), one matmul; then
    normalise + phase-fix (:806-816)."""
    Y = torch.as_tensor(np.asarray(Y)).to(device=V.device, dtype=V.dtype)
    if isinstance(V, torch.Tensor):
        X = V[:k].T @ Y  # (n, p)
    else:  # a basis in per-shard column panels: each panel's rows, joined
        X = V.combine(lambda piece: piece[:k].T @ Y.to(piece.device), dim=0)
    X = X / torch.linalg.vector_norm(X, dim=0, keepdim=True)
    return _phase_fix(X)


# ---------------------------------------------------------------------------
# The solver
# ---------------------------------------------------------------------------
class LanczosEigenSolver:
    """Hermitian eigensolver (cf. LanczosEigenSolver lanczos.hpp:469).

    Typical use::

        solver = LanczosEigenSolver(op, LanczosOptions(max_eigenvalues=5))
        result = solver.compute()

    or with reference-style fluent configuration
    (cf. lanczos.hpp:517-622)::

        result = (LanczosEigenSolver(op)
                  .set_tolerance(1e-10)
                  .set_max_eigenvalues(3)
                  .compute())
    """

    def __init__(self, operator=None, options: LanczosOptions | None = None):
        self.operator = aslinearoperator(operator) if operator is not None else None
        self.options = options or LanczosOptions()
        self.state: LanczosState | None = None
        self.trace = ConvergenceTrace()
        self._initial_vector = None
        self._deflate = None
        self._result: LanczosResult | None = None

    # -- fluent configuration (lanczos.hpp:517-622) ----------------------
    def _set(self, **kw) -> "LanczosEigenSolver":
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

    def set_reorthogonalize_interval(self, n):
        return self._set(reorthogonalize_interval=n)

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
        """cf. setInitialVector lanczos.hpp:214"""
        self._initial_vector = v0
        return self

    def set_orthogonalizing_vectors(self, D):
        """Deflation space rows (cf. orthogonalizingVectors lanczos.hpp:153)."""
        self._deflate = D
        return self

    def set_all_settings_default(self):
        """cf. setAllSettingsDefault lanczos.hpp:657-668"""
        self.options = LanczosOptions()
        return self

    # -- derived settings ------------------------------------------------
    def _resolved(self, op: LinearOperator):
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
        min_iters = max(o.min_iterations, 0)
        return tol, bd, m, max_iters, min_iters

    # -- main entry points ----------------------------------------------
    @highest_f32_matmul()
    def compute(self, operator=None) -> LanczosResult:
        """Run from scratch (cf. compute lanczos.hpp:717-738: clears state,
        sets the initial vector, runs mainCalculation_)."""
        if operator is not None:
            self.operator = aslinearoperator(operator)
        if self.operator is None:
            raise LanczosError("no operator set")
        op = self.operator
        if op.shape[0] != op.shape[1]:
            raise LanczosError(f"Lanczos requires a square operator, got {op.shape}")
        self.trace = ConvergenceTrace()
        _, bd, m, _, _ = self._resolved(op)
        self.state = init_lanczos_state(
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
    def continue_to_compute(self) -> LanczosResult:
        """Resume iteration with retained basis/alpha/beta after the user
        changed settings -- operator must be unchanged (cf.
        continueToCompute lanczos.hpp:696-712 and the constraint :699)."""
        if self.state is None:
            return self.compute()
        op = self.operator
        _, _, m, _, _ = self._resolved(op)
        cur_m = self.state.alpha.shape[0]
        if m > cur_m:
            # grow the preallocated buffers, preserving history
            s = self.state
            pad = m - cur_m
            self.state = LanczosState(
                V=torch.cat([s.V, s.V.new_zeros((pad, s.V.shape[1]))], 0),
                alpha=torch.cat([s.alpha, s.alpha.new_zeros((pad,))]),
                beta=torch.cat([s.beta, s.beta.new_zeros((pad,))]),
                k=s.k,
                breakdown=s.breakdown,
                failed=s.failed,
            )
        self.trace.log(Severity.INFO, "continueToCompute: resuming")
        return self._main_loop()

    def _run_chunk(self, op, state, num_steps, breakdown_threshold) -> LanczosState:
        """One chunk of iterations."""
        o = self.options
        return lanczos_steps(
            op,
            state,
            num_steps,
            shift=o.eigenvalue_shift,
            breakdown_threshold=breakdown_threshold,
            reorthogonalize_interval=o.reorthogonalize_interval,
            deflate=self._deflate,
        )

    # -- the host control loop (mainCalculation_, lanczos.hpp:740-830) ---
    def _main_loop(self) -> LanczosResult:
        op = self.operator
        o = self.options
        tol, bd, m, max_iters, min_iters = self._resolved(op)
        tracked = o.tracked_indices()
        n = op.shape[1]
        t0 = time.perf_counter()
        prev_tracked: np.ndarray | None = None
        termination = None
        converged = False

        while True:
            # the host/device synchronisation point, once per chunk
            k, has_broken, has_failed = self.state.host_flags()
            alpha = self.state.alpha[:k].double().cpu().numpy() if k else np.zeros(0)
            beta = self.state.beta[:k].double().cpu().numpy() if k else np.zeros(0)
            ritz = tridiagonal_eigh(alpha, beta, eigvals_only=True) if k else np.zeros(0)
            idx = _formal_indices(tracked, k)
            cur_tracked = ritz[idx] if idx else np.zeros(0)
            resid = float(beta[k - 1]) if k else float("nan")
            self.trace.record(k, cur_tracked, resid, time.perf_counter() - t0)

            # -- termination checks, in the reference's order (:744-768) --
            if has_failed:
                # NaN/Inf detected in the recurrence (cf. the reference's
                # failure-first exits, lanczos.hpp:316-347) -- stop cleanly
                # with only the finite pre-failure steps retained
                termination = "numerical_failure"
                converged = False
                self.trace.log(
                    Severity.ERROR,
                    f"numerical failure at k={k}: non-finite alpha/beta "
                    "(operator overflow or NaN) -- check operator scaling/dtype",
                )
                if k == 0:
                    raise LanczosError(
                        "numerical failure on the first Lanczos step: the "
                        "operator produced non-finite values (overflow/NaN)"
                    )
                break
            if has_broken:
                termination = "breakdown"
                self.trace.log(
                    Severity.INFO,
                    f"breakdown at k={k}: invariant subspace found (beta <= {bd:.1e})",
                )
                converged = bool(idx)
                break
            if k >= m:
                termination = "full_subspace" if m >= n else "max_iterations"
                if termination == "max_iterations":
                    self.trace.log(Severity.WARN, f"stopped at max_iterations={m}")
                else:
                    self.trace.log(Severity.INFO, f"full Krylov subspace reached (k={k}=n)")
                converged = termination == "full_subspace"
                break
            if (
                k >= min_iters
                and idx
                and prev_tracked is not None
                and len(prev_tracked) == len(cur_tracked)
            ):
                # relative successive-Ritz change scaled by spectral spread
                # (lanczos.hpp:869-896)
                spread = float(ritz[-1] - ritz[0]) if k > 1 else 0.0
                scale = spread if spread > 0 else max(float(np.max(np.abs(ritz))), 1.0)
                delta = float(np.max(np.abs(cur_tracked - prev_tracked))) / scale
                if delta <= tol:
                    termination = "converged"
                    converged = True
                    self.trace.log(
                        Severity.INFO,
                        f"converged at k={k}: max rel dRitz {delta:.3e} <= {tol:.1e}",
                    )
                    break
            prev_tracked = cur_tracked if idx else None

            self.state = self._run_chunk(op, self.state, o.check_every, bd)

        # -- extraction (lanczos.hpp:779-817) --------------------------------
        k = int(self.state.k)
        if k == 0:
            raise LanczosError("no Lanczos steps were performed")
        alpha = self.state.alpha[:k].double().cpu().numpy()
        beta = self.state.beta[:k].double().cpu().numpy()
        evals, Y = tridiagonal_eigh(alpha, beta)
        sel = _formal_indices(tracked, k)
        if not sel:
            sel = list(range(min(o.max_eigenvalues, k)))
        evals_out = evals[sel] - np.real(o.eigenvalue_shift)
        vecs = None
        if o.compute_eigenvectors:
            vecs = _ritz_vectors(self.state.V, Y[:, sel], k)
        self._result = LanczosResult(
            eigenvalues=evals_out,
            eigenvectors=vecs,
            iterations=k,
            converged=converged,
            termination=termination,
            trace=self.trace,
        )
        return self._result

    # -- reference-style accessors --------------------------------------
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

    def has_error(self):
        return self.trace.has_error()

    def has_warn(self):
        return self.trace.has_warn()
