"""Block Lanczos for Hermitian operators.

Counterpart of ``eigenex_tpu/solvers/block_lanczos.py``: block Krylov
iteration with block width ``b`` multiplies the operator by ``b``
vectors at once -- the SpMM kernel, which reads every stored block once
for all b right-hand sides where single-vector SpMV is bound by those
bytes -- and, unlike single-vector Lanczos, resolves
degenerate/clustered eigenvalues (a multiplicity-m eigenvalue needs m
independent directions, which one Krylov vector can never provide).

Structure mirrors the Lanczos engine of this package: preallocated basis
rows updated in place, block CGS2 over the filled rows only (two
(k, n) x (n, b) products per pass at k filled rows), thin QR of each
residual block for the next basis block, and the band-projected matrix
assembled in the Hessenberg buffer; the host loop symmetrizes and eigh's
it every check.

A chunk follows the masked-step convention of
:mod:`eigenex_tpu_torch.solvers.lanczos`: ``k``, ``breakdown`` and
``failed`` stay on the device, rows are addressed with host integers
counted from the ``k`` the chunk started at, and a step after breakdown
or failure is masked into a no-op with ``torch.where``.  Where the JAX
chunk skips such a step with ``lax.cond``, the masked step still applies
the operator, so after a breakdown inside a chunk the operator's launch
count can exceed the reference's by up to one chunk.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core.operators import LinearOperator, aslinearoperator
from ..utils import profiling
from ..utils.exceptions import LanczosError
from ..utils.precision import highest_f32_matmul
from ..utils.prng import make_generator, random_matrix
from ..utils.tolerance import (
    default_breakdown_threshold,
    default_tolerance,
    real_dtype_of,
)
from ..utils.trace import ConvergenceTrace, Severity
from .lanczos import LanczosOptions, LanczosResult, _host_flags, _ritz_vectors

__all__ = [
    "BlockLanczosEigenSolver",
    "BlockLanczosOptions",
    "BlockLanczosState",
    "block_lanczos_steps",
    "init_block_lanczos_state",
]


@dataclasses.dataclass(frozen=True)
class BlockLanczosOptions(LanczosOptions):
    """LanczosOptions plus the Krylov block width."""

    block_size: int = 4


@dataclasses.dataclass
class BlockLanczosState:
    """Carried block-Krylov state; a chunk updates ``V`` and ``H`` in place."""

    V: torch.Tensor  # (m + b, n) basis rows, filled in b-row blocks
    H: torch.Tensor  # (m + b, m) band-projected matrix columns
    k: torch.Tensor  # () int64 -- filled rows (multiple of b)
    breakdown: torch.Tensor  # () bool
    failed: torch.Tensor  # () bool -- NaN/Inf detected (numerical failure)

    def host_flags(self) -> tuple[int, bool, bool]:
        """``(k, breakdown, failed)`` on the host, in one transfer."""
        return _host_flags(self.k, self.breakdown, self.failed)


def init_block_lanczos_state(
    op: LinearOperator, max_subspace: int, block_size: int, v0=None, *, seed=0
) -> BlockLanczosState:
    n = op.shape[1]
    b = int(block_size)
    m = (int(max_subspace) // b) * b
    if m < 2 * b:
        raise LanczosError(f"max_subspace={max_subspace} too small for block size {b}")
    dtype = op.dtype
    dev = op.device
    if v0 is None:
        v0 = random_matrix(make_generator(seed), b, n, dtype, device=dev)
    v0 = torch.as_tensor(v0).to(device=dev, dtype=dtype)
    if tuple(v0.shape) != (b, n):
        raise LanczosError(f"initial block must be ({b}, {n}), got {tuple(v0.shape)}")
    # orthonormalize the starting block (thin QR of the transpose)
    q, _ = torch.linalg.qr(v0.T)
    V = torch.zeros((m + b, n), dtype=dtype, device=dev)
    V[:b] = q.T
    return BlockLanczosState(
        V=V,
        H=torch.zeros((m + b, m), dtype=dtype, device=dev),
        k=torch.full((), b, dtype=torch.int64, device=dev),
        breakdown=torch.zeros((), dtype=torch.bool, device=dev),
        failed=torch.zeros((), dtype=torch.bool, device=dev),
    )


@torch.no_grad()
def _block_chunk(
    op: LinearOperator,
    state: BlockLanczosState,
    shift,
    breakdown_threshold: float,
    *,
    k_start: int,
    num_steps: int,
    block_size: int,
) -> BlockLanczosState:
    """Run up to ``num_steps`` block steps from row ``k_start`` (the value
    of ``state.k`` when the chunk begins, read by the caller, which also
    bounds ``num_steps`` so that the last step starts at ``k <= m``).
    A step at ``kh`` projects against the filled rows ``V[:kh]`` alone, and
    the chunk counts its CGS2 work at its end (``cgs2.rows``: ``kh`` a
    step; ``cgs2.steps``: its block steps)."""
    b = block_size
    V, H = state.V, state.H
    k, breakdown, failed = state.k, state.breakdown, state.failed
    m = H.shape[1]
    dtype = V.dtype
    dev = V.device
    rdt = real_dtype_of(dtype)
    thr = torch.as_tensor(breakdown_threshold, dtype=rdt, device=dev)
    has_shift = not (isinstance(shift, (int, float, complex)) and shift == 0)
    rows_read = 0

    for kh in range(int(k_start), int(k_start) + b * int(num_steps), b):
        active = torch.logical_not(breakdown | failed)
        Qj = V[kh - b:kh]  # (b, n)
        W = op.matmat(Qj.T).T  # (b, n)
        if has_shift:
            W = W + shift * Qj
        # block CGS2: two projection passes against the filled rows
        filled = V[:kh]
        C_total = torch.zeros((m + b, b), dtype=dtype, device=dev)
        for _ in range(2):
            C = filled.conj() @ W.T
            W = W - C.T @ filled
            C_total[:kh] += C
        rows_read += kh
        # thin QR of the residual block: W.T = Q R
        Q, R = torch.linalg.qr(W.T)  # (n, b), (b, b)
        # phase-fix so R has non-negative real diagonal (deterministic):
        # Q' = Q diag(phase), R' = diag(conj(phase)) R keeps Q'R' = QR
        d = torch.diagonal(R)
        dabs = d.abs()
        nz = dabs > 0
        phase = torch.where(nz, d / torch.where(nz, dabs, torch.ones_like(dabs)),
                            torch.ones_like(d))
        Q = Q * phase[None, :]
        R = phase.conj()[:, None] * R
        # breakdown: residual block rank-deficient
        rmin = torch.diagonal(R).abs().min()
        # H column block k-b..k: projections + the new R block rows
        Hcol = C_total  # (m+b, b) -- includes rows < k
        Hcol[kh:kh + b] = R
        # NaN/Inf guard: a non-finite projected column means the operator
        # overflowed -- stop cleanly instead of filling H with garbage
        failed_now = torch.logical_not(torch.isfinite(rmin) & torch.isfinite(Hcol).all())
        broke = torch.logical_not(failed_now) & (rmin <= thr)
        ok = torch.logical_not(broke | failed_now)
        # in-place block writes; an inactive or failed step writes back what
        # the buffers already hold, and selection keeps NaNs out
        write_h = active & torch.logical_not(failed_now)
        H[:, kh - b:kh] = torch.where(write_h, Hcol, H[:, kh - b:kh])
        # zeros on breakdown/failure, never read (k stops advancing)
        Qw = torch.where(ok, Q.T, torch.zeros_like(Q.T))
        V[kh:kh + b] = torch.where(active, Qw, V[kh:kh + b])
        k = k + torch.where(write_h, b, 0).to(k.dtype)
        breakdown = breakdown | (active & broke)
        failed = failed | (active & failed_now)

    profiling.count("cgs2.rows", rows_read)
    profiling.count("cgs2.steps", int(num_steps))
    return BlockLanczosState(V=V, H=H, k=k, breakdown=breakdown, failed=failed)


def block_lanczos_steps(op, state, num_steps, *, shift=0.0, breakdown_threshold=None,
                        block_size=None):
    """Public fixed-step routine.  Updates the tensors of ``state`` in
    place and returns a state that shares them.  Steps past the
    preallocated subspace are not run: this reads ``k`` once, before the
    chunk."""
    op = aslinearoperator(op)
    if breakdown_threshold is None:
        breakdown_threshold = default_breakdown_threshold(op.dtype)
    if block_size is None:
        raise LanczosError("block_size required")
    b = int(block_size)
    m = state.H.shape[1]
    k_start = int(state.k)
    # a step at k computes H's column block k-b..k, so the last useful
    # step starts at k == m (filling columns m-b..m and basis rows m..m+b)
    num_steps = max(min(int(num_steps), (m - k_start) // b + 1), 0)
    return _block_chunk(
        op, state, shift, float(breakdown_threshold),
        k_start=k_start, num_steps=num_steps, block_size=b,
    )


class BlockLanczosEigenSolver:
    """Hermitian eigensolver iterating b vectors at a time."""

    def __init__(self, operator=None, options: BlockLanczosOptions | None = None):
        self.operator = aslinearoperator(operator) if operator is not None else None
        self.options = options or BlockLanczosOptions()
        self.trace = ConvergenceTrace()
        self._initial_block = None
        self._result: LanczosResult | None = None

    def set_initial_block(self, v0):
        """(b, n) starting rows; they need not be orthonormal."""
        self._initial_block = v0
        return self

    @highest_f32_matmul()
    def compute(self, operator=None) -> LanczosResult:
        if operator is not None:
            self.operator = aslinearoperator(operator)
        op = self.operator
        if op is None:
            raise LanczosError("no operator set")
        if op.shape[0] != op.shape[1]:
            raise LanczosError(f"requires a square operator, got {op.shape}")
        o = self.options
        b = o.block_size
        n = op.shape[1]
        tol = o.tolerance if o.tolerance is not None else default_tolerance(op.dtype)
        bd = (
            o.breakdown_threshold
            if o.breakdown_threshold is not None
            else default_breakdown_threshold(op.dtype)
        )
        m = min(o.max_subspace, n)
        state = init_block_lanczos_state(op, m, b, self._initial_block, seed=o.seed)
        m = state.H.shape[1]
        tracked = o.tracked_indices()
        self.trace = ConvergenceTrace()
        t0 = time.perf_counter()
        prev = None
        termination = None
        converged = False
        steps_per_check = max(1, o.check_every // b)

        def projected(k):
            Hk = state.H[:k, :k].cpu().numpy().astype(
                np.complex128 if state.H.is_complex() else np.float64)
            return (Hk + Hk.conj().T) / 2

        while True:
            # the host/device synchronisation point, once per chunk.  A step
            # starting at k writes H columns k-b..k then advances k, so the
            # filled Rayleigh dimension is k - b (capped at m)
            k_dev, has_broken, has_failed = state.host_flags()
            k = min(k_dev - b, m)
            theta = np.linalg.eigvalsh(projected(k)) if k else np.zeros(0)
            idx = [i if i >= 0 else k + i for i in tracked]
            idx = [i for i in idx if 0 <= i < k]
            cur = theta[idx] if idx else np.zeros(0)
            self.trace.record(k, cur, float("nan"), time.perf_counter() - t0)

            if has_failed:
                termination = "numerical_failure"
                converged = False
                self.trace.log(
                    Severity.ERROR,
                    f"numerical failure at k={k}: non-finite projected block "
                    "(operator overflow or NaN)",
                )
                if k <= 0:
                    raise LanczosError(
                        "numerical failure on the first block-Lanczos step"
                    )
                break
            if has_broken:
                termination = "breakdown"
                # rank deficiency of ONE residual direction does not imply
                # the tracked Ritz values converged (unlike single-vector
                # Lanczos, where beta=0 means an exactly-invariant subspace);
                # report converged only if the successive test had passed
                converged = bool(
                    idx
                    and prev is not None
                    and len(prev) == len(cur)
                    and theta.size > 1
                    and float(np.max(np.abs(cur - prev)))
                    <= tol * max(float(theta[-1] - theta[0]), 1.0)
                )
                self.trace.log(
                    Severity.INFO,
                    f"block breakdown at k={k} (rank-deficient residual block)",
                )
                break
            if k_dev > m:
                termination = "full_subspace" if m >= n else "max_iterations"
                converged = termination == "full_subspace"
                if termination == "max_iterations":
                    self.trace.log(Severity.WARN, f"stopped at max subspace {m}")
                break
            if idx and prev is not None and len(prev) == len(cur):
                spread = float(theta[-1] - theta[0]) if k > 1 else 0.0
                scale = spread if spread > 0 else max(float(np.max(np.abs(theta))), 1.0)
                if float(np.max(np.abs(cur - prev))) / scale <= tol:
                    termination = "converged"
                    converged = True
                    break
            prev = cur if idx else None
            state = block_lanczos_steps(
                op, state, steps_per_check, shift=o.eigenvalue_shift,
                breakdown_threshold=bd, block_size=b,
            )

        k = min(int(state.k) - b, m)
        theta, Y = np.linalg.eigh(projected(k))
        sel = [i if i >= 0 else k + i for i in tracked]
        sel = [i for i in sel if 0 <= i < k] or list(range(min(o.max_eigenvalues, k)))
        evals = theta[sel] - np.real(o.eigenvalue_shift)
        vecs = None
        if o.compute_eigenvectors:
            vecs = _ritz_vectors(state.V, Y[:, sel], k)
        self._result = LanczosResult(
            eigenvalues=evals,
            eigenvectors=vecs,
            iterations=k,
            converged=converged,
            termination=termination,
            trace=self.trace,
        )
        return self._result
