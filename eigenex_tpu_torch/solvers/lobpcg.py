"""LOBPCG -- locally optimal block preconditioned conjugate gradient.

Counterpart of ``eigenex_tpu/solvers/lobpcg.py``.  LOBPCG iterates a
*block* of b approximate eigenvectors with a 3b-dimensional trial space
[X, W, P] (current block, preconditioned residuals, previous search
directions).  It is the natural choice for the lowest/highest eigenpairs
on a card because

- every heavy operation is a tall-skinny product -- ``A @ S`` (the
  operator's SpMM kernel, which reads each stored block once for all 3b
  columns) and the ``S^H (AS)`` Gram products -- with no sequential
  recurrence;
- it accepts a PRECONDITIONER ``T ~ A^-1`` (the one thing Krylov methods
  cannot exploit without restarting machinery);
- it solves the GENERALIZED problem ``A x = lambda B x`` natively
  (B-inner products throughout) -- the ``eigsh(A, M=B)`` front-end route.

Execution model, kept from the JAX package: the block products run on
the device in the operator dtype, while the 3b x 3b projected pencil is
pulled to the host each iteration and solved in f64 (3b is tiny; one
round trip per iteration is the algorithm's own granularity, unlike
Lanczos where chunks are batched).  The small dense products stay
``torch.matmul``, as the JAX package leaves them outside any kernel.
Basis conditioning is handled the robust way: the trial Gram G_B is
eigen-whitened on the host, directions below a rank tolerance are
dropped, and on severe ill-conditioning the P block is discarded for
that iteration (soft restart) -- the standard Knyazev/Duersch safeguards.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core.operators import LinearOperator, aslinearoperator
from ..utils.exceptions import LanczosError
from ..utils.precision import highest_f32_matmul
from ..utils.prng import make_generator, random_matrix
from ..utils.tolerance import default_tolerance, real_dtype_of
from ..utils.trace import ConvergenceTrace, Severity
from .lanczos import LanczosResult

__all__ = ["LOBPCGOptions", "LOBPCGSolver", "lobpcg"]


@dataclasses.dataclass(frozen=True)
class LOBPCGOptions:
    """Knobs for :class:`LOBPCGSolver` (frozen, reference-style defaults).

    tolerance: per-pair relative residual target
    ``||A x - lambda B x|| <= tol * (||A||_est + |lambda| * ||B||_est)``;
    dtype default as everywhere (1e-12 f64 / 1e-4 f32, lanczos.hpp:67-78).
    """

    largest: bool = False
    tolerance: float | None = None
    max_iterations: int = 200
    seed: int = 0
    compute_eigenvectors: bool = True
    #: drop trial directions whose whitened G_B eigenvalue is below
    #: rank_tol x max -- the basis-conditioning safeguard
    rank_tol: float = 1e-8


def _colnormalize(M: torch.Tensor) -> torch.Tensor:
    """Scale each column to unit 2-norm (zero columns left untouched) --
    without this the trial Gram's eigenvalue spread is ||r||^2 (the rank
    cutoff would drop W once residuals pass sqrt(rank_tol) and the
    iteration stagnates); normalized, the spread measures angles only."""
    nrm = torch.linalg.vector_norm(M, dim=0)
    return M / torch.where(nrm > 0, nrm, torch.ones_like(nrm))[None, :]


def _gram_stage(op: LinearOperator, opB, S: torch.Tensor, *, has_b: bool):
    """Device stage 1: AS, BS and the two 3b x 3b (or smaller) Grams."""
    AS = op.matmat(S)
    BS = opB.matmat(S) if has_b else S
    SH = S.conj().T
    return AS, BS, SH @ AS, SH @ BS


def _update_stage(S, AS, BS, C, Cp, lam):
    """Device stage 2: new X/P blocks and residuals from host coefficients.

    X = S C;  P = S Cp (the W,P span only -- locally-optimal recurrence);
    R = A X - B X diag(lambda).  Also returns the residual column norms,
    whose finiteness the host loop checks without pulling the blocks
    themselves.
    """
    X = S @ C
    AX = AS @ C
    BX = BS @ C
    P = S @ Cp
    R = AX - BX * lam[None, :]
    rn = torch.linalg.vector_norm(R, dim=0)
    return X, P, R, rn


def _host_rayleigh_ritz(GA, GB, b, largest, rank_tol):
    """Solve the projected pencil (GA, GB) on host in f64.

    Whiten by the eigendecomposition of GB (robust to rank deficiency:
    directions with eigenvalue <= rank_tol * max are dropped), then eigh
    the reduced standard problem.  Returns (lambda (b,), C (m, b) pencil
    eigenvectors, kept) or None when GB has no usable directions.
    """
    GA = np.asarray(GA, np.complex128 if np.iscomplexobj(GA) else np.float64)
    GB = np.asarray(GB, GA.dtype)
    GA = (GA + GA.conj().T) / 2
    GB = (GB + GB.conj().T) / 2
    if not (np.all(np.isfinite(GA)) and np.all(np.isfinite(GB))):
        return None
    d, U = np.linalg.eigh(GB)
    keep = d > rank_tol * max(float(d[-1]), 0.0)
    if int(np.count_nonzero(keep)) < b:
        return None
    W = U[:, keep] / np.sqrt(d[keep])[None, :]  # whitener: W^H GB W = I
    Ared = W.conj().T @ GA @ W
    Ared = (Ared + Ared.conj().T) / 2
    theta, Y = np.linalg.eigh(Ared)
    sel = np.arange(Ared.shape[0] - b, Ared.shape[0]) if largest else np.arange(b)
    lam = theta[sel]
    C = W @ Y[:, sel]  # (m, b), GB-orthonormal columns
    if largest:  # descending-lambda ordering is conventional for largest=
        lam, C = lam[::-1].copy(), C[:, ::-1].copy()  # torch takes no negative strides
    return lam, C, keep


class LOBPCGSolver:
    """Block preconditioned eigensolver for ``A x = lambda B x`` (A, B
    Hermitian, B positive definite or absent).

    Parameters: ``operator`` (A), ``b_operator`` (B, optional),
    ``preconditioner`` (callable or LinearOperator ``T ~ A^-1`` applied to
    the residual block, optional).  Returns the ``block_size`` smallest
    (default) or largest eigenpairs as a :class:`LanczosResult`.  The
    solve runs where the operator's tensors live.
    """

    def __init__(
        self,
        operator=None,
        options: LOBPCGOptions | None = None,
        *,
        block_size: int = 4,
        b_operator=None,
        preconditioner=None,
    ):
        self.operator = aslinearoperator(operator) if operator is not None else None
        # host operands of B and T go where A lives
        dev = self.operator.device if self.operator is not None else None
        self.b_operator = (
            aslinearoperator(b_operator, device=dev) if b_operator is not None else None
        )
        if preconditioner is not None and not callable(preconditioner):
            preconditioner = aslinearoperator(preconditioner, device=dev)
        self.preconditioner = preconditioner
        self.options = options or LOBPCGOptions()
        self.block_size = int(block_size)
        self.trace = ConvergenceTrace()
        self._initial_block = None
        self._result: LanczosResult | None = None

    def set_initial_block(self, X0):
        """(n, b) starting guess; columns need not be orthonormal."""
        self._initial_block = X0
        return self

    def _apply_precond(self, R):
        T = self.preconditioner
        if T is None:
            return R
        if isinstance(T, LinearOperator):
            return T.matmat(R)
        return T(R)

    def _run_gram(self, S, has_b):
        """(AS, BS, GA, GB) for the trial block."""
        opB = self.b_operator if has_b else self.operator
        return _gram_stage(self.operator, opB, S, has_b=has_b)

    @highest_f32_matmul()
    @torch.no_grad()
    def compute(self, operator=None) -> LanczosResult:
        if operator is not None:
            self.operator = aslinearoperator(operator)
        op = self.operator
        if op is None:
            raise LanczosError("no operator set")
        n = op.shape[0]
        if op.shape[0] != op.shape[1]:
            raise LanczosError(f"requires a square operator, got {op.shape}")
        o = self.options
        b = self.block_size
        if 3 * b > n:
            raise LanczosError(
                f"block size {b} too large: LOBPCG needs 3*b <= n (n={n}); "
                "use a dense eigh or Lanczos with a full subspace instead"
            )
        opB = self.b_operator
        has_b = opB is not None
        if has_b and opB.shape != op.shape:
            raise LanczosError(f"B shape {opB.shape} != A shape {op.shape}")
        dtype = op.dtype
        dev = op.device
        rdt = real_dtype_of(dtype)
        tol = o.tolerance if o.tolerance is not None else default_tolerance(dtype)
        self.trace = ConvergenceTrace()
        t0 = time.perf_counter()

        X = self._initial_block
        if X is None:
            X = random_matrix(make_generator(o.seed), b, n, dtype, device=dev).T  # (n, b)
        X = torch.as_tensor(X).to(device=dev, dtype=dtype)
        if tuple(X.shape) != (n, b):
            raise LanczosError(f"initial block must be ({n}, {b}), got {tuple(X.shape)}")
        P = torch.zeros((n, b), dtype=dtype, device=dev)
        R = None
        have_p = False
        lam = np.zeros(b)
        rn_np = None
        norm_a_est = 1.0
        termination = None
        converged = False
        it = 0

        def pull_grams(GA, GB):
            # the iteration's round trip: both Grams in one transfer
            G = torch.stack([GA, GB]).cpu().numpy()
            return G[0], G[1]

        for it in range(1, o.max_iterations + 1):
            # iteration 1 has no residual yet: the trial space is X alone
            # (a pure Rayleigh-Ritz that also B-orthonormalizes the guess)
            W = _colnormalize(self._apply_precond(R)) if R is not None else None
            Pn = _colnormalize(P) if have_p else None
            S = torch.cat([t for t in (X, W, Pn) if t is not None], dim=1)
            AS, BS, GA, GB = self._run_gram(S, has_b)
            rr = _host_rayleigh_ritz(*pull_grams(GA, GB), b, o.largest, o.rank_tol)
            if rr is None and have_p:
                # ill-conditioned trial basis: soft restart without P
                self.trace.log(
                    Severity.WARN,
                    f"iteration {it}: trial basis ill-conditioned, dropping P",
                )
                S = torch.cat([X, W], dim=1) if W is not None else X
                AS, BS, GA, GB = self._run_gram(S, has_b)
                rr = _host_rayleigh_ritz(*pull_grams(GA, GB), b, o.largest, o.rank_tol)
            if rr is None:
                termination = "numerical_failure"
                self.trace.log(
                    Severity.ERROR,
                    f"iteration {it}: projected pencil unusable "
                    "(non-finite Gram or rank < block size)",
                )
                break
            lam, C, _ = rr
            m = S.shape[1]
            # P spans only the W,P contribution (C with the X rows zeroed)
            Cp = np.array(C, copy=True)
            Cp[:b, :] = 0.0
            norm_a_est = max(norm_a_est, float(np.max(np.abs(lam))))
            X, P, R, rn = _update_stage(
                S, AS, BS,
                torch.as_tensor(C).to(device=dev, dtype=dtype),
                torch.as_tensor(Cp).to(device=dev, dtype=dtype),
                torch.as_tensor(np.real(lam)).to(device=dev, dtype=rdt),
            )
            # P is the W,P contribution -- nonzero only once W entered S
            have_p = m > b
            rn_np = rn.double().cpu().numpy()
            if not np.all(np.isfinite(rn_np)):
                termination = "numerical_failure"
                self.trace.log(
                    Severity.ERROR, f"iteration {it}: non-finite residual block"
                )
                break
            self.trace.record(it, np.real(lam), float(rn_np.max()), time.perf_counter() - t0)
            scale = norm_a_est + np.abs(np.real(lam))
            if np.all(rn_np <= tol * scale):
                termination = "converged"
                converged = True
                break
        else:
            termination = "max_iterations"
            self.trace.log(
                Severity.WARN,
                f"stopped at max_iterations={o.max_iterations}; max residual "
                f"{float(np.max(rn_np)) if rn_np is not None else float('nan'):.3e}",
            )

        order = np.argsort(np.real(lam)) if not o.largest else np.arange(b)
        self._result = LanczosResult(
            eigenvalues=np.real(lam)[order],
            eigenvectors=(X[:, order.tolist()] if o.compute_eigenvectors else None),
            iterations=it,
            converged=converged,
            termination=termination,
            trace=self.trace,
        )
        return self._result


@highest_f32_matmul()
def lobpcg(
    A,
    k: int = 4,
    *,
    B=None,
    preconditioner=None,
    X0=None,
    largest: bool = False,
    tol: float | None = None,
    max_iterations: int = 200,
    seed: int = 0,
    device=None,
) -> LanczosResult:
    """One-call LOBPCG: ``k`` smallest (or largest) eigenpairs of
    ``A x = lambda B x`` with an optional preconditioner -- the scipy
    ``lobpcg`` surface on the package's operator types.  ``device``
    places host operands (the card unless told otherwise); containers
    and operators are used where they live."""
    solver = LOBPCGSolver(
        aslinearoperator(A, device=device),
        LOBPCGOptions(
            largest=largest, tolerance=tol, max_iterations=max_iterations, seed=seed
        ),
        block_size=k,
        b_operator=aslinearoperator(B, device=device) if B is not None else None,
        preconditioner=preconditioner,
    )
    if X0 is not None:
        solver.set_initial_block(X0)
    return solver.compute()
