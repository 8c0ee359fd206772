"""Matrix-free CG, CGLS and MINRES solvers and the Hermitian
shift-invert operator.

Counterpart of ``eigenex_tpu/solvers/cg.py``.  The reference has no
linear solver, but BASELINE.json config 5 demands **shift-invert
Lanczos**, whose operator is (A - sigma I)^-1 applied per matvec; for a
Hermitian A the inner solve is CG or MINRES, and CGLS is the
least-squares fallback of the general route
(:mod:`eigenex_tpu_torch.solvers.gmres`).

Execution model.  The JAX loops are ``lax.while_loop``s that test their
stop condition on the device before every iteration.  Here the loop is a
Python loop over device tensors, and the host reads the stop condition
every ``CHECK_EVERY`` = 8 iterations (one synchronisation).  Between two
reads each step evaluates the same condition on the device and applies
its update only while it holds (``torch.where``, a selection, so NaNs of
a step past the stop cannot leak); a step past the stop is a masked
no-op that still applies the operator.  So the iterate and the iteration
count equal the reference's, and a solve costs at most
``CHECK_EVERY - 1`` operator applications more than it uses.  Where the
JAX loops take ``axis_name``, the loops here take ``comm`` (an
:class:`~eigenex_tpu_torch.parallel.shard_map.AxisComm`): every inner
product is completed with ``comm.psum``, so the stop condition the host
reads is the same on every shard.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.operators import LinearOperator, aslinearoperator
from ..utils.exceptions import EigenexError
from ..utils.precision import highest_f32_matmul
from ..utils.tolerance import default_tolerance, real_dtype_of

__all__ = ["cg_solve", "cgls_solve", "minres_solve", "shift_invert_operator", "CHECK_EVERY"]

#: iterations between two host reads of a loop's stop condition
CHECK_EVERY = 8


def _real(x: torch.Tensor) -> torch.Tensor:
    return x.real if x.is_complex() else x


def _vdot(a: torch.Tensor, b: torch.Tensor, comm=None) -> torch.Tensor:
    d = torch.vdot(a, b)
    return comm.psum(d) if comm is not None else d


def _masked_loop(cond, step, carry):
    """Run ``carry = step(carry)`` while ``cond(carry)`` holds, as a
    ``lax.while_loop`` does, with the host reading ``cond`` only every
    ``CHECK_EVERY`` steps.  ``step`` returns the updated carry; this keeps
    each field where ``cond`` was false.  ``cond`` holds only while the
    iteration count (field 0 of the carry, advanced by every active step)
    is under the cap, so the loop ends."""
    n_steps = 0
    while True:
        if n_steps % CHECK_EVERY == 0 and not bool(cond(carry)):
            return carry
        active = cond(carry)
        new = step(carry)
        carry = tuple(torch.where(active, a, b) for a, b in zip(new, carry))
        n_steps += 1


@torch.no_grad()
def _cg_loop(op: LinearOperator, b, x0, tol: float, *, max_iters: int, comm=None):
    rdt = real_dtype_of(b.dtype)
    target2 = torch.as_tensor(tol**2, dtype=rdt, device=b.device) * _real(_vdot(b, b, comm))
    r0 = b - op.matvec(x0)
    rs0 = _vdot(r0, r0, comm)
    i0 = torch.zeros((), dtype=torch.int64, device=b.device)

    def cond(c):
        i, _, _, _, rs = c
        # the isfinite guard stops the loop as soon as the recurrence goes
        # non-finite (overflow/NaN operator) instead of iterating garbage
        return (i < max_iters) & (_real(rs) > target2) & torch.isfinite(_real(rs))

    def step(c):
        i, x, r, p, rs = c
        ap = op.matvec(p)
        alpha = rs / _vdot(p, ap, comm)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = _vdot(r, r, comm)
        p = r + (rs_new / rs) * p
        return i + 1, x, r, p, rs_new

    i, x, r, p, rs = _masked_loop(cond, step, (i0, x0, r0, r0, rs0))
    return x, torch.sqrt(rs.abs()), i


@highest_f32_matmul()
def cg_solve(op, b, x0=None, *, tol: float | None = None, max_iters: int = 1000):
    """Solve A x = b for Hermitian positive/negative-definite A.

    Returns (x, residual_norm, iterations) as device tensors."""
    op = aslinearoperator(op)
    if tol is None:
        tol = max(default_tolerance(op.dtype), 1e-14)
    b = torch.as_tensor(b).to(device=op.device, dtype=op.dtype)
    x0 = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0).to(b)
    return _cg_loop(op, b, x0, float(tol), max_iters=int(max_iters))


class _Counted:
    """The operator an inner solve works on, ``A - sigma I``, counting the
    applications of A and of its adjoint into ``stats["matvecs"]``.  Where A
    has no explicit adjoint, each adjoint application is derived by autograd
    and also runs a forward product of A; those are counted apart, in
    ``stats["adjoint_forwards"]``, so that ``matvecs`` stays the reference's
    count."""

    def __init__(self, op: LinearOperator, sigma, stats: dict):
        self.op, self.sigma, self.stats = op, sigma, stats

    def matvec(self, v):
        self.stats["matvecs"] += 1
        return self.op.matvec(v) - self.sigma * v

    def rmatvec(self, v):
        self.stats["matvecs"] += 1
        if not self.op.has_adjoint:
            self.stats["adjoint_forwards"] += 1
        sig = self.sigma.conjugate() if isinstance(self.sigma, complex) else self.sigma
        return self.op.rmatvec(v) - sig * v

    def operator(self) -> LinearOperator:
        """Capturable where A is (the shift is torch ops); its ``stats`` are
        the counts a chunk graph replays with its launches."""
        shifted = LinearOperator(
            lambda s, v: s.matvec(v), self, self.op.shape, self.op.dtype, self.op.device,
            rmatvec_fn=lambda s, v: s.rmatvec(v), capturable=self.op.capturable,
        )
        shifted.stats = self.stats
        return shifted


def _scalar_for(op: LinearOperator, sigma):
    """sigma in the operator's scalar type (the JAX package casts it to
    ``op.dtype``: the imaginary part of a complex shift drops for a real
    operator)."""
    return complex(sigma) if op.dtype.is_complex else float(np.real(sigma))


def _new_stats() -> dict:
    """Counters of a shift-invert operator: applications of the operator
    itself, applications of A and A^H inside them (every one, masked steps
    and residual checks included), inner iterations, fallbacks to the
    second solver, and the extra forward products of A that derived
    adjoints ran (:class:`_Counted`)."""
    return dict(applications=0, matvecs=0, iterations=0, fallbacks=0, adjoint_forwards=0)


def shift_invert_operator(
    op, sigma, *, tol: float = 1e-10, max_iters: int = 2000, solver: str = "cg"
) -> LinearOperator:
    """(A - sigma I)^-1 as a matrix-free operator for shift-invert Lanczos:
    eigenvalues near sigma become dominant, so interior/targeted
    eigenpairs converge in few outer iterations (BASELINE.json config 5).

    The returned operator's eigenvalues are 1/(lambda - sigma); recover
    lambda as sigma + 1/theta.  ``solver="cg"`` converges fastest for a
    definite shift; for interior sigma the indefinite system is detected
    by true residual and re-solved with MINRES, warm-started from the CG
    iterate, so any non-eigenvalue sigma is valid.  ``solver="minres"``
    skips CG and runs MINRES directly.  The operator's ``stats`` dict
    counts what its applications cost (:func:`_new_stats`)."""
    op = aslinearoperator(op)
    if op.shape[0] != op.shape[1]:
        raise EigenexError("shift-invert requires a square operator")
    if solver not in ("cg", "minres"):
        raise EigenexError(f"solver must be 'cg' or 'minres', got {solver!r}")
    stats = _new_stats()
    shifted = _Counted(op, _scalar_for(op, sigma), stats).operator()
    max_iters = int(max_iters)
    tol = float(tol)

    def si_matvec(_, x):
        stats["applications"] += 1
        x0 = torch.zeros_like(x)
        if solver == "minres":
            y, _, it = _minres_loop(shifted, x, x0, tol, max_iters=max_iters)
            stats["iterations"] += int(it)
            return y
        y, _, it = _cg_loop(shifted, x, x0, tol, max_iters=max_iters)
        # CG is only guaranteed for definite (A - sigma I); an interior
        # sigma makes it indefinite and CG can stagnate or diverge
        # SILENTLY, poisoning every outer Ritz value.  Detect by true
        # residual and fall back to MINRES, warm-started from the CG iterate
        # when that is finite.
        rel = float(torch.linalg.vector_norm(x - shifted.matvec(y)) / torch.linalg.vector_norm(x))
        stats["iterations"] += int(it)
        if np.isfinite(rel) and rel <= tol:
            return y
        stats["fallbacks"] += 1
        y_safe = y if bool(torch.isfinite(y).all()) else torch.zeros_like(y)
        y, _, it = _minres_loop(shifted, x, y_safe, tol, max_iters=max_iters)
        stats["iterations"] += int(it)
        return y

    si = LinearOperator(si_matvec, None, op.shape, op.dtype, op.device)
    si.stats = stats
    return si


@torch.no_grad()
def _cgls_loop(op: LinearOperator, b, x0, tol: float, *, max_iters: int, comm=None):
    """CGLS (CG on the normal equations A^H A x = A^H b, Bjorck's stable
    recurrence): the least-squares/indefinite fallback where plain CG
    (indefinite A) or restarted GMRES (stagnation) fail.  The adjoint comes
    from ``op.rmatvec``, derived by autograd when the operator has no
    explicit one.  Returns (x, ||r||, iterations)."""
    rdt = real_dtype_of(b.dtype)
    dev = b.device
    tol_t = torch.as_tensor(tol**2, dtype=rdt, device=dev)
    target2 = tol_t * _real(_vdot(b, b, comm))
    r0 = b - op.matvec(x0)
    s0 = op.rmatvec(r0)
    gamma0 = _real(_vdot(s0, s0, comm))
    # two-sided stop: true residual (consistent systems) OR normal-equation
    # residual ||A^H r|| (least-squares optimum of inconsistent systems,
    # where ||r|| never gets small -- iterating past it makes
    # beta = gamma'/gamma pure noise and DIVERGES the iterate)
    gamma_tgt = tol_t * gamma0
    one = torch.ones((), dtype=rdt, device=dev)

    def cond(c):
        i, _, _, _, gamma, rn2 = c
        return (i < max_iters) & (rn2 > target2) & (gamma > gamma_tgt) & torch.isfinite(rn2)

    def step(c):
        i, x, r, p, gamma, _ = c
        q = op.matvec(p)
        qq = _real(_vdot(q, q, comm))
        alpha = (gamma / torch.where(qq > 0, qq, one)).to(x.dtype)
        x = x + alpha * p
        r = r - alpha * q
        s = op.rmatvec(r)
        gamma_new = _real(_vdot(s, s, comm))
        beta = (gamma_new / torch.where(gamma > 0, gamma, one)).to(x.dtype)
        p = s + beta * p
        return i + 1, x, r, p, gamma_new, _real(_vdot(r, r, comm))

    i0 = torch.zeros((), dtype=torch.int64, device=dev)
    i, x, r, p, gamma, rn2 = _masked_loop(
        cond, step, (i0, x0, r0, s0, gamma0, _real(_vdot(r0, r0, comm))))
    return x, torch.sqrt(rn2.abs()), i


@highest_f32_matmul()
def cgls_solve(op, b, x0=None, *, tol: float | None = None, max_iters: int = 2000):
    """Least-squares solve min ||A x - b|| via CGLS (works for any A,
    including indefinite Hermitian and rectangular operators; takes
    ``op.rmatvec``, derived by autograd when there is no explicit one).

    Returns (x, residual_norm, iterations) as device tensors."""
    op = aslinearoperator(op)
    if tol is None:
        tol = max(default_tolerance(op.dtype), 1e-14)
    b = torch.as_tensor(b).to(device=op.device, dtype=op.dtype)
    if x0 is None:
        x0 = torch.zeros((op.shape[1],), dtype=op.dtype, device=op.device)
    else:
        x0 = torch.as_tensor(x0).to(b)
    return _cgls_loop(op, b, x0, float(tol), max_iters=int(max_iters))


@torch.no_grad()
def _minres_loop(op: LinearOperator, b, x0, tol: float, *, max_iters: int, comm=None):
    """MINRES (Paige & Saunders 1975): minimum-residual Krylov solve for
    HERMITIAN (possibly indefinite) systems -- the inner solver for
    interior shift-invert, converging like kappa where CGLS pays kappa^2.
    Lanczos three-term recurrence + Givens QR of the tridiagonal, all
    short recurrences.  Returns (x, ||r||, iterations)."""
    dt = b.dtype
    rdt = real_dtype_of(dt)
    dev = b.device
    target = torch.as_tensor(tol, dtype=rdt, device=dev) * torch.sqrt(_real(_vdot(b, b, comm)))
    one = torch.ones((), dtype=rdt, device=dev)
    zero = torch.zeros((), dtype=rdt, device=dev)

    r0 = b - op.matvec(x0)
    beta1 = torch.sqrt(_real(_vdot(r0, r0, comm)))
    v = r0 / torch.where(beta1 > 0, beta1, one).to(dt)
    zeros = torch.zeros_like(b)

    # carry: i, x, v_old, v, w_old, w, beta, eta, c_old, c, s_old, s, rnorm
    def cond(c):
        i, rnorm = c[0], c[-1]
        return (i < max_iters) & (rnorm > target) & torch.isfinite(rnorm)

    def step(c):
        i, x, v_old, v, w_old, w, beta, eta, c_old, cc, s_old, s, _ = c
        av = op.matvec(v)
        alpha = _real(_vdot(v, av, comm))  # Hermitian: real diagonal
        r_next = av - alpha.to(dt) * v - beta.to(dt) * v_old
        beta_next = torch.sqrt(_real(_vdot(r_next, r_next, comm)))
        v_next = r_next / torch.where(beta_next > 0, beta_next, one).to(dt)
        # previous two rotations applied to the new tridiagonal column
        delta = cc * alpha - c_old * s * beta
        rho2 = s * alpha + c_old * cc * beta
        rho3 = s_old * beta
        # new rotation annihilating beta_next
        rho1 = torch.sqrt(delta * delta + beta_next * beta_next)
        safe_r1 = torch.where(rho1 > 0, rho1, one)
        c_new = delta / safe_r1
        s_new = beta_next / safe_r1
        w_new = (v - rho3.to(dt) * w_old - rho2.to(dt) * w) / safe_r1.to(dt)
        x = x + (c_new * eta).to(dt) * w_new
        eta_new = -s_new * eta
        # ||r_k|| = |eta_{k+1}| exactly (minimum-residual recursion)
        return (i + 1, x, v, v_next, w, w_new, beta_next, eta_new,
                cc, c_new, s, s_new, eta_new.abs())

    i0 = torch.zeros((), dtype=torch.int64, device=dev)
    init = (i0, x0, zeros, v, zeros, zeros, zero, beta1, one, one, zero, zero, beta1)
    out = _masked_loop(cond, step, init)
    return out[1], out[-1], out[0]


@highest_f32_matmul()
def minres_solve(op, b, x0=None, *, tol: float | None = None, max_iters: int = 2000):
    """Solve A x = b for HERMITIAN A (definite or indefinite) with MINRES.

    Returns (x, residual_norm, iterations) as device tensors."""
    op = aslinearoperator(op)
    if op.shape[0] != op.shape[1]:
        raise EigenexError("MINRES requires a square (Hermitian) operator")
    if tol is None:
        tol = max(default_tolerance(op.dtype), 1e-14)
    b = torch.as_tensor(b).to(device=op.device, dtype=op.dtype)
    x0 = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0).to(b)
    return _minres_loop(op, b, x0, float(tol), max_iters=int(max_iters))
