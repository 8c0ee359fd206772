"""Krylov f(A)|v> and exp(xA)|v> application.

Counterpart of ``eigenex_tpu/solvers/functions.py`` (the reference's
``LanczosFunctionSolver`` lanczos.hpp:938-1002 and
``LanczosExponentialSolver`` lanczos.hpp:1005-1196 with its four
strategies; the Taylor primitive ``OperateAsExp`` util.hpp:305-397):

- f(A)v for Hermitian A by the eigen-expansion of the Lanczos
  tridiagonal, f(A)v ~ ||v|| V_k^T Y f(theta) Y^T e_1, on the port's
  :func:`~eigenex_tpu_torch.solvers.lanczos.lanczos_steps`; the small
  eigenproblem in host f64.
- exp(xA)v by dense eigendecomposition, by that Lanczos expansion, by a
  plain Taylor series, and by a Taylor series with the step split by a
  bound on the spectral radius.

The Taylor loop of the JAX package is a ``lax.while_loop`` that stops
when the running term is negligible.  Here it is the masked loop of
:mod:`eigenex_tpu_torch.solvers.cg`: the host reads the stop test every
``CHECK_EVERY`` = 8 terms, and a term past the stop is computed but not
added (a selection, so it cannot leak into the sum).  The terms summed,
and the result, are the reference's; the operator applications are up to
``CHECK_EVERY - 1`` more.  On a real operator with a complex x the
operator is applied to the real and the imaginary part of each term
apart (the SpMV kernels take f32 vectors): two applications a term.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core.operators import LinearOperator, aslinearoperator
from ..utils.exceptions import LanczosError
from ..utils.precision import highest_f32_matmul
from ..utils.tolerance import default_tolerance
from .cg import _masked_loop
from .lanczos import init_lanczos_state, lanczos_steps, tridiagonal_eigh

__all__ = [
    "lanczos_function_apply",
    "lanczos_expmv",
    "taylor_expmv",
    "taylor_expmv_auto",
    "dense_expmv",
    "expm_multiply",
    "LanczosFunctionSolver",
    "LanczosExponentialSolver",
]


def _python_scalar(x):
    """``x`` (Python, numpy or 0-d tensor) as a Python float or complex, so
    that it multiplies a tensor at the tensor's precision."""
    x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x).item()
    return complex(x) if isinstance(x, complex) else float(x)


def _working_dtype(op_dtype: torch.dtype, complex_values: bool) -> torch.dtype:
    """The operator's precision, complex when ``complex_values``.  A real x
    does not lift an f32 operator's iterates to f64: the SpMV kernels take
    f32 vectors."""
    if not complex_values or op_dtype.is_complex:
        return op_dtype
    return torch.complex128 if op_dtype == torch.float64 else torch.complex64


def _on(op: LinearOperator, v) -> torch.Tensor:
    """``v`` as a tensor on the operator's device (host arrays are moved)."""
    if not isinstance(v, torch.Tensor):
        v = torch.as_tensor(np.asarray(v))
    return v.to(op.device)


@highest_f32_matmul()
@torch.no_grad()
def lanczos_function_apply(
    op,
    v,
    f: Callable[[np.ndarray], np.ndarray],
    num_steps: int = 64,
    *,
    reorthogonalize_interval: int = 1,
) -> torch.Tensor:
    """f(A)|v> for Hermitian A by the Lanczos eigen-expansion
    (cf. LanczosFunctionSolver::solve lanczos.hpp:956-989).

    ``f`` maps a host float64 array of Ritz values to (possibly complex)
    values; the Krylov basis is built on the operator's device."""
    op = aslinearoperator(op)
    v = _on(op, v).to(op.dtype)
    nrm = torch.linalg.vector_norm(v)
    state = init_lanczos_state(op, int(num_steps), v0=v)
    state = lanczos_steps(
        op, state, int(num_steps), reorthogonalize_interval=reorthogonalize_interval
    )
    k = int(state.k)
    if k == 0:
        raise LanczosError("Lanczos produced no steps")
    alpha = state.alpha[:k].double().cpu().numpy()
    beta = state.beta[:k].double().cpu().numpy()
    theta, Y = tridiagonal_eigh(alpha, beta)
    ftheta = np.asarray(f(theta))
    # f(T) e1 = Y f(theta) Y^T e1  (lanczos.hpp:976-988)
    coeff = Y @ (ftheta * np.conj(Y[0, :]))
    out_dtype = _working_dtype(op.dtype, np.iscomplexobj(coeff))
    coeff = torch.as_tensor(coeff).to(device=op.device, dtype=out_dtype)
    return nrm.to(out_dtype) * (state.V[:k].T.to(out_dtype) @ coeff)


def lanczos_expmv(op, v, x=1.0, num_steps: int = 64) -> torch.Tensor:
    """exp(xA)|v> by the Lanczos expansion
    (cf. solveWithLanczos lanczos.hpp:1061-1083)."""
    x = complex(x) if np.iscomplexobj(np.asarray(x)) else float(np.real_if_close(x))
    return lanczos_function_apply(op, v, lambda th: np.exp(x * th), num_steps)


@highest_f32_matmul()
@torch.no_grad()
def dense_expmv(A, v, x=1.0) -> torch.Tensor:
    """exp(xA)|v> by dense Hermitian eigendecomposition
    (cf. solveWithEigens lanczos.hpp:1024-1059)."""
    A = A if isinstance(A, torch.Tensor) else torch.as_tensor(np.asarray(A))
    v = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    v = v.to(A.device)
    w, U = torch.linalg.eigh(A)
    phase = torch.exp(_python_scalar(x) * w)
    dt = torch.promote_types(U.dtype, phase.dtype)
    return (U.to(dt) * phase.to(dt)[None, :]) @ (U.conj().T.to(dt) @ v.to(dt))


@torch.no_grad()
def _taylor_loop(op: LinearOperator, v: torch.Tensor, x, tol: float, max_terms: int):
    """(sum_k (xA)^k v / k!, terms summed), until the running term is
    negligible (cf. OperateAsExp util.hpp:305-397 and
    solveWithTaylorNoDivision lanczos.hpp:1085-1133)."""
    dt = v.dtype
    xs = torch.as_tensor(x, dtype=dt, device=v.device)
    k0 = torch.zeros((), dtype=torch.int64, device=v.device)

    def cond(c):
        # the stop test in f64, as the reference's f64 tol makes it
        k, term, acc = c
        return (k < max_terms) & (torch.linalg.vector_norm(term).double()
                                  > tol * torch.linalg.vector_norm(acc).double())

    def step(c):
        k, term, acc = c
        term = xs * op.matvec(term) / (k + 1).to(dt)
        return k + 1, term, acc + term

    k, _, acc = _masked_loop(cond, step, (k0, v, v))
    return acc, k


def _complex_iterates(base: LinearOperator, dt: torch.dtype) -> LinearOperator:
    """A real operator that takes complex iterates: the real and the
    imaginary part are applied apart."""
    def matvec(p, z):
        return p.matvec(z.real.contiguous()).to(dt) + 1j * p.matvec(z.imag.contiguous()).to(dt)

    return LinearOperator(matvec, base, base.shape, dt, base.device)


def _taylor(op, v, x, tol, max_terms):
    """(exp(xA)v by the Taylor series, terms summed)."""
    op = aslinearoperator(op)
    if tol is None:
        tol = default_tolerance(op.dtype)
    x = _python_scalar(x)
    v = _on(op, v)
    dt = _working_dtype(op.dtype, isinstance(x, complex) or v.is_complex())
    if dt != op.dtype:
        op = _complex_iterates(op, dt)
    return _taylor_loop(op, v.to(dt), x, float(tol), int(max_terms))


@highest_f32_matmul()
def taylor_expmv(op, v, x=1.0, *, tol: float | None = None, max_terms: int = 256):
    """Taylor exp(xA)v without step division."""
    return _taylor(op, v, x, tol, max_terms)[0]


@highest_f32_matmul()
def taylor_expmv_auto(
    op,
    v,
    x=1.0,
    *,
    spectral_bound: float | None = None,
    theta: float = 1.0,
    tol: float | None = None,
    max_terms: int = 64,
):
    """Taylor exp(xA)v with automatic step splitting: x is divided into
    ceil(|x| rho(A) / theta) equal sub-steps so that each series converges
    fast (cf. solveWithTaylorAutoDivision lanczos.hpp:1135-1196).

    ``spectral_bound``: an upper bound on rho(A); if None it is taken from
    the operator's Gershgorin range when the container behind it has one
    (``estimate_eigenvalue_range``: COO, BSR and SymBSR containers, found
    as the operator's params as in the reference), else estimated with a
    short Lanczos run."""
    op = aslinearoperator(op)
    if spectral_bound is None:
        est = getattr(op, "_params", None)
        if hasattr(est, "estimate_eigenvalue_range"):
            lo, hi = est.estimate_eigenvalue_range()
            spectral_bound = float(max(abs(float(lo)), abs(float(hi))))
        else:
            steps = min(20, op.shape[0])
            state = init_lanczos_state(op, steps, v0=_on(op, v).to(op.dtype))
            state = lanczos_steps(op, state, steps)
            k = int(state.k)
            ritz = tridiagonal_eigh(
                state.alpha[:k].double().cpu().numpy(), state.beta[:k].double().cpu().numpy(),
                eigvals_only=True,
            )
            spectral_bound = float(np.max(np.abs(ritz))) * 1.1 + 1e-30
    n_div = max(1, int(np.ceil(abs(complex(x)) * spectral_bound / theta)))
    x_step = x / n_div
    out = _on(op, v)
    for _ in range(n_div):
        out = taylor_expmv(op, out, x_step, tol=tol, max_terms=max_terms)
    return out


def _materialize(op: LinearOperator) -> torch.Tensor:
    return op.matmat(torch.eye(op.shape[1], dtype=op.dtype, device=op.device))


@highest_f32_matmul()
def expm_multiply(op, v, x=1.0, method: str = "auto", **kw):
    """Dispatch to the exp(xA)v strategies (the
    ``LanczosExponentialSolver`` surface, lanczos.hpp:1005-1196):
    "auto"/"lanczos", "taylor", "taylor_auto" or "dense"."""
    if method in ("auto", "lanczos"):
        return lanczos_expmv(op, v, x, **kw)
    if method == "taylor":
        return taylor_expmv(op, v, x, **kw)
    if method == "taylor_auto":
        return taylor_expmv_auto(op, v, x, **kw)
    if method == "dense":
        if isinstance(op, LinearOperator):
            # materialize the matrix through the operator interface
            return dense_expmv(_materialize(op), v, x)
        return dense_expmv(op, v, x)
    raise LanczosError(f"unknown expm method {method!r}")


class LanczosFunctionSolver:
    """Class wrapper for API parity with the reference
    (cf. LanczosFunctionSolver lanczos.hpp:938)."""

    def __init__(self, operator=None, num_steps: int = 64):
        self.operator = operator
        self.num_steps = num_steps

    def solve(self, f, v):
        return lanczos_function_apply(self.operator, v, f, self.num_steps)


class LanczosExponentialSolver:
    """Class wrapper for API parity with the reference
    (cf. LanczosExponentialSolver lanczos.hpp:1005)."""

    def __init__(self, operator=None, num_steps: int = 64):
        self.operator = operator
        self.num_steps = num_steps

    def solve_with_eigens(self, v, x=1.0):
        return dense_expmv(_materialize(aslinearoperator(self.operator)), v, x)

    def solve_with_lanczos(self, v, x=1.0):
        return lanczos_expmv(self.operator, v, x, self.num_steps)

    def solve_with_taylor_no_division(self, v, x=1.0, **kw):
        return taylor_expmv(self.operator, v, x, **kw)

    def solve_with_taylor_auto_division(self, v, x=1.0, **kw):
        return taylor_expmv_auto(self.operator, v, x, **kw)
