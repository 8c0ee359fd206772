"""Plain reference of the shift-invert request on the convection-diffusion
stencil: the k pairs of A nearest a shift sigma.

The operator is the one of ``convection_diffusion.py``, the Kronecker sum
T (+) T of T = tridiag(-1 - c, 2, -1 + c), so its eigenvalues are
4 + 2 sqrt(1 - c^2) (cos(i pi / (nx + 1)) + cos(j pi / (nx + 1))) for
i, j = 1 .. nx, all real.  ``solve`` applies (A - sigma I)^-1 through an
exact float64 LU factorisation of the dense A - sigma I and lets SciPy's
ARPACK find the k largest theta = 1 / (lambda - sigma): the pairs nearest
sigma.

``judge`` holds answers as ``convection_diffusion.judge`` does, and for the
same reason: the operator is far from normal (its eigenvector matrix has
a condition near ((1 + c) / (1 - c))^(nx - 1)), so at nx = 128 a pair whose
backward error is at float32's rounding lies anywhere in a wide
pseudospectrum, and float64 on an exact LU misses the closed form too.
Each pair is held to its backward error on the float64 stencil
(``resid``) and to lie at or beyond the closed-form top (``shortfall``):
with sigma above the spectrum the pairs nearest it are the dominant ones,
so a pair from elsewhere in the spectrum reads high.
"""

from __future__ import annotations

import contextlib

import numpy as np
import scipy.sparse.linalg as spla
import torch

from . import convection_diffusion
from .convection_diffusion import dominant_magnitude, operator
from .precision import round_tf32_np

#: GMRES(m) and its cycle cap in the control, the measured route's defaults
RESTART, CYCLES = 48, 24


@contextlib.contextmanager
def _tf32_off():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def eigenvalues(params: dict) -> np.ndarray:
    """Every eigenvalue of the stencil in closed form (with multiplicity),
    descending."""
    nx, c = params["nx"], params["conv"]
    t = 2 + 2 * np.sqrt(1 - c * c) * np.cos(np.arange(1, nx + 1) * np.pi / (nx + 1))
    return np.sort((t[:, None] + t[None, :]).ravel())[::-1]


def _check(params: dict, request: dict) -> None:
    if request.get("which", "LM") != "LM" or request.get("sigma") is None:
        raise ValueError("the shift-invert reference judges which='LM' with a sigma only")
    if not request["sigma"] > dominant_magnitude(params):
        raise ValueError("sigma must lie above the spectrum: the pairs nearest it are then "
                         "the dominant ones, which shortfall reads")


def judge(params: dict, request: dict, answers, device, seed: int):
    """Per answer, ``resid`` and ``shortfall`` of ``convection_diffusion.judge``;
    sigma must lie above the closed-form top."""
    _check(params, request)
    numbers, notes = convection_diffusion.judge(params, request, answers, device, seed)
    return numbers, {**notes, "sigma": request["sigma"]}


def _ncv(request: dict, n: int) -> int:
    k = request["k"]
    return min(request.get("max_subspace") or max(4 * k + 24, 48), n - 1)


def solve(params: dict, request: dict, v0, device="cpu"):
    """The k pairs nearest ``request["sigma"]`` from the start vector ``v0``:
    ARPACK on (A - sigma I)^-1, applied by ``torch.linalg.lu_solve`` on an
    LU factorisation of the dense float64 A - sigma I on ``device``.
    Returns (eigenvalues, eigenvectors), host arrays, nearest first."""
    A = operator(params)
    n = A.shape[0]
    sigma = float(request["sigma"])
    with _tf32_off():
        shifted = torch.as_tensor(A.toarray(), dtype=torch.float64, device=device)
        shifted.diagonal().sub_(sigma)
        LU, pivots = torch.linalg.lu_factor(shifted)
        del shifted

        def apply(x):
            b = torch.as_tensor(np.asarray(x, np.float64).reshape(n, 1), device=device)
            return torch.linalg.lu_solve(LU, pivots, b).cpu().numpy().ravel()

        op = spla.LinearOperator((n, n), matvec=apply, dtype=np.float64)
        theta, X = spla.eigs(op, k=request["k"], which="LM", tol=request["tol"],
                             ncv=_ncv(request, n), v0=np.asarray(v0, np.float64))
    order = np.argsort(-np.abs(theta), kind="stable")
    return sigma + 1 / theta[order], X[:, order]


def control_solver(params: dict, request: dict, device):
    """The request solved one precision below the measured solver's float32
    with TF32 off, on the host: ARPACK in single precision on (A - sigma I)^-1
    applied by GMRES(48), at most 24 cycles, to the request's ``inner_tol``,
    in float32, whose products take TF32 inputs (the operator's values and
    the vector) and sum in float32.  Returns ``solve(v0) -> (eigenvalues,
    eigenvectors)``."""
    _check(params, request)
    A32 = operator(params).astype(np.float32)
    A32.data = round_tf32_np(A32.data)
    n = A32.shape[0]
    sigma = np.float32(request["sigma"])

    def shifted(x):
        x = np.asarray(x, np.float32).ravel()
        return A32 @ round_tf32_np(x) - sigma * x

    shifted_op = spla.LinearOperator((n, n), matvec=shifted, dtype=np.float32)

    def apply(x):
        y, _ = spla.gmres(shifted_op, np.asarray(x, np.float32).ravel(),
                          rtol=request["inner_tol"], atol=0.0, restart=RESTART, maxiter=CYCLES)
        return y.astype(np.float32)

    si = spla.LinearOperator((n, n), matvec=apply, dtype=np.float32)

    def solve_control(v0):
        theta, X = spla.eigs(si, k=request["k"], which="LM", tol=request["tol"],
                             ncv=_ncv(request, n), v0=np.asarray(v0, np.float32))
        order = np.argsort(-np.abs(theta), kind="stable")
        return np.complex128(sigma) + 1 / theta[order].astype(np.complex128), X[:, order]

    return solve_control
