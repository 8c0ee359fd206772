"""Plain reference of the 2-D upwind convection-diffusion operator.

On an nx x nx grid, row-major (u = y nx + x): 4 on the diagonal, -1 - c
towards the lower neighbour in x and in y, -1 + c towards the upper one.
It is the Kronecker sum T (+) T of T = tridiag(-1 - c, 2, -1 + c), whose
eigenvalues are 2 + 2 sqrt(1 - c^2) cos(j pi / (nx + 1)), so the
operator's largest eigenvalue is 4 + 4 sqrt(1 - c^2) cos(pi / (nx + 1)).

The operator is far from normal: at nx = 316 its eigenvector matrix is
so ill-conditioned that a pair with a backward error at float32's
rounding lies anywhere in a wide pseudospectrum, and float64 ARPACK
itself misses the closed form.  So ``judge`` holds each returned pair to
its backward error on the operator rebuilt here, and its eigenvalue to
lie at or beyond the closed-form largest magnitude, not to the closed
form itself.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from .precision import round_tf32_np


def operator(params: dict) -> sp.csr_matrix:
    """The stencil as a float64 CSR matrix."""
    nx, c = params["nx"], params["conv"]
    T = sp.diags([np.full(nx - 1, -1.0 - c), np.full(nx, 2.0), np.full(nx - 1, -1.0 + c)],
                 [-1, 0, 1])
    eye = sp.identity(nx)
    return (sp.kron(eye, T) + sp.kron(T, eye)).tocsr()


def dominant_magnitude(params: dict) -> float:
    """|lambda| of the largest eigenvalue, in closed form."""
    nx, c = params["nx"], params["conv"]
    return 4 + 4 * np.sqrt(1 - c * c) * np.cos(np.pi / (nx + 1))


def judge(params: dict, request: dict, answers, device, seed: int):
    """Per answer: ``resid`` = the largest ||A x - lam x|| / (|lam| ||x||)
    over its pairs (float64, complex), and ``shortfall`` = the largest
    1 - |lam| / |lam_max| with lam_max the closed-form dominant eigenvalue.
    Only ``which="LM"`` is judged.  An answer with another number of pairs,
    or with a value that is not finite, reads inf."""
    if request.get("which", "LM") != "LM":
        raise ValueError("the convection-diffusion reference judges which='LM' only")
    k = request["k"]
    A = operator(params)
    n = A.shape[0]
    top = dominant_magnitude(params)
    numbers = {"resid": [], "shortfall": []}
    for lam, X in answers:
        lam = None if lam is None else np.asarray(lam, np.complex128)
        X = None if X is None else np.asarray(X)
        if (lam is None or X is None or lam.shape != (k,) or X.shape != (n, k)
                or not np.isfinite(lam).all() or not np.isfinite(X).all()):
            numbers["resid"].append(float("inf"))
            numbers["shortfall"].append(float("inf"))
            continue
        X = X.astype(np.complex128)
        R = A @ X - X * lam[None, :]
        rel = np.linalg.norm(R, axis=0) / (np.abs(lam) * np.linalg.norm(X, axis=0))
        numbers["resid"].append(float(rel.max()))
        numbers["shortfall"].append(float(np.max(1 - np.abs(lam) / top)))
    return numbers, {"closed_form_dominant": top}


def solve(params: dict, request: dict, v0, precision: str = "float64", maxiter: int = 20000):
    """The request solved by SciPy's ARPACK (``eigs``) from the start vector
    ``v0``.  ``precision`` "tf32" is single-precision ARPACK whose products
    take TF32 inputs (the operator's values and the vector) and sum in
    float32.  Returns (eigenvalues, eigenvectors)."""
    A = operator(params)
    n = A.shape[0]
    k, which, tol = request["k"], request.get("which", "LM"), request["tol"]
    ncv = min(request.get("max_subspace") or max(4 * k + 24, 48), n - 1)
    v0 = np.asarray(v0, np.float64)
    if precision == "float64":
        return spla.eigs(A, k=k, which=which, tol=tol, ncv=ncv, v0=v0, maxiter=maxiter)
    if precision != "tf32":
        raise ValueError(f"precision must be float64 or tf32, got {precision!r}")
    A32 = A.astype(np.float32)
    A32.data = round_tf32_np(A32.data)
    op = spla.LinearOperator(
        (n, n), matvec=lambda x: A32 @ round_tf32_np(np.asarray(x, np.float32).ravel()),
        dtype=np.float32)
    return spla.eigs(op, k=k, which=which, tol=tol, ncv=ncv, v0=v0.astype(np.float32),
                     maxiter=maxiter)


def control_solver(params: dict, request: dict, device):
    """The reference put in the solver's place one precision below the
    solver's float32 with TF32 off (``solve`` in "tf32"), on the host.
    Returns ``solve(v0) -> (eigenvalues, eigenvectors)``."""
    return lambda v0: solve(params, request, v0, "tf32")
