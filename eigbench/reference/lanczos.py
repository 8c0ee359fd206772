"""A plain Lanczos iteration with full reorthogonalisation, in PyTorch.

No restart: the basis grows until the wanted Ritz values' residual
estimates meet the tolerance.  Each new vector is orthogonalised twice
against the whole basis (classical Gram-Schmidt, twice), so no ghost
copies appear.  In float64 it gives the reference eigenvalues of a
symmetric operator; with ``rounding`` it runs in a lower precision, the
control of the benchmark's comparison.
"""

from __future__ import annotations

import numpy as np
import torch


def start_vector(n: int, seed: int) -> np.ndarray:
    """A normal start vector drawn from ``seed`` (any whole number)."""
    return np.random.default_rng(seed & (2**64 - 1)).standard_normal(n)


def lanczos(matvec, n: int, k: int, *, which: str = "SA", tol: float, max_steps: int,
            seed: int, device, dtype=torch.float64, rounding=None, check_every: int = 10,
            v0=None):
    """The k lowest (``which="SA"``) or highest (``"LA"``) Ritz pairs of the
    symmetric operator ``matvec``.  Returns (eigenvalues ascending as a host
    float64 array, eigenvectors (n, k) on ``device``, steps taken).
    The start vector is ``v0``, or one drawn from ``seed``.

    ``rounding``: a function applied to every input of every product (the
    operator's and the orthogonalisation's) -- the lower-precision control.
    The small tridiagonal problem is solved in float64 on the host, as the
    measured solvers do."""
    if which not in ("SA", "LA"):
        raise ValueError(f"which must be SA or LA, got {which!r}")
    r = rounding or (lambda t: t)
    max_steps = min(max_steps, n)
    cap = min(max_steps + 1, 256)
    basis = torch.empty((cap, n), dtype=dtype, device=device)
    q = torch.as_tensor(start_vector(n, seed) if v0 is None else v0, dtype=dtype, device=device)
    basis[0] = r(q / torch.linalg.vector_norm(q))
    alphas: list[float] = []
    betas: list[float] = []
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for j in range(max_steps):
            w = matvec(basis[j])
            V = basis[: j + 1]
            alpha = 0.0
            for _ in range(2):
                h = V @ r(w)
                w = w - V.T @ r(h)
                alpha += float(h[j])
            beta = float(torch.linalg.vector_norm(w))
            alphas.append(alpha)
            steps = j + 1
            if steps % check_every == 0 or steps == max_steps or beta <= 1e-14 * max(map(abs, alphas)):
                theta, S = _tridiagonal_eigh(alphas, betas)
                pick = np.arange(k) if which == "SA" else np.arange(steps - k, steps)
                pick = pick[(pick >= 0) & (pick < steps)]
                estimates = beta * np.abs(S[-1, pick])
                if (np.all(estimates <= tol * np.abs(theta[pick])) or steps == max_steps
                        or beta <= 1e-14 * max(map(abs, alphas))):
                    Sk = torch.as_tensor(S[:, pick], dtype=dtype, device=device)
                    X = V.T @ r(Sk)
                    return theta[pick], X, steps
            betas.append(beta)
            if steps == basis.shape[0]:
                grown = torch.empty((min(2 * steps, max_steps + 1), n), dtype=dtype, device=device)
                grown[:steps] = basis
                basis = grown
            basis[steps] = r(w / beta)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    raise AssertionError("unreachable")


def _tridiagonal_eigh(alphas, betas):
    m = len(alphas)
    T = np.diag(np.asarray(alphas, np.float64))
    if m > 1:
        off = np.asarray(betas[: m - 1], np.float64)
        T += np.diag(off, 1) + np.diag(off, -1)
    return np.linalg.eigh(T)
