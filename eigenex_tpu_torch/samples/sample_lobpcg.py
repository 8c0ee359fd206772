"""LOBPCG: what a preconditioner buys, and the generalized pencil K x = λ M x.

Counterpart of ``samples/sample_lobpcg.py``."""

from __future__ import annotations

import numpy as np
import torch

import eigenex_tpu_torch as ext
from eigenex_tpu_torch.utils.device import resolve_device


def main(device=None) -> dict:
    dev = resolve_device(device)

    # -- 1. preconditioning pays --------------------------------------------
    n, k = 500, 3
    rng = np.random.default_rng(0)
    d = np.logspace(0, 5, n)
    A = np.diag(d) + 1e-3 * (lambda m: (m + m.T) / 2)(rng.standard_normal((n, n)))
    coo = ext.coo_from_dense(A, device=dev)
    At = torch.as_tensor(A, device=dev)

    plain = ext.lobpcg(At, k, tol=1e-10, max_iterations=500, seed=1)
    prec = ext.lobpcg(At, k, preconditioner=ext.jacobi_preconditioner(coo),
                      tol=1e-10, max_iterations=500, seed=1)
    ref = np.linalg.eigvalsh(A)[:k]
    print(f"plain:          {plain.iterations:4d} iterations, converged={plain.converged}")
    print(f"preconditioned: {prec.iterations:4d} iterations, converged={prec.converged}")
    print(f"eigenvalues: {prec.eigenvalues}")
    assert prec.converged and np.allclose(prec.eigenvalues, ref, atol=1e-6)
    assert (not plain.converged) or prec.iterations < plain.iterations

    # -- 2. generalized pencil K x = λ M x (P1 finite elements) ---------------
    # K = (1/h) tridiag(-1, 2, -1),  M = (h/6) tridiag(1, 4, 1); eigenvalues
    # λ_j = (6/h²)(1 − cos jπh)/(2 + cos jπh), the FEM approximation of (jπ)².
    ne = 200
    h = 1.0 / ne
    m_int = ne - 1
    K = (np.diag(2 * np.ones(m_int)) - np.diag(np.ones(m_int - 1), 1)
         - np.diag(np.ones(m_int - 1), -1)) / h
    M = (np.diag(4 * np.ones(m_int)) + np.diag(np.ones(m_int - 1), 1)
         + np.diag(np.ones(m_int - 1), -1)) * h / 6

    res = ext.eigsh(torch.as_tensor(K, device=dev), 4, M=torch.as_tensor(M, device=dev),
                    tol=1e-12, max_iterations=300)
    j = np.arange(1, 5)
    lam_exact = 6 / h**2 * (1 - np.cos(j * np.pi * h)) / (2 + np.cos(j * np.pi * h))
    print(f"FEM pencil eigenvalues: {res.eigenvalues}")
    print(f"closed form:            {lam_exact}")
    print(f"(continuum (jπ)²:       {(j * np.pi) ** 2})")
    assert np.allclose(res.eigenvalues, lam_exact, rtol=1e-9)

    # B-orthonormality of the returned block: Xᵀ M X = I
    X = res.eigenvectors
    X = X.cpu().numpy() if isinstance(X, torch.Tensor) else np.asarray(X)
    assert np.allclose(X.T @ M @ X, np.eye(4), atol=1e-8)
    print("sample_lobpcg OK")
    return dict(plain_iterations=int(plain.iterations), plain_converged=bool(plain.converged),
                prec_iterations=int(prec.iterations), prec_converged=bool(prec.converged),
                prec_eigenvalues=np.asarray(prec.eigenvalues), oracle=ref,
                pencil_eigenvalues=np.asarray(res.eigenvalues), closed_form=lam_exact)


if __name__ == "__main__":
    from ._cli import run

    run(main)
