"""Arnoldi on a random nonsymmetric matrix, verifying ||A P - P D|| ~ 0.

Counterpart of ``samples/sample_arnoldi.py`` (reference
sample_arnoldi.cpp:42-52).  The reference draws A from ``jax.random``; here
it comes from a seeded ``torch.Generator``, or from the caller (``A=``)."""

from __future__ import annotations

import numpy as np
import torch

import eigenex_tpu_torch as ext
from eigenex_tpu_torch.utils.device import resolve_device
from eigenex_tpu_torch.utils.prng import make_generator


def main(device=None, A=None) -> dict:
    dev = resolve_device(device)
    n = 50
    if A is None:
        A = ext.random_matrix(make_generator(0), n, n, torch.float64, device=dev)
    A = torch.as_tensor(np.asarray(A) if not isinstance(A, torch.Tensor) else A).to(dev)
    op = ext.aslinearoperator(A)

    res = ext.ArnoldiEigenSolver(
        op, ext.ArnoldiOptions(max_eigenvalues=5, tolerance=1e-12, max_subspace=n)
    ).compute()

    print("dominant eigenvalues (|λ| desc):")
    for lam in res.eigenvalues:
        print(f"  {lam:.10f}  |λ| = {abs(lam):.10f}")

    # the acceptance identity of the reference sample, combined on the host
    P = np.asarray(res.eigenvectors.cpu() if isinstance(res.eigenvectors, torch.Tensor)
                   else res.eigenvectors)
    D = np.asarray(res.eigenvalues)
    AP = A.cpu().numpy() @ P
    identity = float(np.linalg.norm(AP - P * D[None, :]))
    residuals = np.asarray(res.residual_norms(op))
    print("‖A·P − P·D‖ =", identity)
    print("residuals:", residuals)
    return dict(eigenvalues=D, identity=identity, residuals=residuals)


if __name__ == "__main__":
    from ._cli import run

    run(main)
