"""Smallest Lanczos example: 3x3 dense matrix via a matmul lambda.

Counterpart of ``samples/sample_lanczos1.py`` (reference
sample_lanczos1.cpp:13-41: a 3x3 matrix with known spectrum, the operator
given as a bare mat-mul function)."""

from __future__ import annotations

import numpy as np
import torch

import eigenex_tpu_torch as ext
from eigenex_tpu_torch.utils.device import resolve_device


def main(device=None) -> dict:
    dev = resolve_device(device)
    A = torch.tensor([[2.0, -1.0, 0.0], [-1.0, 2.0, -1.0], [0.0, -1.0, 2.0]],
                     dtype=torch.float64, device=dev)

    # matrix-free: the solver only ever sees the callable (cf. MatMulFunction)
    op = ext.aslinearoperator(lambda x: A @ x, shape=(3, 3), dtype=A.dtype, device=dev)

    solver = ext.LanczosEigenSolver(op, ext.LanczosOptions(max_eigenvalues=3, max_subspace=3))
    res = solver.compute()

    exact = np.array([2 - np.sqrt(2), 2.0, 2 + np.sqrt(2)])
    vectors = np.asarray(res.eigenvectors.cpu() if isinstance(res.eigenvectors, torch.Tensor)
                         else res.eigenvectors)
    print("eigenvalues:", res.eigenvalues)
    print("exact      :", exact)
    print("eigenvectors (columns):")
    print(vectors)
    print("termination:", res.termination)
    return dict(eigenvalues=np.asarray(res.eigenvalues), exact=exact, eigenvectors=vectors,
                termination=str(res.termination))


if __name__ == "__main__":
    from ._cli import run

    run(main)
