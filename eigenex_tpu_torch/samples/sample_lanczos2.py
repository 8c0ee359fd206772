"""Fluent-configured Lanczos on a sparse complex-Hermitian operator, with
the convergence log.

Counterpart of ``samples/sample_lanczos2.py`` (reference
sample_lanczos2.cpp:76-86)."""

from __future__ import annotations

import numpy as np

import eigenex_tpu_torch as ext
from eigenex_tpu_torch.utils.device import resolve_device


def main(device=None) -> dict:
    dev = resolve_device(device)
    n = 200
    b = ext.COOBuilder(n, n, np.complex128)
    for i in range(n):
        b.append(i, i, 2.0)
        if i + 1 < n:
            b.append(i, i + 1, -1.0j)   # H[i, i+1] = -i
            b.append(i + 1, i, +1.0j)   # H[i+1, i] = +i  (Hermitian)
    coo = b.build(device=dev)
    op = coo.as_linear_operator()

    lo, hi = coo.estimate_eigenvalue_range()
    print(f"Gershgorin eigenvalue range: [{float(lo):.3f}, {float(hi):.3f}]")

    solver = (
        ext.LanczosEigenSolver(op)
        .set_tolerance(1e-12)                # cf. setTolerance
        .set_min_iterations(10)              # cf. setMinIterations
        .set_max_iterations(ext.UNLIMITED)   # cf. setMaxIterations(unlimited)
        .set_max_subspace(n)
        .set_reorthogonalize_interval(1)     # cf. setReorthogonalizeInterval
        .set_max_eigenvalues(3)              # cf. setMaxEigenvalues
        .set_eigenvalue_shift(0.0)           # cf. setEigenvalueShift
        .set_breakdown_threshold(1e-12)      # cf. setBreakdownThreshold
        .set_check_every(8)
        .set_seed(42)
    )
    res = solver.compute()

    ref = np.linalg.eigvalsh(np.asarray(coo.to_dense()))
    residuals = np.asarray(res.residual_norms(op))
    print("eigenvalues:", res.eigenvalues)
    print("dense oracle:", ref[:3])
    print("residuals:", residuals)
    print("iterations:", res.iterations, "| converged:", res.converged)
    print()
    print("convergence log (cf. sample_lanczos2.cpp:76-86):")
    print(res.trace)
    return dict(range=(float(lo), float(hi)), eigenvalues=np.asarray(res.eigenvalues),
                oracle=ref[:3], residuals=residuals, iterations=int(res.iterations),
                converged=bool(res.converged))


if __name__ == "__main__":
    from ._cli import run

    run(main)
