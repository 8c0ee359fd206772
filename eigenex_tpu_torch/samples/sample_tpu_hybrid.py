"""The hybrid pipeline: iterate in f32 on the card, refine in f64 on the host.

Counterpart of ``samples/sample_tpu_hybrid.py``, whose name it keeps so the
two are found together: the reference iterates in f32 on a TPU; this one
iterates in f32 on the CUDA card (or the CPU when asked), then polishes
the Ritz pairs against the f64 host operator by a Rayleigh quotient and by
shifted inverse iteration, to 1e-10-grade eigenvalues."""

from __future__ import annotations

import time

import numpy as np
import torch

import eigenex_tpu_torch as ext
from eigenex_tpu_torch.solvers.refine import inverse_iteration_refine, rayleigh_refine
from eigenex_tpu_torch.utils.device import resolve_device


def main(device=None) -> dict:
    dev = resolve_device(device)
    n = 4096
    print(f"building sparse symmetric operator (n={n}) ...")
    rng = np.random.default_rng(0)
    # banded symmetric: diagonal + a few off-diagonals
    b = ext.COOBuilder(n, n, np.float64)
    diag = rng.standard_normal(n) + 4.0
    for i in range(n):
        b.append(i, i, diag[i])
    for off in (1, 7, 64):
        vals = rng.standard_normal(n - off) * 0.5
        for i in range(n - off):
            b.append(i, i + off, vals[i])
            b.append(i + off, i, vals[i])
    # host-resident f64 triplets for the refinement
    coo64 = b.build(device="cpu")

    coo32 = ext.COOMatrix(coo64.row.to(dev), coo64.col.to(dev),
                          coo64.val.to(device=dev, dtype=torch.float32), coo64.shape)
    op32 = coo32.as_linear_operator()

    print(f"f32 Lanczos on {dev} ...")
    t0 = time.time()
    res = ext.LanczosEigenSolver(
        op32,
        ext.LanczosOptions(max_eigenvalues=4, tolerance=1e-8, max_subspace=220, seed=0),
    ).compute()
    t_iter = time.time() - t0
    print(f"  {res.iterations} iterations in {t_iter:.1f}s -> f32 eigenvalues {res.eigenvalues}")

    print("host f64 refinement ...")
    t0 = time.time()
    lam_r, resid_r = rayleigh_refine(coo64, res.eigenvectors)
    lam_ii, X, resid_ii = inverse_iteration_refine(coo64, res.eigenvectors)
    t_ref = time.time() - t0

    ref = np.sort(np.linalg.eigvalsh(np.asarray(coo64.to_dense())))[:4]
    lam_r, lam_ii = np.asarray(lam_r), np.asarray(lam_ii)
    print(f"  refinement took {t_ref:.1f}s")
    print(f"  dense f64 oracle        : {ref}")
    print(f"  |err| f32 Lanczos       : {np.abs(np.asarray(res.eigenvalues) - ref)}")
    print(f"  |err| Rayleigh refine   : {np.abs(lam_r - ref)}")
    print(f"  |err| inverse iteration : {np.abs(lam_ii - ref)}  (residuals {resid_ii})")
    assert np.abs(lam_ii - ref).max() < 1e-10, "hybrid pipeline must reach 1e-10"
    print(f"PASS: 1e-10-grade eigenvalues from f32 iteration on {dev} + f64 host polish")
    return dict(f32_eigenvalues=np.asarray(res.eigenvalues), rayleigh=lam_r,
                inverse_iteration=lam_ii, oracle=ref, iterations=int(res.iterations),
                residuals=np.asarray(resid_ii))


if __name__ == "__main__":
    from ._cli import run

    run(main)
