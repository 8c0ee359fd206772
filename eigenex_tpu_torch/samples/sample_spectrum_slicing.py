"""Spectrum slicing: a KPM eigenvalue count and density of states, then the
Chebyshev window filter for the pairs inside one window, alone and on a
mesh.

Counterpart of ``samples/sample_spectrum_slicing.py``.  The mesh is eight
shards of the one device (``make_mesh(devices=[device] * 8)``), in the
halo mode.  The KPM estimates are stochastic: the port draws its probes
from a seeded ``torch.Generator``, the reference from ``jax.random``."""

from __future__ import annotations

import numpy as np

from eigenex_tpu_torch import eigsh_window, make_mesh
from eigenex_tpu_torch.solvers.kpm import eigenvalue_count, spectral_density
from eigenex_tpu_torch.sparse.bsr import bsr_from_dense
from eigenex_tpu_torch.utils.device import resolve_device

MESH_SHARDS = 8


def main(device=None) -> dict:
    dev = resolve_device(device)
    n = 400
    A = 2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    bsr = bsr_from_dense(A, (4, 4), device=dev)
    exact = 2 - 2 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1))

    lo, hi = map(float, bsr.estimate_eigenvalue_range())
    print(f"Gershgorin bounds: [{lo:.3f}, {hi:.3f}]  (true spectrum in (0, 4))")

    window = (1.9, 2.1)
    count = float(eigenvalue_count(bsr, window, n_moments=200, n_probes=16))
    true_count = int(((exact >= window[0]) & (exact <= window[1])).sum())
    print(f"KPM count in {window}: {count:.1f}  (true: {true_count})")

    lam_grid, rho = spectral_density(bsr, n_moments=160)
    lam_grid, rho = np.asarray(lam_grid), np.asarray(rho)
    dos_integral = float(np.trapezoid(rho, lam_grid))
    print(f"DOS integral ~ n: {dos_integral:.1f} (n = {n})")

    res = eigsh_window(bsr, window, block_size=true_count + 4, degree=80, tol=1e-11)
    want = exact[(exact >= window[0]) & (exact <= window[1])]
    err = float(np.max(np.abs(np.sort(res.eigenvalues) - want)))
    print(f"eigsh_window: {res.eigenvalues.size} pairs, max |λ−exact| = {err:.2e}")

    # the SAME call on a mesh: the filter's SpMM chain runs row-partitioned;
    # results match the single-device run
    mesh = make_mesh(devices=[dev] * MESH_SHARDS)
    res_m = eigsh_window(bsr, window, block_size=true_count + 4, degree=80, tol=1e-11,
                         mesh=mesh, matvec_mode="halo")
    derr = float(np.max(np.abs(np.sort(res_m.eigenvalues) - np.sort(res.eigenvalues))))
    print(f"mesh ({MESH_SHARDS} devices, halo SpMM): same pairs to {derr:.2e}")

    assert err < 1e-9
    print("sample_spectrum_slicing OK")
    return dict(bounds=(lo, hi), count=count, true_count=true_count, dos_integral=dos_integral,
                eigenvalues=np.sort(np.asarray(res.eigenvalues)), err=err,
                mesh_eigenvalues=np.sort(np.asarray(res_m.eigenvalues)), mesh_delta=derr)


if __name__ == "__main__":
    from ._cli import run

    run(main)
