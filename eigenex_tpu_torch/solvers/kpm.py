"""Kernel polynomial method (KPM): stochastic spectral density, counts,
and whole-interval eigensolving.

Counterpart of ``eigenex_tpu/solvers/kpm.py``.  KPM estimates GLOBAL
spectral structure of a Hermitian operator from products alone:

- Chebyshev moments mu_k = tr T_k(t(A)) by Hutchinson stochastic trace
  estimation -- one three-term SpMM recurrence over a block of random
  probes (``op.matmat`` per degree, the SpMM kernel), with the moments
  kept on the device until the loop has ended;
- Jackson-damped moment summation gives the density of states (DOS)
  and eigenvalue COUNTS per interval (``eigenvalue_count``);
- :func:`eigsh_range` combines the two: estimate counts, partition
  [a, b] into slices each holding <~ block_size eigenvalues, and run the
  Chebyshev bandpass solver (:mod:`eigenex_tpu_torch.solvers.chebyshev`)
  per slice -- every eigenpair in an interval, with zero linear solves.

Probes are drawn from a ``torch.Generator``, so the moments of the two
packages agree in distribution, not in value; :func:`_moment_recurrence`
takes the probe block and is what the parity test compares.  ``mesh=``
runs the moment recurrence and every slice's filter row-partitioned over
a device mesh (block-sparse operands), with probes supported on the
original rows.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from ..core.operators import LinearOperator
from ..utils.exceptions import LanczosError
from ..utils.precision import highest_f32_matmul
from ..utils.prng import make_generator, random_matrix
from ..utils.tolerance import real_dtype_of
from ..utils.trace import ConvergenceTrace
from .chebyshev import _mapped_apply, _power_probe_norm, as_filter_operator, eigsh_window
from .lanczos import LanczosResult

__all__ = [
    "chebyshev_moments",
    "spectral_density",
    "eigenvalue_count",
    "eigsh_range",
]


@torch.no_grad()
def _moment_recurrence(op: LinearOperator, Z, lam_min, lam_max, n_norm, *, n_moments: int):
    """Hutchinson Chebyshev moments: mu_k = E[z^H T_k(t(A)) z] over the
    probe block Z (n, p), with t mapping [lam_min, lam_max] -> [-1, 1].
    One loop, two carried blocks -- the KPM inner loop.  Returns the
    (n_moments,) moments as a tensor on the operator's device.

    ``n_norm``: per-state normalization length.  On a padded operand
    this is the ORIGINAL n -- probes are zero on the padding rows, so
    z^H T_k z is exactly the original operator's trace estimate and mu_0
    stays 1."""
    rdt = real_dtype_of(Z.dtype)
    t_apply = _mapped_apply(op, lam_min, lam_max, Z.dtype)
    Zc = Z.conj()

    def probe_mean(V):
        # mean over probes of Re<z_i, v_i> / n: with unit-modulus probe
        # entries E[z^H T_k z] = tr T_k, so this estimates tr T_k / n
        # (mu_0 = 1 exactly)
        s = (Zc * V).sum(dim=0)
        return ((s.real if s.is_complex() else s).mean() / n_norm).to(rdt)

    tkm1, tk = Z, t_apply(Z)
    mu = [probe_mean(tkm1), probe_mean(tk)]
    for _ in range(2, n_moments):
        tkm1, tk = tk, 2.0 * t_apply(tk) - tkm1
        mu.append(probe_mean(tk))
    return torch.stack(mu[:n_moments])


def _jackson(M: int) -> np.ndarray:
    k = np.arange(M)
    return (
        (M - k + 1) * np.cos(np.pi * k / (M + 1))
        + np.sin(np.pi * k / (M + 1)) / np.tan(np.pi / (M + 1))
    ) / (M + 1)


def _bounds_of(op, A, spectral_bounds, seed):
    if spectral_bounds is not None:
        return float(spectral_bounds[0]), float(spectral_bounds[1])
    for holder in (getattr(op, "_params", None), A):
        if holder is not None and hasattr(holder, "estimate_eigenvalue_range"):
            lo, hi = holder.estimate_eigenvalue_range()
            return float(lo), float(hi)
    _, nrm = _power_probe_norm(op, seed + 11)
    return -1.05 * nrm, 1.05 * nrm


@highest_f32_matmul()
def chebyshev_moments(
    A,
    n_moments: int = 128,
    *,
    n_probes: int = 16,
    spectral_bounds: tuple[float, float] | None = None,
    seed: int = 0,
    mesh=None,
    matvec_mode: str = "allgather",
    probe_rows: int | None = None,
    device=None,
):
    """(mu (n_moments,), (lambda_min, lambda_max)) -- Jackson-undamped
    Hutchinson Chebyshev moments of the spectral measure of a Hermitian
    operator, normalized per state (mu_0 ~ 1).

    ``probe_rows``: caller-declared probe support (e.g. an
    AcceleratedOperator's unpadded working rows), so that pad rows stay
    out of the trace.  ``device`` places a host operand (the card unless
    told otherwise).  ``mesh``: run the moment SpMM recurrence
    row-partitioned over a device mesh (block-sparse operands;
    ``matvec_mode`` as in the distributed drivers); probes are supported
    on the ORIGINAL rows, so padding added for the mesh never enters the
    trace estimate."""
    n_true = None
    if mesh is not None:
        from .chebyshev import mesh_filter_operand

        op, n_true, _, spectral_bounds = mesh_filter_operand(
            A, mesh, matvec_mode, spectral_bounds, seed)
    else:
        op = as_filter_operator(A, device)
    if op.shape[0] != op.shape[1]:
        raise LanczosError("KPM requires a square operator")
    lo, hi = _bounds_of(op, A, spectral_bounds, seed)
    span = hi - lo
    lo_m, hi_m = lo - 0.005 * span, hi + 0.005 * span
    n_rows = op.shape[0] if n_true is None else n_true
    if probe_rows is not None:
        n_rows = min(n_rows, int(probe_rows))
    Z = random_matrix(make_generator(seed), n_probes, n_rows, op.dtype, device=op.device).T
    # Rademacher probes have lower Hutchinson variance than Gaussian for
    # real dtypes; keep Gaussian phases for complex (already uniform)
    Z = Z / Z.abs() if Z.is_complex() else torch.sign(Z)
    if n_rows != op.shape[0]:  # zero probe rows on the (mesh) padding
        padded = torch.zeros((op.shape[0], n_probes), dtype=Z.dtype, device=op.device)
        padded[:n_rows] = Z
        Z = padded
    mu = _moment_recurrence(op, Z, lo_m, hi_m, float(n_rows), n_moments=n_moments)
    return mu.double().cpu().numpy(), (lo_m, hi_m)


@highest_f32_matmul()
def spectral_density(
    A,
    n_moments: int = 128,
    *,
    n_probes: int = 16,
    grid: int = 400,
    spectral_bounds: tuple[float, float] | None = None,
    seed: int = 0,
    mesh=None,
    matvec_mode: str = "allgather",
    device=None,
):
    """(lambda grid, DOS estimate rho(lambda)) with integral ~ n -- the
    Jackson-damped KPM density of states."""
    mu, (lo, hi) = chebyshev_moments(
        A, n_moments, n_probes=n_probes, spectral_bounds=spectral_bounds, seed=seed,
        mesh=mesh, matvec_mode=matvec_mode, device=device,
    )
    n = A.shape[0] if hasattr(A, "shape") else as_filter_operator(A, device).shape[0]
    g = _jackson(n_moments)
    t = np.cos(np.pi * (np.arange(grid) + 0.5) / grid)[::-1]  # Chebyshev nodes
    Tk = np.cos(np.arange(n_moments)[None, :] * np.arccos(t)[:, None])
    w = (mu * g) * np.r_[1.0, 2.0 * np.ones(n_moments - 1)]
    rho_t = (Tk @ w) / (np.pi * np.sqrt(1.0 - t**2))
    ctr, ext = (hi + lo) / 2.0, (hi - lo) / 2.0
    lam_grid = ctr + ext * t
    return lam_grid, n * rho_t / ext


@highest_f32_matmul()
def eigenvalue_count(
    A,
    interval: tuple[float, float],
    n_moments: int = 160,
    *,
    n_probes: int = 16,
    spectral_bounds: tuple[float, float] | None = None,
    seed: int = 0,
    mesh=None,
    matvec_mode: str = "allgather",
    device=None,
    _moments=None,
) -> float:
    """Estimated number of eigenvalues in ``interval`` -- the Jackson-
    damped KPM estimate of tr 1_[a,b](A); error scales like
    O(n/(n_moments sqrt(n_probes))) plus the filter transition width."""
    n = A.shape[0] if hasattr(A, "shape") else as_filter_operator(A, device).shape[0]
    if _moments is not None:
        mu, (lo, hi) = _moments
    else:
        mu, (lo, hi) = chebyshev_moments(
            A, n_moments, n_probes=n_probes, spectral_bounds=spectral_bounds, seed=seed,
            mesh=mesh, matvec_mode=matvec_mode, device=device,
        )
    n_moments = mu.shape[0]
    ctr, ext = (hi + lo) / 2.0, (hi - lo) / 2.0
    a = np.clip((float(interval[0]) - ctr) / ext, -1.0, 1.0)
    b = np.clip((float(interval[1]) - ctr) / ext, -1.0, 1.0)
    th_a, th_b = np.arccos(a), np.arccos(b)
    k = np.arange(1, n_moments)
    c = np.empty(n_moments)
    c[0] = (th_a - th_b) / np.pi
    c[1:] = 2.0 * (np.sin(k * th_a) - np.sin(k * th_b)) / (k * np.pi)
    g = _jackson(n_moments)
    return float(n * np.sum(mu * g * c))


@highest_f32_matmul()
def eigsh_range(
    A,
    interval: tuple[float, float],
    *,
    block_size: int = 12,
    slack: int = 4,
    degree: int = 60,
    tol: float | None = None,
    max_iterations: int = 300,
    n_moments: int = 160,
    n_probes: int = 16,
    spectral_bounds: tuple[float, float] | None = None,
    seed: int = 0,
    mesh=None,
    matvec_mode: str = "allgather",
    device=None,
):
    """ALL eigenpairs of a Hermitian operator inside ``interval`` by KPM
    count estimation + Chebyshev bandpass spectrum slicing.

    The interval is partitioned (by the KPM cumulative count) into
    slices estimated to hold ``block_size - slack`` eigenvalues each;
    each slice runs :class:`ChebyshevFilterSolver` with ``block_size``
    vectors (the slack absorbs count-estimate error).  Returns a
    :class:`~eigenex_tpu_torch.solvers.lanczos.LanczosResult` with all
    found pairs sorted ascending and the eigenvectors as a host array;
    ``converged`` is the AND over slices.  ``mesh``: every stage (moment
    SpMMs, per-slice bandpass filtering) runs row-partitioned over the
    device mesh (block-sparse operands; an accelerated operand's pack rides
    the sym_halo ring, multi-axis meshes flatten).
    """
    from ..sparse.accelerate import AcceleratedOperator

    acc = A if isinstance(A, AcceleratedOperator) else None
    if acc is not None and mesh is not None:
        from ..parallel.distributed import prepare_packed_mesh

        mesh, matvec_mode = prepare_packed_mesh(acc.block_matrix(), mesh, matvec_mode)
    if acc is None and mesh is None:
        A = as_filter_operator(A, device)  # validates the operand type early
    a, b_hi = float(interval[0]), float(interval[1])
    if not a < b_hi:
        raise LanczosError(f"interval must satisfy a < b, got {interval}")
    if acc is not None:
        # moments over the block container with probes supported on the
        # unpadded rows (counts then exclude the pads' zero eigenvalues);
        # counts scale by the probe support, not the padded dimension
        mu_pack = chebyshev_moments(
            acc.block_matrix(), n_moments, n_probes=n_probes,
            spectral_bounds=spectral_bounds, seed=seed, probe_rows=acc.n_work,
            mesh=mesh, matvec_mode=matvec_mode,
        )
        count_operand = types.SimpleNamespace(shape=(acc.n_work, acc.n_work))
    else:
        mu_pack = chebyshev_moments(
            A, n_moments, n_probes=n_probes, spectral_bounds=spectral_bounds, seed=seed,
            mesh=mesh, matvec_mode=matvec_mode,
        )
        count_operand = A
    lo, hi = mu_pack[1]
    # the real embedding doubles every eigenvalue of H, so raw KPM counts
    # over a complexified operator are 2x the true count; slice sizing
    # uses the corrected total (the per-slice eigsh_window calls dedup
    # their own doubled contents), while the bisection below compares raw
    # counts against raw-count targets so no factor enters there
    cf = 0.5 if (acc is not None and acc.complexified) else 1.0
    total_raw = eigenvalue_count(count_operand, (a, b_hi), _moments=mu_pack)
    total = cf * total_raw
    per = max(block_size - slack, 1)
    n_slices = max(1, int(np.ceil(total / per)))
    # slice boundaries at equal estimated counts (monotone bisection on
    # the KPM cumulative count)
    edges = [a]
    for s in range(1, n_slices):
        target = total_raw * s / n_slices
        x_lo, x_hi = edges[-1], b_hi
        for _ in range(40):
            mid = (x_lo + x_hi) / 2
            if eigenvalue_count(count_operand, (a, mid), _moments=mu_pack) < target:
                x_lo = mid
            else:
                x_hi = mid
        edges.append((x_lo + x_hi) / 2)
    edges.append(b_hi)

    vals, vecs, conv = [], [], True
    iters = 0
    for s in range(n_slices):
        # tiny overlap between slices avoids losing an eigenvalue that
        # sits exactly on a boundary; duplicates are merged below
        w_lo = edges[s] - (0 if s == 0 else 1e-9 * (hi - lo))
        w_hi = edges[s + 1] + (0 if s == n_slices - 1 else 1e-9 * (hi - lo))
        res = eigsh_window(
            A,
            (w_lo, w_hi),
            block_size=block_size,
            degree=degree,
            tol=tol,
            max_iterations=max_iterations,
            seed=seed + s,
            spectral_bounds=(lo, hi),
            mesh=mesh,
            matvec_mode=matvec_mode,
        )
        conv &= bool(res.converged)
        iters += res.iterations
        if res.eigenvalues.size:
            vals.append(np.asarray(res.eigenvalues))
            if res.eigenvectors is not None:
                V = res.eigenvectors
                vecs.append(V.cpu().numpy() if isinstance(V, torch.Tensor) else np.asarray(V))
    if vals:
        lam = np.concatenate(vals)
        X = np.concatenate(vecs, axis=1) if vecs else None
        order = np.argsort(lam)
        lam = lam[order]
        X = X[:, order] if X is not None else None
        # merge boundary duplicates (same eigenvalue found by two slices)
        if lam.size > 1:
            scale = max(abs(lo), abs(hi), 1.0)
            keep = np.r_[True, np.diff(lam) > 1e-9 * scale]
            # keep multiplicities: only drop when the vectors are parallel
            for i in np.nonzero(~keep)[0]:
                if X is not None:
                    ov = abs(np.vdot(X[:, i - 1], X[:, i]))
                    if ov < 0.9:
                        keep[i] = True
            lam = lam[keep]
            X = X[:, keep] if X is not None else None
    else:
        lam, X = np.zeros(0), None
    return LanczosResult(
        eigenvalues=lam,
        eigenvectors=X,
        iterations=iters,
        converged=conv and lam.size > 0,
        termination="converged" if conv and lam.size else "max_iterations",
        trace=ConvergenceTrace(),
    )
