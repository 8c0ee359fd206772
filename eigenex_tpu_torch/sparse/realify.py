"""Real embedding of complex operators.

Counterpart of ``eigenex_tpu/sparse/realify.py``.  The standard real
embedding

    z = x + i y   ->   [x, y]              (stacked real vector, dim 2n)
    H = A + i B   ->   [[A, -B], [B, A]]   (real matrix, dim 2n x 2n)

carries complex operators onto the real block kernels.  For Hermitian H
(A symmetric, B antisymmetric) the embedding is real **symmetric**, and
its spectrum is that of H with every eigenvalue doubled: each complex
eigenpair (lambda, v) yields the orthogonal real pair [Re v, Im v] and
[-Im v, Re v].  Callers deduplicate the doubled Ritz values
(:func:`dedup_doubled_eigenvalues`) and reassemble complex vectors
(:func:`complex_from_real`).

For GENERAL complex H the same embedding works -- its spectrum is
{lambda_j} U {conj lambda_j}: the eigenvector of the embedding for a
genuine eigenvalue lambda of H is [z; -iz], while conj lambda carries the
mirror vector [conj z; i conj z].  :func:`eigs_realified` runs the real
Krylov-Schur solver on the embedding and reconstructs and deduplicates
H's eigenpairs (the reference's complex Arnoldi, arnoldi.hpp:472-501,
sample_lanczos2.cpp:13).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.exceptions import EigenexError
from ..utils.tolerance import real_dtype_of
from .coo import COOMatrix

__all__ = [
    "realify_coo",
    "real_from_complex",
    "complex_from_real",
    "dedup_doubled_eigenvalues",
    "eigs_realified",
]


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def realify_coo(coo: COOMatrix) -> COOMatrix:
    """[[A, -B], [B, A]] real embedding of a complex COO matrix, on the
    device the input lives on.

    Real inputs are returned unchanged.  Entries with zero imaginary
    (or zero real) part are dropped from the corresponding quadrant."""
    if not coo.dtype.is_complex:
        return coo
    n_r, n_c = coo.shape
    r = coo.row.cpu().numpy().astype(np.int64)
    c = coo.col.cpu().numpy().astype(np.int64)
    v = coo.val.cpu().numpy()
    a, b = v.real, v.imag
    am = a != 0
    bm = b != 0
    # top-left A, bottom-right A; top-right -B, bottom-left B
    rr = np.concatenate([r[am], r[am] + n_r, r[bm], r[bm] + n_r])
    cc = np.concatenate([c[am], c[am] + n_c, c[bm] + n_c, c[bm]])
    vv = np.concatenate([a[am], a[am], -b[bm], b[bm]])
    order = np.lexsort((cc, rr))
    rdt = real_dtype_of(coo.dtype)
    dev = coo.device
    return COOMatrix(
        torch.as_tensor(rr[order].astype(np.int32)).to(dev),
        torch.as_tensor(cc[order].astype(np.int32)).to(dev),
        torch.as_tensor(vv[order]).to(device=dev, dtype=rdt),
        (2 * n_r, 2 * n_c),
    )


def real_from_complex(z) -> torch.Tensor:
    """z (n,) complex -> [Re z, Im z] (2n,) real."""
    z = torch.as_tensor(z)
    return torch.cat([z.real, z.imag]) if z.is_complex() else torch.cat([z, torch.zeros_like(z)])


def complex_from_real(x) -> np.ndarray:
    """[x, y] (2n,) real -> x + i y (n,) complex, as a host array."""
    x = _numpy(x)
    if x.shape[-1] % 2:
        raise EigenexError("realified vector length must be even")
    n = x.shape[-1] // 2
    return x[..., :n] + 1j * x[..., n:]


def eigs_realified(
    coo: COOMatrix,
    k: int = 6,
    *,
    tol: float | None = None,
    max_subspace: int | None = None,
    max_restarts: int = 100,
    seed: int = 0,
    refine: bool | int = False,
):
    """k dominant eigenpairs of a GENERAL complex operator using only
    real device arithmetic.

    Runs Krylov-Schur on the real embedding [[A,-B],[B,A]] (spectrum
    {lambda} U {conj lambda}), then reconstructs H's pairs: for each
    real-side Ritz pair (theta, q), z = q_top + i q_bot is 2c z for a
    genuine pair and ~0 for a mirror pair (whose H-pair is recovered by
    conjugating), so the reconstruction norm itself separates the doubled
    spectrum.  Remaining duplicates (real eigenvalues; conjugate-paired
    spectra) dedup by eigenvalue closeness + vector overlap, keeping the
    smaller residual.

    ``refine``: truthy -> polish the reconstructed pairs with
    :func:`eigenex_tpu_torch.solvers.refine.general_inverse_iteration_refine`
    (an int sets the iteration count).

    Returns (evals (<=k,) complex128 |lambda|-descending, X (n, <=k)
    complex128 columns, residuals (<=k,) f64), host arrays."""
    from ..solvers.api import eigs

    if not coo.dtype.is_complex:
        raise EigenexError("eigs_realified expects a complex operator; use eigs")
    n = coo.shape[0]
    R = realify_coo(coo)
    res = eigs(
        R.as_linear_operator(),
        k=min(2 * k, 2 * n - 2),
        tol=tol,
        max_subspace=max_subspace,
        max_restarts=max_restarts,
        seed=seed,
    )
    evals = np.asarray(res.eigenvalues, np.complex128)
    X = _numpy(res.eigenvectors).astype(np.complex128)  # (2n, p), unit columns

    A = coo.to_scipy().tocsr().astype(np.complex128)
    kept = _genuine_pairs(evals, X, lambda q: q[:n] + 1j * q[n:], lambda z: A @ z, tol)
    kept.sort(key=lambda t: -abs(t[0]))
    kept = kept[:k]
    lam_out = np.array([t[0] for t in kept], np.complex128)
    X_out = np.stack([t[1] for t in kept], axis=1) if kept else np.zeros((n, 0), np.complex128)
    res_out = np.array([t[2] for t in kept], np.float64)
    if refine and kept:
        from ..solvers.refine import general_inverse_iteration_refine

        iters = int(refine) if not isinstance(refine, bool) else 60
        lam_out, X_out, res_out = general_inverse_iteration_refine(
            coo, X_out, lam_out, iters=iters
        )
        order = np.argsort(-np.abs(lam_out), kind="stable")
        lam_out, X_out, res_out = lam_out[order], X_out[:, order], res_out[order]
    return lam_out, X_out, res_out


def _genuine_pairs(theta, Q, to_complex, apply_A, tol) -> list:
    """The eigenpairs of a complex H among the Ritz pairs (theta_j, q_j) of
    its real embedding, as (lambda, unit z, ||H z - lambda z||) triplets,
    smallest residual first.

    ``to_complex`` maps an embedded vector to z = q_top + i q_bot (in
    original coordinates), ``apply_A`` applies H to a complex vector.  Each
    pair and its conjugate are tried: z has norm ~sqrt(2) |c| for a genuine
    pair and ~0 for a mirror pair (whose H-pair is the conjugate's), so the
    reconstruction norm itself splits the doubled spectrum.  Remaining
    duplicates (real eigenvalues, conjugate-paired spectra) are dropped by
    eigenvalue closeness + vector overlap, keeping the smaller residual."""
    cands = []
    for j in range(Q.shape[1]):
        t = complex(theta[j])
        for lam, q in ((t, Q[:, j]), (np.conj(t), np.conj(Q[:, j]))):
            z = to_complex(q)
            nz = np.linalg.norm(z)
            # a genuine pair reconstructs with norm sqrt(2) (unit q); a
            # mirror pair with ~0 -- 0.3 splits them with wide margin
            if nz < 0.3:
                continue
            z = z / nz
            cands.append((lam, z, float(np.linalg.norm(apply_A(z) - lam * z))))
    cands.sort(key=lambda t: t[2])  # the cleanest representative survives the dedup
    scale = max((abs(c[0]) for c in cands), default=1.0)
    close = max(tol if tol is not None else 0.0, 1e-6) * max(scale, 1.0)
    kept: list[tuple] = []
    for lam, z, r in cands:
        if not any(abs(lam - lk) <= close and abs(np.vdot(zk, z)) > 0.9 for lk, zk, _ in kept):
            kept.append((lam, z, r))
    return kept


def dedup_doubled_eigenvalues(evals: np.ndarray, tol: float | None = None) -> np.ndarray:
    """Collapse the doubled spectrum of a realified Hermitian operator:
    consecutive pairs within ``tol`` merge to one eigenvalue."""
    evals = np.asarray(evals)
    if tol is None:
        spread = float(evals.max() - evals.min()) if evals.size > 1 else 1.0
        tol = max(spread, 1.0) * 1e-8
    out = []
    i = 0
    while i < len(evals):
        if i + 1 < len(evals) and abs(evals[i + 1] - evals[i]) <= tol:
            out.append((evals[i] + evals[i + 1]) / 2)
            i += 2
        else:
            out.append(evals[i])
            i += 1
    return np.asarray(out)
