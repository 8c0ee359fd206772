"""Krylov-Schur restarted Arnoldi for general (non-Hermitian) operators.

Counterpart of ``eigenex_tpu/solvers/krylov_schur.py``: the
non-Hermitian counterpart of thick-restart Lanczos
(:mod:`eigenex_tpu_torch.solvers.restart`).  When the Arnoldi subspace
fills, the projected Hessenberg is reduced to Schur form, the wanted part
of the ordered Schur basis is compressed into the leading basis slots (one
matmul on the device), and iteration continues -- bounded memory,
restart-accelerated convergence for clustered dominant spectra (Stewart
2001).

Where the reference sorts a complex Schur form by a cutoff taken from
``eigvals`` and keeps the real span of the complex Schur vectors, the port
orders a Schur form that is real for a real basis, by its own diagonal
blocks, most wanted first (:func:`_wanted_schur`): each restart keeps p
values, or p + 1 where a complex pair sits at the cut, and the kept block
is an invariant subspace of the projected matrix.  The stop test reads the
Ritz estimates of the very pairs that the extraction returns, the most
wanted of the kept block (:func:`_leading_pairs`), where the reference
reads leading Schur vectors and returns other pairs; it holds them to
``tol`` less the basis dtype's unit roundoff, which it leaves for the
rounding that a true residual adds to its estimate.  On the non-normal
operator of BASELINE config 2 in float32 the reference's restart can
stall or return pairs far above ``tol`` (``tests/cpu_studies.py
ks-convdiff``).

The restart loop, its chunks, spans and ``solver.restarts`` count are
those of thick-restart Lanczos (:mod:`eigenex_tpu_torch.solvers.restart`);
this solver brings its projected problem and its extraction.  All
small-matrix work (Schur form, ordering, Ritz pairs, estimates) is host
LAPACK on float64 / complex128 copies of the Hessenberg.  The span
``eigenex.ks.project`` covers the projected problem of each restart, and
the counters ``ks.steps`` (Arnoldi steps), ``ks.kept`` (the kept dimension
of each restart) and ``ks.host_ms`` (host ms inside that span) are kept
whether or not a profiler runs.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..utils.exceptions import ArnoldiError
from ..utils import profiling
from ..utils.profiling import annotate
from .arnoldi import ArnoldiResult, _hessenberg, _lift_ritz
from .restart import ThickRestartOptions, _RestartedArnoldi

__all__ = ["KrylovSchurArnoldiSolver", "KrylovSchurOptions"]


@dataclasses.dataclass(frozen=True)
class KrylovSchurOptions(ThickRestartOptions):
    """Restart options plus ``which``; ``eigenvalue_indices`` refer to
    the ``which``-ordered spectrum (|lambda|-descending dominant pairs by
    default).  ``which`` follows the scipy ``eigs`` convention:
    "LM"/"SM" (largest/smallest magnitude), "LR"/"SR" (largest/smallest
    real part), "LI"/"SI" (largest/smallest imaginary part) -- the restart
    compression keeps, and convergence tracks, that end of the spectrum."""

    which: str = "LM"


def _which_key(evals: np.ndarray, which: str) -> np.ndarray:
    """Sort key (ascending = most wanted first) for scipy-style ``which``."""
    if which == "LM":
        return -np.abs(evals)
    if which == "SM":
        return np.abs(evals)
    if which == "LR":
        return -np.real(evals)
    if which == "SR":
        return np.real(evals)
    if which == "LI":
        return -np.imag(evals)
    if which == "SI":
        return np.imag(evals)
    raise ArnoldiError(
        f"which must be one of 'LM','SM','LR','SR','LI','SI', got {which!r}"
    )


def _schur_blocks(T: np.ndarray) -> list[tuple[int, int]]:
    """(start, size) of each diagonal block of a Schur form: a 2 x 2 block
    where a real form holds a complex pair (a nonzero subdiagonal), else 1."""
    k = T.shape[0]
    blocks, i = [], 0
    while i < k:
        size = 2 if i + 1 < k and T[i + 1, i] != 0 else 1
        blocks.append((i, size))
        i += size
    return blocks


def _block_values(T: np.ndarray, blocks):
    """(value, is a pair) of each diagonal block of a Schur form, a pair's
    value its member of positive imaginary part: (a + d) / 2 + sqrt(((a -
    d) / 2)^2 + b c) of a 2 x 2 block [[a, b], [c, d]]."""
    start = np.asarray([s for s, _ in blocks], np.int64)
    pair = np.asarray([size == 2 for _, size in blocks], bool)
    first = T[start, start].astype(np.complex128)
    if pair.any():
        s2 = start[pair]
        a, b, c, d = T[s2, s2], T[s2, s2 + 1], T[s2 + 1, s2], T[s2 + 1, s2 + 1]
        root = np.sqrt(((a - d) / 2) ** 2 + b * c + 0j)
        first[pair] = (a + d) / 2 + np.where(root.imag >= 0, root, -root)
    return first, pair


def _block_keys(first: np.ndarray, pair: np.ndarray, which: str) -> np.ndarray:
    """The sort key of each diagonal block, from :func:`_block_values`; a
    pair's key is its more wanted member's."""
    keys = _which_key(first, which)
    return np.where(pair, np.minimum(keys, _which_key(first.conj(), which)), keys)


def _wanted_schur(H: np.ndarray, n_wanted: int, which: str):
    """Schur form H = Q T Q^H (real where H is real) whose leading blocks
    hold the ``n_wanted`` most wanted values, per ``which``, most wanted
    first.  The values are read off the form's own diagonal blocks, so the
    count is exact whatever rounding does to values that nearly tie; LAPACK's
    ``trsen`` moves one block at a time to the next place.  A real form never
    splits a complex pair, so the leading blocks hold ``n_wanted`` or
    ``n_wanted + 1`` values.  Returns (T, Q, their number, every value)."""
    from scipy.linalg import schur

    real = not np.iscomplexobj(H)
    T, Q = schur(H, output="real" if real else "complex")
    blocks = _schur_blocks(T)
    first, pair = _block_values(T, blocks)
    keys = _block_keys(first, pair, which)
    values = np.concatenate([first, first[pair].conj()])
    order = list(np.argsort(keys, kind="stable"))  # block ids, most wanted first
    layout = list(range(len(blocks)))  # block ids as they lie in T
    sizes = [size for _, size in blocks]
    placed = 0
    for j, b in enumerate(order):
        if placed >= n_wanted:
            break
        here = layout.index(b)
        if here != j:
            # trsen keeps the selected blocks' order: the j placed ones, then b
            select = np.zeros(T.shape[0], np.int32)
            select[:placed] = 1
            start = sum(sizes[i] for i in layout[:here])
            select[start:start + sizes[b]] = 1
            T, Q, moved = _trsen(select, T, Q)
            if not moved:
                # a swap too ill-conditioned for LAPACK: the most wanted
                # blocks of the form as it stands, in the order they lie in
                return (*_wanted_unsorted(T, Q, n_wanted, which), values)
            layout = layout[:j] + [b] + [i for i in layout[j:] if i != b]
        placed += sizes[b]
    if 0 < placed < T.shape[0] and T[placed, placed - 1] != 0:
        raise ArnoldiError("the reordered Schur form cuts a 2 x 2 block at its leading blocks")
    return T, Q, placed, values


def _trsen(select, T, Q):
    """LAPACK's ``trsen``: (T, Q, whether the selected blocks now lead).
    When a swap is too ill-conditioned, LAPACK leaves the form partly
    reordered, a Schur form of H all the same."""
    from scipy.linalg import lapack

    trsen = lapack.ztrsen if np.iscomplexobj(T) else lapack.dtrsen
    T, Q, *_, info = trsen(select, T, Q, job="N")
    if info < 0:
        raise ArnoldiError(f"trsen rejected argument {-info}")
    return T, Q, info == 0


def _wanted_unsorted(T, Q, n_wanted: int, which: str):
    """The ``n_wanted`` (+ 1) most wanted values of a Schur form moved to its
    leading blocks in one ``trsen``, in no set order among them."""
    blocks = _schur_blocks(T)
    keys = _block_keys(*_block_values(T, blocks), which)
    select = np.zeros(T.shape[0], np.int32)
    placed = 0
    for b in np.argsort(keys, kind="stable"):
        if placed >= n_wanted:
            break
        s, size = blocks[b]
        select[s:s + size] = 1
        placed += size
    T, Q, moved = _trsen(select, T, Q)
    if not moved:
        raise ArnoldiError("the Schur form could not be reordered: its values are too close")
    return T, Q, placed


def _leading_pairs(T: np.ndarray, count: int, which: str):
    """Eigenpairs of the most wanted diagonal blocks of a Schur form T, per
    ``which``, most wanted first, until ``count`` values (both members of a
    pair at the cut): their values and unit vectors z, T z = theta z, each
    supported on the rows up to its own block (back-substitution, as LAPACK's
    ``trevc``).  On a form that :func:`_wanted_schur` sorted these are its
    leading blocks; on one that it could not sort, they may lie anywhere in
    the kept block."""
    k = T.shape[0]
    thetas, Z = [], []
    tiny = np.finfo(np.float64).eps * max(float(np.max(np.abs(T))) if k else 1.0, 1e-300)
    blocks = _schur_blocks(T)
    first, pair = _block_values(T, blocks)
    for b in np.argsort(_block_keys(first, pair, which), kind="stable"):
        if len(thetas) >= count:
            break
        (s, size), value, two = blocks[b], first[b], pair[b]
        for theta in (value, value.conjugate()) if two else (value,):
            z = np.zeros(k, np.complex128)
            if size == 1:
                z[s] = 1.0
            else:
                B = T[s:s + 2, s:s + 2] - theta * np.eye(2)
                # a null vector of the 2 x 2 block: from the row of larger norm
                r = B[0] if np.abs(B[0]).sum() >= np.abs(B[1]).sum() else B[1]
                z[s:s + 2] = (-r[1], r[0])
            if s:
                A = T[:s, :s] - theta * np.eye(s)
                rhs = -T[:s, s:s + size] @ z[s:s + size]
                try:
                    z[:s] = np.linalg.solve(A, rhs)
                except np.linalg.LinAlgError:  # theta repeats an earlier value exactly
                    z[:s] = np.linalg.solve(A + tiny * np.eye(s), rhs)
            thetas.append(theta)
            Z.append(z / np.linalg.norm(z))
    return np.asarray(thetas, np.complex128), np.asarray(Z).T.reshape(k, len(thetas))


class KrylovSchurArnoldiSolver(_RestartedArnoldi):
    """Dominant-eigenpair solver with bounded memory via Krylov-Schur
    restarts; drop-in alternative to :class:`ArnoldiEigenSolver` when the
    spectrum is clustered or the basis must stay small."""

    _options_type = KrylovSchurOptions
    _result_type = ArnoldiResult
    _error = ArnoldiError
    _step = "Arnoldi"

    def _project(self, state, k, beta, p, tol):
        """The ordered Schur form and the pairs the extraction returns, each
        with its Ritz estimate ||A V y - theta V y|| = beta |y[k-1]|.  A
        pair's true residual adds the Arnoldi relation's own rounding, near
        the basis dtype's unit roundoff of max |lambda(H)|: the stop test
        leaves that much of tol for it (half of tol where tol is that small)."""
        o = self.options
        H = _hessenberg(state.H, k)
        with annotate("eigenex.ks.project"):
            t_project = time.perf_counter()
            T, Q, kept, values = _wanted_schur(H, min(p, k - 1), o.which)
            nev_eff = min(o.max_eigenvalues, k)
            lead = max(kept, nev_eff)
            theta, Z = _leading_pairs(T[:lead, :lead], nev_eff, o.which)
            Y = Q[:, :lead] @ Z
            resid = np.abs(beta * Y[k - 1, :nev_eff])
            scale = max(float(np.max(np.abs(values))), 1e-300)
            slack = min(torch.finfo(state.V.dtype).eps / 2, tol / 2)
            done = nev_eff == o.max_eigenvalues and bool(np.all(resid <= (tol - slack) * scale))
            profiling.count("ks.host_ms", (time.perf_counter() - t_project) * 1e3)
        # The leading blocks of the Schur form span an invariant subspace of
        # H, so A (Q1^T V) = (Q1^T V) T11 + r (beta Q[k-1, :kept]): the basis
        # compresses onto Q1 with T11 as its projected matrix and beta
        # Q[k-1, :kept] as the coupling row, no extra matvec.
        restart = Q[:, :kept], T[:kept, :kept], beta * Q[k - 1, :kept]
        return theta[:nev_eff], resid, done, restart, (theta, Y)

    def _extract(self, state, k, terms):
        """The pairs the last stop test read; after a numerical failure, the
        most wanted pairs of the last chunk's Hessenberg."""
        o = self.options
        if terms is None:
            T, Q, _, _ = _wanted_schur(_hessenberg(state.H, k), k, o.which)
            theta, Z = _leading_pairs(T, min(o.max_eigenvalues, k), o.which)
            Y = Q @ Z
        else:
            theta, Y = terms
        sel = np.argsort(_which_key(theta[:o.max_eigenvalues], o.which), kind="stable")
        vecs = _lift_ritz(state.V, Y[:, sel], k) if o.compute_eigenvectors else None
        return theta[sel] - complex(o.eigenvalue_shift), vecs

    def _chunk_ran(self, steps):
        profiling.count("ks.steps", steps)

    def _restarted(self, kept):
        profiling.count("ks.kept", kept)
