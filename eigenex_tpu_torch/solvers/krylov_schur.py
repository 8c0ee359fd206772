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
ks-convdiff``).  No solve calls ``_ordered_schur`` or
``_restart_coefficients``: they are the reference's restart pieces, kept
for the parity tests that hold them to it.

One chunk fills the subspace, so the host and the device synchronise
once per restart; the restarts are written into the one state of the
solve, whose chunks replay CUDA graphs on the card
(:mod:`eigenex_tpu_torch.solvers.chunk_graph`).  All small-matrix work
(Schur form, ordering, Ritz pairs, estimates) is host LAPACK on float64 /
complex128 copies of the Hessenberg; the device does the Arnoldi chunk
and the (p, m) x (m, n) basis compression.  The loop's spans and its
``solver.restarts`` count are those of
:mod:`eigenex_tpu_torch.solvers.restart`; besides, the span
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

from ..core.operators import aslinearoperator
from ..utils.exceptions import ArnoldiError
from ..utils import profiling
from ..utils.precision import highest_f32_matmul
from ..utils.profiling import annotate
from ..utils.tolerance import default_breakdown_threshold, default_tolerance
from ..utils.trace import ConvergenceTrace, Severity
from . import chunk_graph
from .arnoldi import (ArnoldiResult, ArnoldiState, _hessenberg, _lift_ritz, _restart_into,
                      arnoldi_steps, init_arnoldi_state)
from .lanczos import LanczosOptions
from .restart import _compress_basis

__all__ = ["KrylovSchurArnoldiSolver", "KrylovSchurOptions"]


@dataclasses.dataclass(frozen=True)
class KrylovSchurOptions(LanczosOptions):
    """Arnoldi options plus restart knobs; ``eigenvalue_indices`` refer to
    the ``which``-ordered spectrum (|lambda|-descending dominant pairs by
    default).  ``which`` follows the scipy ``eigs`` convention:
    "LM"/"SM" (largest/smallest magnitude), "LR"/"SR" (largest/smallest
    real part), "LI"/"SI" (largest/smallest imaginary part) -- the restart
    compression keeps, and convergence tracks, that end of the spectrum."""

    num_kept: int | None = None
    max_restarts: int = 100
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


def _ordered_schur(H: np.ndarray, n_wanted: int, which: str = "LM"):
    """The reference's ordering: complex Schur form of H with (at least)
    the ``n_wanted`` most-wanted values (per ``which``) ordered into the
    leading block, by a cutoff taken from ``eigvals``.  Returns (T, Q,
    evals_sorted_wanted_first).  The solver orders by
    :func:`_wanted_schur`."""
    from scipy.linalg import schur

    evals = np.linalg.eigvals(H.astype(np.complex128))
    keys = _which_key(evals, which)
    order = np.argsort(keys, kind="stable")
    wanted_first = evals[order]
    scale = float(np.max(np.abs(evals))) if len(evals) else 1.0
    cutoff = keys[order[min(n_wanted, len(evals)) - 1]] if len(evals) else 0.0
    eps = 1e-12 * max(scale, 1.0)
    T, Q, sdim = schur(
        H.astype(np.complex128),
        output="complex",
        sort=lambda x: bool(_which_key(np.asarray([x]), which)[0] <= cutoff + eps),
    )
    return T, Q, wanted_first


def _restart_coefficients(Q: np.ndarray, pk: int, m: int, complex_basis: bool) -> np.ndarray:
    """The reference's restart coefficients (the solver compresses onto the
    leading block of :func:`_wanted_schur` instead): the orthonormal (k, p')
    coefficient matrix a restart compresses the basis with.  A complex
    basis keeps the leading ``pk`` Schur vectors.  A
    real basis keeps the real span of {Re q_i, Im q_i}, whose rank can reach
    2 pk: truncating it would break the Arnoldi decomposition, so the number
    of kept Schur vectors is reduced until the whole span fits ``m - 2``."""
    if complex_basis:
        return Q[:, :pk]
    for pk_try in range(pk, 0, -1):
        Qk = Q[:, :pk_try]
        if np.allclose(Qk.imag, 0, atol=1e-14):
            cand = np.ascontiguousarray(Qk.real)
        else:
            span = np.concatenate([Qk.real, Qk.imag], axis=1)
            u, s, _ = np.linalg.svd(span, full_matrices=False)
            rank = int(np.sum(s > (s[0] if s.size else 1) * 1e-10))
            cand = u[:, :rank]
        if cand.shape[1] <= m - 2:
            return cand
    return np.zeros((Q.shape[0], 0))  # pathological; restart from the residual alone


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


class KrylovSchurArnoldiSolver:
    """Dominant-eigenpair solver with bounded memory via Krylov-Schur
    restarts; drop-in alternative to :class:`ArnoldiEigenSolver` when the
    spectrum is clustered or the basis must stay small."""

    def __init__(self, operator=None, options: KrylovSchurOptions | None = None):
        self.operator = aslinearoperator(operator) if operator is not None else None
        self.options = options or KrylovSchurOptions()
        self.trace = ConvergenceTrace()
        self._initial_vector = None
        self._result: ArnoldiResult | None = None

    def set_initial_vector(self, v0):
        self._initial_vector = v0
        return self

    @highest_f32_matmul()
    @chunk_graph.solve_graphs()
    def compute(self, operator=None) -> ArnoldiResult:
        if operator is not None:
            self.operator = aslinearoperator(operator)
        op = self.operator
        if op is None:
            raise ArnoldiError("no operator set")
        if op.shape[0] != op.shape[1]:
            raise ArnoldiError(f"requires a square operator, got {op.shape}")
        o = self.options
        n = op.shape[1]
        nev = o.max_eigenvalues
        m = min(o.max_subspace, n)
        if m < nev + 2:
            raise ArnoldiError(f"max_subspace={m} too small for {nev} eigenpairs")
        p = o.num_kept if o.num_kept is not None else min(max(2 * nev, nev + 8), m - 2)
        p = min(p, m - 2)
        tol = o.tolerance if o.tolerance is not None else default_tolerance(op.dtype)
        bd = (
            o.breakdown_threshold
            if o.breakdown_threshold is not None
            else default_breakdown_threshold(op.dtype)
        )
        self.trace = ConvergenceTrace()
        t0 = time.perf_counter()

        state = init_arnoldi_state(op, m, self._initial_vector, seed=o.seed, breakdown_threshold=bd)
        # a returned pair's true residual is its Ritz estimate plus the
        # Arnoldi relation's own rounding, near the basis dtype's unit
        # roundoff of max |lambda(H)|: the stop test leaves that much of tol
        # for it (half of tol where tol itself is that small)
        slack = min(torch.finfo(state.V.dtype).eps / 2, tol / 2)
        k = 0
        total = 0
        termination = "max_restarts"
        converged = False

        for restart in range(o.max_restarts + 1):
            k0 = k
            state = self._run_arnoldi_chunk(op, state, m - k0, bd)
            # the host/device synchronisation point, once per restart
            with annotate("eigenex.wait"):
                k, has_broken, has_failed = state.host_flags()
            total += k - k0
            profiling.count("ks.steps", k - k0)
            if has_failed:
                termination = "numerical_failure"
                converged = False
                self.trace.log(
                    Severity.ERROR,
                    f"numerical failure at {total} iterations: non-finite "
                    "Hessenberg (operator overflow or NaN)",
                )
                if k == 0:
                    raise ArnoldiError("numerical failure on the first Arnoldi step")
                break
            with annotate("eigenex.ritz"):
                H = _hessenberg(state.H, k)
                with annotate("eigenex.wait"):
                    beta = float(self.state_residue(state))
                with annotate("eigenex.ks.project"):
                    t_project = time.perf_counter()
                    T, Q, kept, values = _wanted_schur(H, min(p, k - 1), o.which)
                    nev_eff = min(nev, k)
                    lead = max(kept, nev_eff)
                    theta, Z = _leading_pairs(T[:lead, :lead], nev_eff, o.which)
                    Y = Q[:, :lead] @ Z
                    # the pairs the extraction returns, each with its Ritz
                    # estimate ||A V y - theta V y|| = beta |y[k-1]|
                    resid = np.abs(beta * Y[k - 1, :nev_eff])
                    scale = max(float(np.max(np.abs(values))), 1e-300)
                    profiling.count("ks.host_ms", (time.perf_counter() - t_project) * 1e3)
                self.trace.record(
                    total, theta[:nev_eff], float(np.max(resid)) if nev_eff else np.nan,
                    time.perf_counter() - t0,
                )

            if has_broken:
                termination = "breakdown"
                converged = True
                self.trace.log(Severity.INFO, f"breakdown at {total} iterations")
                break
            if nev_eff == nev and np.all(resid <= (tol - slack) * scale):
                termination = "converged"
                converged = True
                self.trace.log(
                    Severity.INFO,
                    f"converged after {restart} restarts / {total} iterations "
                    f"(max residual {float(np.max(resid)):.3e})",
                )
                break
            if restart == o.max_restarts:
                self.trace.log(Severity.WARN, f"stopped at max_restarts={o.max_restarts}")
                break

            # ---- Krylov-Schur restart ----
            # The leading blocks of the Schur form span an invariant subspace
            # of H, so A (Q1^T V) = (Q1^T V) T11 + r (beta Q[k-1, :kept]): the
            # basis compresses onto Q1 with T11 as its projected matrix and
            # beta Q[k-1, :kept] as the coupling row, no extra matvec.
            with annotate("eigenex.restart"):
                H_new = np.zeros((m + 1, m), H.dtype)
                H_new[:kept, :kept] = T[:kept, :kept]
                H_new[kept, :kept] = beta * Q[k - 1, :kept]
                dev = state.V.device
                state = _restart_into(
                    state, _compress_basis(state.V, Q[:, :kept], state.V[k].clone()),
                    torch.as_tensor(H_new).to(device=dev, dtype=state.H.dtype), kept)
                k = kept
            profiling.count("solver.restarts")
            profiling.count("ks.kept", kept)

        # ---- extraction: the pairs the last stop test read ----
        with annotate("eigenex.extract"):
            if termination == "numerical_failure":
                T, Q, _, _ = _wanted_schur(_hessenberg(state.H, k), k, o.which)
                theta, Z = _leading_pairs(T, min(nev, k), o.which)
                Y = Q @ Z
            sel = np.argsort(_which_key(theta[:nev], o.which), kind="stable")
            evals_out = theta[sel] - complex(o.eigenvalue_shift)
            vecs = None
            if o.compute_eigenvectors:
                vecs = _lift_ritz(state.V, Y[:, sel], k)
        self._result = ArnoldiResult(
            eigenvalues=evals_out,
            eigenvectors=vecs,
            iterations=total,
            converged=converged,
            termination=termination,
            trace=self.trace,
        )
        return self._result

    def _run_arnoldi_chunk(self, op, state, num_steps, breakdown_threshold):
        """One Arnoldi chunk (the distributed solver runs it over a mesh)."""
        return arnoldi_steps(
            op, state, num_steps, shift=self.options.eigenvalue_shift,
            breakdown_threshold=breakdown_threshold,
        )

    @staticmethod
    def state_residue(state: ArnoldiState) -> float:
        """||w|| after the last orthogonalisation: the beta of the residual
        bound and of the coupling row."""
        return float(state.residue)

    @property
    def eigenvalues(self):
        if self._result is None:
            raise ArnoldiError("compute() has not been run")
        return self._result.eigenvalues

    @property
    def eigenvectors(self):
        if self._result is None:
            raise ArnoldiError("compute() has not been run")
        return self._result.eigenvectors
