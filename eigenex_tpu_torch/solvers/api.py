"""One-call eigensolver front end (scipy.sparse.linalg-style).

Counterpart of ``eigsh`` in ``eigenex_tpu/solvers/api.py``: k extremal
eigenpairs of a Hermitian operator, from a dense matrix, a
``LinearOperator``, a sparse container
(:class:`~eigenex_tpu_torch.sparse.coo.COOMatrix`,
:class:`~eigenex_tpu_torch.sparse.bsr.BSRMatrix`,
:class:`~eigenex_tpu_torch.sparse.sym_bsr.SymBSRMatrix`) or an
:class:`~eigenex_tpu_torch.sparse.accelerate.AcceleratedOperator`.
Plain Lanczos runs when the subspace covers the problem, thick-restart
Lanczos otherwise; ``M=``/``preconditioner=`` route to the block
preconditioned LOBPCG solver.

Arguments of the JAX front end whose route is not ported yet --
``sigma`` and ``which="SM"`` (shift-invert), ``mesh`` (the distributed
solvers), ``refine`` (host f64 polish) -- raise
``EigenexError("not ported yet: ...")``; none is silently ignored.
``eigs`` and ``svds`` are not ported yet either.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.operators import LinearOperator, aslinearoperator
from ..utils.exceptions import EigenexError, not_ported
from .lanczos import LanczosEigenSolver, LanczosOptions, LanczosResult
from .restart import ThickRestartLanczosEigenSolver, ThickRestartOptions

__all__ = ["eigsh"]


def _resolve_operand(A, device) -> LinearOperator:
    """The operator of any accepted operand.  Containers, operators and
    tensors are used where they live, unless ``device`` says otherwise
    (containers and tensors are then moved); host arrays go to ``device``
    (the card by default)."""
    from ..sparse.bsr import BSRMatrix
    from ..sparse.coo import COOMatrix
    from ..sparse.sym_bsr import SymBSRMatrix

    if isinstance(A, (COOMatrix, BSRMatrix, SymBSRMatrix)):
        if device is not None and A.device != torch.device(device):
            A = A.to(device)
        return A.as_linear_operator()
    if isinstance(A, LinearOperator):
        if device is not None and A.device.type != torch.device(device).type:
            raise EigenexError(
                f"the operator lives on {A.device}; eigsh was asked for {device}"
            )
        return A
    return aslinearoperator(A, device=device)


def eigsh(
    A,
    k: int = 6,
    *,
    which: str = "SA",
    sigma=None,
    M=None,
    preconditioner=None,
    tol: float | None = None,
    max_subspace: int | None = None,
    max_restarts: int = 200,
    max_iterations: int = 200,
    seed: int = 0,
    mesh=None,
    refine: bool | int = False,
    v0=None,
    accelerate: bool = False,
    device=None,
) -> LanczosResult:
    """k extremal eigenpairs of a Hermitian operator.

    which: "SA" (smallest algebraic), "LA" (largest algebraic), "BE"
    (both ends, k split half/half with the extra pair on the high end) or
    "LM" (largest magnitude -- both ends tracked, k selected by |lambda|).
    Results are always in ascending-lambda order (scipy convention).
    M: Hermitian positive-definite right-hand operator of the
    GENERALIZED problem ``A x = lambda M x`` -- routes to the block
    preconditioned LOBPCG solver
    (:func:`~eigenex_tpu_torch.solvers.lobpcg.lobpcg`), optionally with
    ``preconditioner`` (``T ~ A^-1`` applied blockwise); that route
    takes ``which`` "SA" or "LA" only, no ``v0`` and no ``accelerate``,
    and stops after ``max_iterations`` block iterations.
    tol: convergence tolerance (None -> the dtype default).
    max_subspace: Krylov dimension kept in memory (None ->
    max(6*tracked + 32, 64), capped at n).
    max_restarts: thick-restart cycles before giving up.
    seed: seed of the random start vector when ``v0`` is None.
    v0: initial Krylov vector (scipy parity); original-space for
    accelerated operands.
    accelerate: repack a scalar-sparse operand through
    :func:`eigenex_tpu_torch.sparse.accelerate.accelerate` (RCM reorder +
    dense blocks in half storage) and solve in permuted space, restoring
    eigenvectors to original coordinates.  An ``AcceleratedOperator``
    operand takes this route implicitly.
    device: where the solve runs.  None means: where the operand's
    tensors already live, and the card for host operands (numpy, scipy,
    triplets).  Pass ``device="cpu"`` to run on the CPU.
    """
    from ..sparse.accelerate import AcceleratedOperator

    if sigma is not None or which == "SM":
        raise not_ported("eigsh(sigma=) / which='SM' (shift-invert)")
    if mesh is not None:
        raise not_ported("eigsh(mesh=) (the distributed solvers)")
    if refine:
        raise not_ported("eigsh(refine=) (host float64 refinement)")
    if which not in ("SA", "LA", "BE", "LM"):
        raise EigenexError(
            f"which must be one of 'SA', 'LA', 'BE', 'LM', 'SM', got {which!r}"
        )

    lobpcg_route = M is not None or preconditioner is not None
    if lobpcg_route and (accelerate or isinstance(A, AcceleratedOperator)):
        raise EigenexError(
            "accelerate=True cannot combine with M=/preconditioner= "
            "(the LOBPCG route consumes the operand directly)"
        )
    if accelerate and not isinstance(A, AcceleratedOperator):
        from ..sparse.accelerate import accelerate as _accelerate_fn

        A = _accelerate_fn(A, symmetric=True, device=device)
    if isinstance(A, AcceleratedOperator):
        return _eigsh_accelerated(
            A, k, which=which, tol=tol, max_subspace=max_subspace,
            max_restarts=max_restarts, seed=seed, v0=v0,
        )

    op = _resolve_operand(A, device)
    n = op.shape[0]
    if op.shape[0] != op.shape[1]:
        raise EigenexError("eigsh requires a square operator")

    if lobpcg_route:
        if v0 is not None:
            raise EigenexError("v0= is not supported on the LOBPCG (M=/preconditioner=) route")
        if which not in ("SA", "LA"):
            raise EigenexError(
                "the LOBPCG route targets spectrum extremes only: use "
                "which='SA' or 'LA' with M=/preconditioner="
            )
        from .lobpcg import lobpcg

        # M goes where A lives, so the two meet on one device
        opM = _resolve_operand(M, op.device) if M is not None else None
        res = lobpcg(
            op, k, B=opM, preconditioner=preconditioner, largest=(which == "LA"),
            tol=tol, max_iterations=max_iterations, seed=seed,
        )
        order = np.argsort(np.asarray(res.eigenvalues))  # ascending, as the
        res.eigenvalues = np.asarray(res.eigenvalues)[order]  # Lanczos routes
        if res.eigenvectors is not None:
            res.eigenvectors = res.eigenvectors[:, order.tolist()]
        return res

    indices, n_track, lm_post = _which_indices(which, k)
    m = min(max_subspace or max(6 * n_track + 32, 64), n)
    if m >= n:
        # full subspace available: plain Lanczos terminates exactly
        solver = LanczosEigenSolver(
            op,
            LanczosOptions(
                max_eigenvalues=n_track, eigenvalue_indices=indices, tolerance=tol,
                max_subspace=n, seed=seed,
            ),
        )
    else:
        solver = ThickRestartLanczosEigenSolver(
            op,
            ThickRestartOptions(
                max_eigenvalues=n_track, eigenvalue_indices=indices, tolerance=tol,
                max_subspace=m, max_restarts=max_restarts, seed=seed,
            ),
        )
    if v0 is not None:
        solver.set_initial_vector(v0)
    res = solver.compute()
    if lm_post:
        res = _postselect_lm(res, k)
    return res


def _which_indices(which: str, k: int):
    """(tracked Ritz indices, tracked count, lm_postselect) for the
    Hermitian ``which`` modes.  BE splits k over both ends (extra pair to
    the high end on odd k, scipy convention); LM tracks k from each end
    and post-selects by |lambda|."""
    if which == "SA":
        return tuple(range(k)), k, False
    if which == "LA":
        return tuple(range(-k, 0)), k, False
    if which == "BE":
        kl = k // 2
        return tuple(range(kl)) + tuple(range(-(k - kl), 0)), k, False
    return tuple(range(k)) + tuple(range(-k, 0)), 2 * k, True  # LM


def _postselect_lm(res: LanczosResult, k: int) -> LanczosResult:
    """Keep the k largest-|lambda| pairs of the both-ends tracked set,
    returned in ascending order (scipy eigsh convention)."""
    lam = np.asarray(res.eigenvalues)
    pick = np.argsort(-np.abs(lam), kind="stable")[:k]
    order = pick[np.argsort(lam[pick])]
    vecs = res.eigenvectors[:, order.tolist()] if res.eigenvectors is not None else None
    return LanczosResult(
        eigenvalues=lam[order],
        eigenvectors=vecs,
        iterations=res.iterations,
        converged=res.converged,
        termination=res.termination,
        trace=res.trace,
    )


def _eigsh_accelerated(acc, k, *, which, tol, max_subspace, max_restarts, seed, v0) -> LanczosResult:
    """eigsh route for an :class:`AcceleratedOperator`: solve over the
    permuted+padded block container, then restore eigenvectors to
    original coordinates.

    The start vector is always padding-safe (zero in the structurally-
    zero pad rows), so the Krylov space never leaves the embedded
    subspace and no spurious pad eigenvalues enter the tracked set."""
    from ..sparse.accelerate import _padding_safe_v0

    if v0 is not None:
        v0e = acc.embed(v0)
    else:
        v0e = _padding_safe_v0(
            acc.n_work, acc.shape[0], acc.as_linear_operator().dtype, seed, acc.device
        )
    res = eigsh(
        acc.matrix, k, which=which, tol=tol, max_subspace=max_subspace,
        max_restarts=max_restarts, seed=seed, v0=v0e,
    )
    return _restore_accelerated(res, acc)


def _restore_accelerated(res: LanczosResult, acc) -> LanczosResult:
    """Shared tail of the accelerated routes: eigenvectors back through
    the permutation, as a host array in original coordinates."""
    vecs = acc.restore(res.eigenvectors) if res.eigenvectors is not None else None
    return LanczosResult(
        eigenvalues=np.asarray(res.eigenvalues),
        eigenvectors=vecs,
        iterations=res.iterations,
        converged=res.converged,
        termination=res.termination,
        trace=res.trace,
    )
