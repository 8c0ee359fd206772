"""One-call eigensolver front ends (scipy.sparse.linalg-style).

Counterpart of ``eigsh``, ``eigs`` and ``svds`` in ``eigenex_tpu/solvers/api.py``:

- :func:`eigsh` -- Hermitian: ``which`` in {"SA", "LA", "BE", "LM",
  "SM"}, optional ``sigma`` (shift-invert through a MINRES inner solve).
  Plain Lanczos when the subspace covers the problem, thick-restart
  Lanczos otherwise; ``M=``/``preconditioner=`` route to the block
  preconditioned LOBPCG solver.
- :func:`eigs` -- general: ``which`` in {"LM", "SM", "LR", "SR", "LI",
  "SI"} eigenpairs via Krylov-Schur; optional ``sigma`` (GMRES
  shift-invert, ``which`` then applying to theta = 1/(lambda - sigma) as
  in scipy).

Both accept a dense matrix, a ``LinearOperator``, a sparse container
(:class:`~eigenex_tpu_torch.sparse.coo.COOMatrix`,
:class:`~eigenex_tpu_torch.sparse.bsr.BSRMatrix`,
:class:`~eigenex_tpu_torch.sparse.sym_bsr.SymBSRMatrix`) or an
:class:`~eigenex_tpu_torch.sparse.accelerate.AcceleratedOperator`, real or
complex (complex operands of ``accelerate=`` ride the real embedding).
With a COOMatrix operand, ``refine=True`` polishes the returned pairs on
the host in float64.

- :func:`svds` -- the top-k singular triplets through Hermitian Lanczos on
  the smaller-side Gram operator; on an accelerated (rectangular) operand
  both Gram matvecs run on packed general blocks.

``mesh=`` (a :class:`~eigenex_tpu_torch.parallel.mesh.Mesh`) routes each
of them to the distributed layer (:mod:`eigenex_tpu_torch.parallel`): the
operator's block rows split over the mesh, ``matvec_mode`` picks the
exchange ("allgather", "colsplit", "halo", "sym_halo"), and a 2-axis mesh
takes the panel grid.  Sparse operands only.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from ..core.operators import LinearOperator, aslinearoperator
from ..utils import profiling
from ..utils.exceptions import EigenexError
from ..utils.precision import highest_f32_matmul
from .gmres import shift_invert_operator_general
from .krylov_schur import KrylovSchurArnoldiSolver, KrylovSchurOptions, _which_key
from .lanczos import LanczosEigenSolver, LanczosOptions, LanczosResult
from .restart import ThickRestartLanczosEigenSolver, ThickRestartOptions

__all__ = ["eigsh", "eigs", "svds"]


_requests = threading.local()


def _launched() -> int:
    return sum(profiling.counters("launch.").values())


def _request(front_end):
    """A public front end as one request: the root span ``eigenex.solve`` and
    the counters ``solver.solves``, ``solver.iterations`` (the result's own
    count, where it has one) and ``solver.launches`` (kernel launches while
    it ran, from every thread).  A front end called from inside another
    (the accelerated routes call ``eigsh`` on the pack) is part of its
    request."""

    @functools.wraps(front_end)
    def request(*args, **kwargs):
        if getattr(_requests, "open", False):
            return front_end(*args, **kwargs)
        _requests.open = True
        launched = _launched()
        try:
            with profiling.annotate(profiling.ROOT_SPAN):
                result = front_end(*args, **kwargs)
        finally:
            _requests.open = False
        profiling.count("solver.solves")
        profiling.count("solver.launches", _launched() - launched)
        iterations = getattr(result, "iterations", None)
        if iterations is not None:
            profiling.count("solver.iterations", int(iterations))
        return result

    return request


def _resolve_operand(A, device) -> LinearOperator:
    """The operator of any accepted operand.  Containers, operators and
    tensors are used where they live, unless ``device`` says otherwise
    (containers and tensors are then moved); host arrays go to ``device``
    (the card by default)."""
    from ..sparse.bsr import BSRMatrix
    from ..sparse.coo import COOMatrix
    from ..sparse.sym_bsr import SymBSRMatrix
    from ..sparse.sym_csr import SymCSRMatrix

    if isinstance(A, (COOMatrix, BSRMatrix, SymBSRMatrix, SymCSRMatrix)):
        if device is not None and A.device != torch.device(device):
            A = A.to(device)
        return A.as_linear_operator()
    if isinstance(A, LinearOperator):
        if device is not None and A.device.type != torch.device(device).type:
            raise EigenexError(
                f"the operator lives on {A.device}; the solve was asked for {device}"
            )
        return A
    return aslinearoperator(A, device=device)


def _coo_operand(A):
    """The operand itself when it is a COOMatrix (the ``refine=`` input)."""
    from ..sparse.coo import COOMatrix

    return A if isinstance(A, COOMatrix) else None


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _default_inner_tol(inner_tol, tol, dtype) -> float:
    """The shift-invert inner target: 1e-2 of the outer tolerance."""
    if inner_tol is not None:
        return inner_tol
    from ..utils.tolerance import default_tolerance

    outer = tol if tol is not None else default_tolerance(dtype)
    return max(outer * 1e-2, 1e-14)


def _mesh_container(op, block_shape):
    """The block container the distributed drivers split: a BSRMatrix or
    SymBSRMatrix operand as it is (on the solve's device), a COOMatrix
    packed in square blocks -- (128, 128) where f32/bf16 blocks reach the
    kernels on the card, (4, 4) elsewhere, as the JAX package packs off the
    TPU -- so the padded operator stays square."""
    from ..ops.cuda_spmv import kernel_storage
    from ..sparse.bsr import BSRMatrix, bsr_from_coo_arrays
    from ..sparse.coo import COOMatrix
    from ..sparse.sym_bsr import SymBSRMatrix

    held = op._params
    if isinstance(held, (BSRMatrix, SymBSRMatrix)):
        return held
    if isinstance(held, COOMatrix):
        if block_shape is None:
            on_card = held.device.type == "cuda" and kernel_storage(held.dtype)
            block_shape = (128, 128) if on_card else (4, 4)
        return bsr_from_coo_arrays(
            _host(held.row), _host(held.col), _host(held.val), held.shape, block_shape,
            device=held.device,
        )
    raise EigenexError(
        "mesh= requires a sparse operand (COOMatrix or BSRMatrix) so the "
        "operator's rows can be partitioned over the device mesh"
    )


def _grid_operator(bsr_op, mesh):
    """(padded container, panel-grid operator) of a 2-axis mesh."""
    from ..parallel.distributed import mesh_operator_2d, pad_bsr_for_mesh

    nrc = mesh.shape[mesh.axis_names[0]] * mesh.shape[mesh.axis_names[1]]
    padded = pad_bsr_for_mesh(bsr_op, nrc)
    return padded, mesh_operator_2d(padded, mesh)


def _safe_start(solver, n: int, padded_n: int, dtype, seed: int, device):
    """Give ``solver`` a padding-safe start when the mesh padded the operand."""
    from ..parallel.distributed import _padding_safe_v0

    if padded_n != n:
        solver.set_initial_vector(_padding_safe_v0(n, padded_n, dtype, seed, device))


def _truncate(res, n: int):
    if res.eigenvectors is not None and res.eigenvectors.shape[0] != n:
        res.eigenvectors = res.eigenvectors[:n]
    return res


@_request
@highest_f32_matmul()
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
    inner_tol: float | None = None,
    mesh=None,
    matvec_mode: str = "allgather",
    block_shape: tuple[int, int] | None = None,
    refine: bool | int = False,
    v0=None,
    accelerate: bool = False,
    use_pallas: bool | str = False,
    device=None,
) -> LanczosResult:
    """k extremal (or sigma-targeted) eigenpairs of a Hermitian operator.

    which: "SA" (smallest algebraic), "LA" (largest algebraic), "BE"
    (both ends, k split half/half with the extra pair on the high end),
    "LM" (largest magnitude -- both ends tracked, k selected by |lambda|)
    or "SM" (smallest magnitude = shift-invert at sigma=0, scipy's own
    recipe); ignored when ``sigma`` is given (returns the pairs nearest
    sigma).  Results are always in ascending-lambda order (scipy
    convention).
    sigma: shift-invert target; every outer Lanczos matvec is a MINRES
    solve of (A - sigma I) y = x (:func:`~eigenex_tpu_torch.solvers.cg.shift_invert_operator`).
    M: Hermitian positive-definite right-hand operator of the
    GENERALIZED problem ``A x = lambda M x`` -- routes to the block
    preconditioned LOBPCG solver
    (:func:`~eigenex_tpu_torch.solvers.lobpcg.lobpcg`), optionally with
    ``preconditioner`` (``T ~ A^-1`` applied blockwise); that route
    takes ``which`` "SA" or "LA" only, no ``v0``, no ``sigma`` and no
    ``accelerate``, and stops after ``max_iterations`` block iterations.
    tol: convergence tolerance (None -> the dtype default).
    max_subspace: Krylov dimension kept in memory (None ->
    max(6*tracked + 32, 64), capped at n).
    max_restarts: thick-restart cycles before giving up.
    seed: seed of the random start vector when ``v0`` is None.
    inner_tol: relative-residual target of the MINRES inner solve of
    ``sigma`` (default 1e-2 of the outer tolerance).
    refine: with a COOMatrix operand, polish the pairs on the host in f64
    (:func:`~eigenex_tpu_torch.solvers.refine.inverse_iteration_refine`;
    an int sets the iteration count).
    v0: initial Krylov vector (scipy parity); original-space for
    accelerated operands.
    accelerate: repack a scalar-sparse operand through
    :func:`eigenex_tpu_torch.sparse.accelerate.accelerate` (RCM reorder +
    dense blocks in half storage; complex Hermitian operands through the
    real embedding) and solve in permuted space, restoring eigenvectors to
    original coordinates.  An ``AcceleratedOperator`` operand takes this
    route implicitly.
    mesh: a :class:`~eigenex_tpu_torch.parallel.mesh.Mesh` routes the
    iteration to the distributed thick-restart driver (shift-invert with
    ``sigma``; a 2-axis mesh takes the panel-grid operator; an accelerated
    operand rides the sym_halo ring).  Sparse operands only; no ``v0``.
    matvec_mode: the mesh exchange (see :mod:`eigenex_tpu_torch.parallel`).
    block_shape: blocks of a COOMatrix operand packed for the mesh.
    use_pallas: accepted for the JAX package's signature; the card runs the
    kernels whatever it says.
    device: where the solve runs.  None means: where the operand's
    tensors already live, and the card for host operands (numpy, scipy,
    triplets).  Pass ``device="cpu"`` to run on the CPU.
    """
    from ..sparse.accelerate import AcceleratedOperator

    if which not in ("SA", "LA", "BE", "LM", "SM"):
        raise EigenexError(
            f"which must be one of 'SA', 'LA', 'BE', 'LM', 'SM', got {which!r}"
        )

    lobpcg_route = M is not None or preconditioner is not None
    if lobpcg_route and (accelerate or isinstance(A, AcceleratedOperator)):
        raise EigenexError(
            "accelerate=True cannot combine with M=/preconditioner= "
            "(the LOBPCG route consumes the operand directly)"
        )
    coo = _coo_operand(A)
    if accelerate and not isinstance(A, AcceleratedOperator):
        from ..sparse.accelerate import accelerate as _accelerate_fn

        A = _accelerate_fn(A, symmetric=True, device=device)
    if isinstance(A, AcceleratedOperator):
        if mesh is not None:
            return _eigsh_accelerated_mesh(
                A, k, which=which, sigma=sigma, tol=tol, max_subspace=max_subspace,
                max_restarts=max_restarts, seed=seed, inner_tol=inner_tol, refine=refine,
                v0=v0, coo=coo, mesh=mesh, matvec_mode=matvec_mode,
            )
        return _eigsh_accelerated(
            A, k, which=which, sigma=sigma, tol=tol, max_subspace=max_subspace,
            max_restarts=max_restarts, max_iterations=max_iterations, seed=seed,
            inner_tol=inner_tol, refine=refine, v0=v0, coo=coo,
        )

    op = _resolve_operand(A, device)
    n = op.shape[0]
    if op.shape[0] != op.shape[1]:
        raise EigenexError("eigsh requires a square operator")
    if which == "SM" and sigma is None:
        # smallest magnitude = pairs nearest 0: the shift-invert machinery
        # with sigma = 0 (scipy/ARPACK's own recommendation)
        sigma = 0.0

    if lobpcg_route:
        if v0 is not None:
            raise EigenexError("v0= is not supported on the LOBPCG (M=/preconditioner=) route")
        if sigma is not None or mesh is not None:
            raise EigenexError(
                "M=/preconditioner= (the LOBPCG route) cannot be combined "
                "with sigma= or mesh="
            )
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
        return _maybe_refine_hermitian(res, coo, refine)

    if mesh is not None:
        if v0 is not None:
            raise EigenexError(
                "v0= is not supported with mesh= (the drivers build padding-safe starts)")
        res = _eigsh_mesh(op, k, which=which, sigma=sigma, tol=tol,
                          max_subspace=max_subspace, max_restarts=max_restarts, seed=seed,
                          inner_tol=inner_tol, mesh=mesh, matvec_mode=matvec_mode,
                          block_shape=block_shape)
        return _maybe_refine_hermitian(res, coo, refine)

    if sigma is not None:
        # Shift-invert: pairs nearest sigma have the LARGEST |theta| of
        # (A - sigma I)^-1 -- theta can be large positive (lambda just above
        # sigma) or large negative (just below), so track BOTH spectral ends
        # and pick by |theta|.  The inner solve is MINRES: short recurrence,
        # no restart stagnation, and right for the indefinite (A - sigma I)
        # that any interior sigma produces.
        from .cg import shift_invert_operator

        si = shift_invert_operator(
            op, sigma, tol=_default_inner_tol(inner_tol, tol, op.dtype), solver="minres",
            max_iters=min(4 * n, 10000),
        )
        m = min(max_subspace or max(4 * k + 16, 32), n)
        kk = min(k, m // 2 - 1) if m // 2 - 1 > 0 else k
        both_ends = tuple(range(kk)) + tuple(range(-kk, 0))
        si_solver = LanczosEigenSolver(
            si,
            LanczosOptions(
                max_eigenvalues=2 * kk, eigenvalue_indices=both_ends, tolerance=tol,
                max_subspace=m, seed=seed,
            ),
        )
        if v0 is not None:
            si_solver.set_initial_vector(v0)
        res = si_solver.compute()
        theta = np.asarray(res.eigenvalues)
        nonzero = np.abs(theta) > 0
        lam_all = np.where(nonzero, float(np.real(sigma)) + 1.0 / np.where(nonzero, theta, 1.0),
                           np.inf)
        res = _select_nearest_sigma(res, lam_all, sigma, k)
        res = _check_true_residuals(res, op, "eigsh sigma (MINRES shift-invert)", tol)
        return _maybe_refine_hermitian(res, coo, refine)

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
    return _maybe_refine_hermitian(res, coo, refine)


def _eigsh_mesh(op, k, *, which, sigma, tol, max_subspace, max_restarts, seed, inner_tol,
                mesh, matvec_mode, block_shape) -> LanczosResult:
    """eigsh over a device mesh: the distributed thick-restart driver, the
    distributed shift-invert driver (CG with a MINRES rescue) with
    ``sigma``, and on a 2-axis mesh the single-controller solvers over the
    panel-grid operator."""
    from ..parallel.distributed import (
        DistributedShiftInvertLanczosEigenSolver,
        DistributedThickRestartLanczosEigenSolver,
    )
    from ..sparse.sym_bsr import SymBSRMatrix

    n = op.shape[0]
    bsr_op = _mesh_container(op, block_shape)
    two_axis = len(mesh.axis_names) >= 2
    if sigma is not None:
        inner_tol = _default_inner_tol(inner_tol, tol, op.dtype)
        m = min(max_subspace or max(4 * k + 16, 32), n)
        kk = min(k, m // 2 - 1) if m // 2 - 1 > 0 else k
        both_ends = tuple(range(kk)) + tuple(range(-kk, 0))
        options = LanczosOptions(max_eigenvalues=2 * kk, eigenvalue_indices=both_ends,
                                 tolerance=tol, max_subspace=m, seed=seed)
        if two_axis:
            # MINRES shift-invert over the R x C panel-grid operator under
            # the single-controller Lanczos
            from .cg import shift_invert_operator

            padded, op2 = _grid_operator(bsr_op, mesh)
            si2 = shift_invert_operator(op2, sigma, tol=inner_tol, solver="minres",
                                        max_iters=min(4 * n, 10000))
            solver = LanczosEigenSolver(si2, options)
            _safe_start(solver, n, padded.shape[0], op2.dtype, seed, op2.device)
            res = _truncate(solver.compute(), n)
            theta = np.asarray(res.eigenvalues)
            nz = np.abs(theta) > 0
            lam_all = np.where(nz, float(np.real(sigma)) + 1.0 / np.where(nz, theta, 1.0),
                               np.inf)
            label = "eigsh sigma+mesh 2d (MINRES shift-invert)"
        else:
            res = DistributedShiftInvertLanczosEigenSolver(
                bsr_op, mesh, options, axis_name=mesh.axis_names[0],
                matvec_mode=matvec_mode, sigma=float(np.real(sigma)), cg_tol=inner_tol,
            ).compute()
            res = _truncate(res, n)
            lam_all = np.asarray(res.eigenvalues)
            label = "eigsh sigma+mesh (CG/MINRES shift-invert)"
        res = _select_nearest_sigma(res, lam_all, sigma, k)
        return _check_true_residuals(res, op, label, tol)
    if isinstance(bsr_op, SymBSRMatrix):
        if matvec_mode == "allgather":
            matvec_mode = "sym_halo"  # half storage has exactly one mesh mode
        elif matvec_mode != "sym_halo":
            raise EigenexError("a SymBSRMatrix operand supports matvec_mode='sym_halo' only")
    indices, n_track, lm_post = _which_indices(which, k)
    m = min(max_subspace or max(6 * n_track + 32, 64), n)
    options = ThickRestartOptions(max_eigenvalues=n_track, eigenvalue_indices=indices,
                                  tolerance=tol, max_subspace=m, max_restarts=max_restarts,
                                  seed=seed)
    if two_axis:
        padded, op2 = _grid_operator(bsr_op, mesh)
        solver = ThickRestartLanczosEigenSolver(op2, options)
        _safe_start(solver, n, padded.shape[0], op2.dtype, seed, op2.device)
        res = solver.compute()
    else:
        res = DistributedThickRestartLanczosEigenSolver(
            bsr_op, mesh, options, axis_name=mesh.axis_names[0], matvec_mode=matvec_mode,
        ).compute()
    res = _truncate(res, n)
    return _postselect_lm(res, k) if lm_post else res


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


def _reordered(res: LanczosResult, lam, order) -> LanczosResult:
    """``res`` with the pairs ``order`` picks, eigenvalues taken from ``lam``."""
    vecs = res.eigenvectors[:, np.asarray(order).tolist()] if res.eigenvectors is not None else None
    return LanczosResult(
        eigenvalues=np.asarray(lam)[order],
        eigenvectors=vecs,
        iterations=res.iterations,
        converged=res.converged,
        termination=res.termination,
        trace=res.trace,
    )


def _postselect_lm(res: LanczosResult, k: int) -> LanczosResult:
    """Keep the k largest-|lambda| pairs of the both-ends tracked set,
    returned in ascending order (scipy eigsh convention)."""
    lam = np.asarray(res.eigenvalues)
    pick = np.argsort(-np.abs(lam), kind="stable")[:k]
    return _reordered(res, lam, pick[np.argsort(lam[pick])])


def _select_nearest_sigma(res: LanczosResult, lam_all, sigma, k: int) -> LanczosResult:
    """Keep the k pairs nearest sigma (ascending lambda order), dropping the
    rest of the tracked both-ends Ritz set."""
    pick = np.argsort(np.abs(lam_all - float(np.real(sigma))))[:k]
    return _reordered(res, lam_all, pick[np.argsort(lam_all[pick])])


def _maybe_refine_hermitian(res: LanczosResult, coo, refine) -> LanczosResult:
    if not refine:
        return res
    if coo is None:
        raise EigenexError("refine=True requires a COOMatrix operand")
    if res.eigenvectors is None:
        raise EigenexError("refine=True requires computed eigenvectors")
    from .refine import inverse_iteration_refine

    iters = int(refine) if not isinstance(refine, bool) else 2
    lam, X, _ = inverse_iteration_refine(coo, res.eigenvectors, res.eigenvalues, iters=iters)
    order = np.argsort(lam)
    return LanczosResult(
        eigenvalues=lam[order],
        eigenvectors=X[:, order],
        iterations=res.iterations,
        converged=res.converged,
        termination=res.termination,
        trace=res.trace,
    )


def _accelerated_v0(acc, v0, seed):
    """The start vector of a solve on ``acc.matrix``: the embedded ``v0``,
    or a random one that is zero on the padding rows.  Either way the
    Krylov space never leaves the embedded subspace, so no spurious pad
    eigenvalues enter the tracked set."""
    from ..sparse.accelerate import _padding_safe_v0

    if v0 is not None:
        return acc.embed(v0)
    return _padding_safe_v0(
        acc.n_work, acc.shape[0], acc.as_linear_operator().dtype, seed, acc.device
    )


def _eigsh_accelerated(
    acc, k, *, which, sigma, tol, max_subspace, max_restarts, max_iterations,
    seed, inner_tol, refine, v0, coo,
) -> LanczosResult:
    """eigsh route for an :class:`AcceleratedOperator`: solve over the
    permuted+padded block container, restore eigenvectors to original
    coordinates, and (for complexified operands) collapse the doubled
    spectrum of the real embedding."""
    # complexified: every eigenvalue of H appears (up to) twice in the
    # real embedding -- track 2k and dedup after restoring
    mult = 2 if acc.complexified else 1
    res = eigsh(
        acc.matrix, mult * k, which=which, sigma=sigma, tol=tol,
        max_subspace=max_subspace, max_restarts=max_restarts,
        max_iterations=max_iterations, seed=seed, inner_tol=inner_tol,
        v0=_accelerated_v0(acc, v0, seed),
    )
    return _restore_accelerated(res, acc, k, refine, coo)


def _eigsh_accelerated_mesh(
    acc, k, *, which, sigma, tol, max_subspace, max_restarts, seed, inner_tol,
    refine, v0, coo, mesh, matvec_mode,
) -> LanczosResult:
    """eigsh for an :class:`AcceleratedOperator` UNDER a device mesh -- the
    composition of the RCM + half-storage pack (``accelerate=``) and the
    row-partitioned iteration (``mesh=``), the route for operators past one
    card's memory (BASELINE config 5b).  The packed SymBSRMatrix rides the
    sym_halo ring; a multi-axis mesh is flattened.  The pack may stay in
    host memory (``AcceleratedOperator.load(path, device="cpu")``): each
    process places only its own shards' panels.  The start vector is zero
    on both padding kinds (accelerate's block pad and the mesh row pad), and
    eigenvectors restore through the permutation as on one device."""
    from ..parallel.distributed import (
        DistributedShiftInvertLanczosEigenSolver,
        DistributedThickRestartLanczosEigenSolver,
        _padding_safe_v0,
        prepare_packed_mesh,
    )

    mat = acc.block_matrix()
    mesh, matvec_mode = prepare_packed_mesh(mat, mesh, matvec_mode)
    axis = mesh.axis_names[0]
    if which == "SM" and sigma is None:
        sigma = 0.0
    mult = 2 if acc.complexified else 1
    n_work = acc.n_work
    dtype = acc.as_linear_operator().dtype

    def start_vector(padded_n: int):
        if v0 is not None:
            v0e = acc.embed(v0)
            if padded_n != v0e.shape[0]:
                out = torch.zeros((padded_n,), dtype=v0e.dtype, device=v0e.device)
                out[: v0e.shape[0]] = v0e
                v0e = out
            return v0e
        return _padding_safe_v0(n_work, padded_n, dtype, seed, mesh.first_device)

    if sigma is not None:
        inner_tol = _default_inner_tol(inner_tol, tol, dtype)
        m = min(max_subspace or max(4 * mult * k + 16, 32), n_work)
        kk = min(mult * k, m // 2 - 1) if m // 2 - 1 > 0 else mult * k
        both_ends = tuple(range(kk)) + tuple(range(-kk, 0))
        solver = DistributedShiftInvertLanczosEigenSolver(
            mat, mesh,
            LanczosOptions(max_eigenvalues=2 * kk, eigenvalue_indices=both_ends,
                           tolerance=tol, max_subspace=m, seed=seed),
            axis_name=axis, matvec_mode=matvec_mode, sigma=float(np.real(sigma)),
            cg_tol=inner_tol,
        )
        solver.set_initial_vector(start_vector(solver.bsr.shape[0]))
        res = _truncate(solver.compute(), acc.shape[0])
        res = _select_nearest_sigma(res, np.asarray(res.eigenvalues), sigma, mult * k)
        res = _check_true_residuals(res, acc.as_linear_operator(),
                                    "eigsh accelerate+mesh sigma", tol)
        return _restore_accelerated(res, acc, k, refine, coo)

    indices, n_track, lm_post = _which_indices(which, mult * k)
    m = min(max_subspace or max(6 * n_track + 32, 64), n_work)
    solver = DistributedThickRestartLanczosEigenSolver(
        mat, mesh,
        ThickRestartOptions(max_eigenvalues=n_track, eigenvalue_indices=indices,
                            tolerance=tol, max_subspace=m, max_restarts=max_restarts,
                            seed=seed),
        axis_name=axis, matvec_mode=matvec_mode,
    )
    solver.set_initial_vector(start_vector(solver.bsr.shape[0]))
    res = _truncate(solver.compute(), acc.shape[0])
    if lm_post:
        res = _postselect_lm(res, mult * k)
    return _restore_accelerated(res, acc, k, refine, coo)


def _restore_accelerated(res: LanczosResult, acc, k, refine, coo) -> LanczosResult:
    """Shared tail of the accelerated eigsh routes: eigenvectors back
    through the permutation, as a host array in original coordinates; the
    doubled spectrum of a complexified operand collapsed; optional
    refinement on the original COO.

    Pairs need not both converge (a clean Krylov space holds ONE vector
    per 2-D embedded eigenspace; duplicates enter only via restarts and
    rounding), so dedup goes by value-closeness AND vector overlap
    (:func:`~eigenex_tpu_torch.sparse.accelerate.dedup_embedded_pairs`).
    Any unit real vector alpha [Re v, Im v] + beta [-Im v, Re v] restores
    to the unit complex eigenvector (alpha + i beta) v, so one
    representative per group suffices."""
    lam = np.asarray(res.eigenvalues)
    vecs = acc.restore(res.eigenvectors) if res.eigenvectors is not None else None
    if acc.complexified:
        from ..sparse.accelerate import dedup_embedded_pairs

        keep = dedup_embedded_pairs(lam, vecs, keep_max=k)
        lam = lam[keep]
        if vecs is not None:
            vecs = vecs[:, keep]
            vecs = vecs / np.maximum(np.linalg.norm(vecs, axis=0), 1e-300)
    res2 = LanczosResult(
        eigenvalues=lam,
        eigenvectors=vecs,
        iterations=res.iterations,
        converged=res.converged,
        termination=res.termination,
        trace=res.trace,
    )
    return _maybe_refine_hermitian(res2, coo, refine)


@_request
@highest_f32_matmul()
def eigs(
    A,
    k: int = 6,
    *,
    which: str = "LM",
    sigma=None,
    tol: float | None = None,
    max_subspace: int | None = None,
    max_restarts: int = 100,
    seed: int = 0,
    inner_tol: float | None = None,
    mesh=None,
    matvec_mode: str = "allgather",
    block_shape: tuple[int, int] | None = None,
    refine: bool | int = False,
    v0=None,
    accelerate: bool = False,
    device=None,
):
    """k eigenpairs of a general operator, selected by ``which``.

    which: scipy ``eigs`` convention -- "LM" (largest magnitude, the
    default), "SM", "LR"/"SR" (real part), "LI"/"SI" (imaginary part).
    With ``sigma`` the selection applies to the shift-inverted spectrum
    theta = 1/(lambda - sigma), matching scipy: the default "LM" means
    nearest-sigma pairs; every outer matvec is then a GMRES solve
    (:func:`~eigenex_tpu_torch.solvers.gmres.shift_invert_operator_general`).
    inner_tol: GMRES target for ``sigma`` (default: 1e-2 of the outer
    tolerance).  refine: with a COOMatrix operand, polish the returned
    pairs with f64 complex inverse iteration
    (:func:`~eigenex_tpu_torch.solvers.refine.general_inverse_iteration_refine`).
    v0: initial Krylov vector (scipy parity; original-space for
    accelerated operands).  accelerate: repack a scalar-sparse operand
    through the RCM + block pipeline
    (:func:`eigenex_tpu_torch.sparse.accelerate.accelerate`, 32x128
    general blocks for a non-symmetric operator) and solve in permuted
    space.  COMPLEX general operators ride the same path through the real
    embedding [[A,-B],[B,A]]: the doubled spectrum {lambda} U {conj lambda}
    is reconstructed and deduped on restore, as in
    :func:`eigenex_tpu_torch.sparse.realify.eigs_realified`; ``sigma``
    must be real on that route (the embedding is real).
    mesh: a :class:`~eigenex_tpu_torch.parallel.mesh.Mesh` routes the
    iteration to the distributed Krylov-Schur driver (``sigma``: GMRES
    shift-invert over the mesh operator; a 2-axis mesh takes the panel
    grid); ``matvec_mode`` and ``block_shape`` as for :func:`eigsh`.
    device: as for :func:`eigsh`.

    Returns an :class:`~eigenex_tpu_torch.solvers.arnoldi.ArnoldiResult`:
    complex eigenvalues in ``which`` order, eigenvectors as a complex
    tensor on the solve's device (a host array on the accelerated routes).
    """
    from ..sparse.accelerate import AcceleratedOperator

    coo = _coo_operand(A)
    if accelerate and not isinstance(A, AcceleratedOperator):
        from ..sparse.accelerate import accelerate as _accelerate_fn

        A = _accelerate_fn(A, device=device)
    if isinstance(A, AcceleratedOperator):
        if A.complexified:
            if mesh is not None:
                raise EigenexError(
                    "eigs: a complexified accelerated operand cannot combine "
                    "with mesh= yet — run the real-embedding reconstruction "
                    "single-device, or shard the packed container manually"
                )
            return _eigs_accelerated_complex(
                A, k, which=which, sigma=sigma, tol=tol, max_subspace=max_subspace,
                max_restarts=max_restarts, seed=seed, inner_tol=inner_tol, refine=refine,
                v0=v0, coo=coo,
            )
        return _eigs_accelerated(
            A, k, which=which, sigma=sigma, tol=tol, max_subspace=max_subspace,
            max_restarts=max_restarts, seed=seed, inner_tol=inner_tol, refine=refine,
            v0=v0, coo=coo, mesh=mesh, matvec_mode=matvec_mode,
        )

    op = _resolve_operand(A, device)
    n = op.shape[0]
    if op.shape[0] != op.shape[1]:
        raise EigenexError("eigs requires a square operator")
    if which not in ("LM", "SM", "LR", "SR", "LI", "SI"):
        raise EigenexError(
            f"which must be one of 'LM','SM','LR','SR','LI','SI', got {which!r}"
        )
    m = min(max_subspace or max(4 * k + 24, 48), n)
    options = KrylovSchurOptions(
        max_eigenvalues=k, tolerance=tol, max_subspace=m, max_restarts=max_restarts,
        seed=seed, which=which,
    )
    if mesh is not None:
        if v0 is not None:
            raise EigenexError(
                "v0= is not supported with mesh= (the drivers build "
                "padding-safe starts)"
            )
        return _eigs_mesh(op, k, options, which=which, sigma=sigma, tol=tol,
                          inner_tol=inner_tol, seed=seed, mesh=mesh,
                          matvec_mode=matvec_mode, block_shape=block_shape, coo=coo,
                          refine=refine)
    if sigma is not None:
        si = shift_invert_operator_general(
            op, sigma, tol=_default_inner_tol(inner_tol, tol, op.dtype))
        ks = KrylovSchurArnoldiSolver(si, options)
        if v0 is not None:
            ks.set_initial_vector(v0)
        res = ks.compute()
        res.inner_stats = si.stats
        # theta already which-ordered by the solver (scipy: which applies to
        # the transformed spectrum theta = 1/(lambda - sigma)); back-transform
        res.eigenvalues = complex(sigma) + 1.0 / res.eigenvalues
        res = _check_true_residuals(res, op, "eigs sigma (GMRES shift-invert)", tol)
        return _maybe_refine_general(res, coo, refine, which, sigma)
    ks = KrylovSchurArnoldiSolver(op, options)
    if v0 is not None:
        ks.set_initial_vector(v0)
    res = ks.compute()
    return _maybe_refine_general(res, coo, refine, which)


def _eigs_mesh(op, k, options, *, which, sigma, tol, inner_tol, seed, mesh, matvec_mode,
               block_shape, coo, refine):
    """eigs over a device mesh: the distributed Krylov-Schur driver; with
    ``sigma`` a GMRES shift-invert whose every inner matvec runs over the
    mesh operator; on a 2-axis mesh the single-controller Krylov-Schur over
    the panel-grid operator."""
    from ..parallel.distributed import DistributedKrylovSchurArnoldiSolver, mesh_operator
    from ..parallel.distributed import pad_bsr_for_mesh

    n = op.shape[0]
    bsr_op = _mesh_container(op, block_shape)
    two_axis = len(mesh.axis_names) >= 2
    if sigma is not None:
        axis = mesh.axis_names[0]
        if two_axis:
            padded, mop = _grid_operator(bsr_op, mesh)
        else:
            padded = pad_bsr_for_mesh(bsr_op, mesh.shape[axis])
            mop = mesh_operator(padded, mesh, axis_name=axis, matvec_mode=matvec_mode)
        si = shift_invert_operator_general(
            mop, sigma, tol=_default_inner_tol(inner_tol, tol, op.dtype))
        solver = KrylovSchurArnoldiSolver(si, options)
        # padding adds eigenvalue -1/sigma to the shift-inverted operator; a
        # padding-supported start would chase that ghost
        _safe_start(solver, n, padded.shape[0], mop.dtype, seed, mop.device)
        res = solver.compute()
        res.inner_stats = si.stats
        res.eigenvalues = complex(sigma) + 1.0 / res.eigenvalues
        if res.eigenvectors is not None:
            res.eigenvectors = res.eigenvectors[:n]
        res = _check_true_residuals(res, op, "eigs sigma+mesh (GMRES shift-invert)", tol)
        return _maybe_refine_general(res, coo, refine, which, sigma)
    if two_axis:
        padded, op2 = _grid_operator(bsr_op, mesh)
        solver = KrylovSchurArnoldiSolver(op2, options)
        _safe_start(solver, n, padded.shape[0], op2.dtype, seed, op2.device)
        res = solver.compute()
    else:
        res = DistributedKrylovSchurArnoldiSolver(
            bsr_op, mesh, options, axis_name=mesh.axis_names[0], matvec_mode=matvec_mode,
        ).compute()
    return _maybe_refine_general(_truncate(res, n), coo, refine, which)


def _maybe_refine_general(res, coo, refine, which: str | None = None, sigma=None):
    """Refinement keeps the route's ordering: on the sigma routes ``which``
    applies to theta = 1/(lambda - sigma) (scipy), so the refined pairs are
    re-sorted by the same transformed key."""
    if not refine:
        return res
    if coo is None:
        raise EigenexError("refine=True requires a COOMatrix operand")
    if res.eigenvectors is None:
        raise EigenexError("refine=True requires computed eigenvectors")
    from .refine import general_inverse_iteration_refine

    iters = int(refine) if not isinstance(refine, bool) else 60
    lam, X, _ = general_inverse_iteration_refine(
        coo, res.eigenvectors, np.asarray(res.eigenvalues), iters=iters
    )
    if sigma is not None:
        with np.errstate(divide="ignore", invalid="ignore"):
            key_vals = 1.0 / (lam - complex(sigma))
    else:
        key_vals = lam
    order = np.argsort(_which_key(key_vals, which or "LM"), kind="stable")
    res.eigenvalues = lam[order]
    res.eigenvectors = X[:, order]
    return res


def _eigs_accelerated(
    acc, k, *, which, sigma, tol, max_subspace, max_restarts, seed, inner_tol,
    refine, v0, coo, mesh=None, matvec_mode="allgather",
):
    """eigs route for a (real) :class:`AcceleratedOperator`: solve over the
    permuted+padded block container with a padding-safe start, restore
    eigenvectors to original coordinates (host array).

    ``mesh``: the packed GENERAL container rides the distributed
    Krylov-Schur driver (allgather/halo/colsplit row partitions); a packed
    SYMMETRIC container uses the sym_halo ring.  Multi-axis meshes flatten."""
    if mesh is not None:
        from ..parallel.distributed import (
            DistributedKrylovSchurArnoldiSolver,
            _padding_safe_v0,
            prepare_packed_mesh,
        )

        if sigma is not None:
            raise EigenexError(
                "eigs: accelerate= with mesh= supports sigma=None for now "
                "(shift-invert over the packed mesh container: use eigsh "
                "for Hermitian operators, or the manual mesh_operator route)"
            )
        pack = acc.block_matrix()
        mesh, matvec_mode = prepare_packed_mesh(pack, mesh, matvec_mode)
        m = min(max_subspace or max(4 * k + 24, 48), acc.n_work)
        solver = DistributedKrylovSchurArnoldiSolver(
            pack, mesh,
            KrylovSchurOptions(max_eigenvalues=k, tolerance=tol, max_subspace=m,
                               max_restarts=max_restarts, seed=seed, which=which),
            axis_name=mesh.axis_names[0], matvec_mode=matvec_mode,
        )
        padded_n = solver.bsr.shape[0]
        if v0 is not None:
            v0e = acc.embed(v0)
            if padded_n != v0e.shape[0]:
                out = torch.zeros((padded_n,), dtype=v0e.dtype, device=v0e.device)
                out[: v0e.shape[0]] = v0e
                v0e = out
        else:
            v0e = _padding_safe_v0(acc.n_work, padded_n, acc.as_linear_operator().dtype,
                                   seed, acc.device)
        solver.set_initial_vector(v0e)
        res = solver.compute()
        if res.eigenvectors is not None:
            res.eigenvectors = acc.restore(res.eigenvectors[: acc.shape[0]])
        return _maybe_refine_general(res, coo, refine, which, sigma)
    res = eigs(
        acc.matrix, k, which=which, sigma=sigma, tol=tol,
        max_subspace=max_subspace, max_restarts=max_restarts, seed=seed,
        inner_tol=inner_tol, v0=_accelerated_v0(acc, v0, seed),
    )
    if res.eigenvectors is not None:
        res.eigenvectors = acc.restore(res.eigenvectors)
    return _maybe_refine_general(res, coo, refine, which, sigma)


def _eigs_accelerated_complex(
    acc, k, *, which, sigma, tol, max_subspace, max_restarts, seed, inner_tol,
    refine, v0, coo,
):
    """eigs for a COMPLEXIFIED (complex general) AcceleratedOperator.

    The packed container is the real embedding [[A,-B],[B,A]], whose
    spectrum is {lambda} U {conj lambda}.  Krylov-Schur runs in real
    arithmetic on the block kernels; each computed pair (theta, q)
    reconstructs the genuine A-pair as z = q_top + i q_bot (norm ~ sqrt(2)
    |c| for a genuine pair, ~0 for a mirror pair, whose A-pair is instead
    (conj theta, conj reconstruction)).  2k pairs are tracked so A's k best
    under ``which`` are among the embedded 2k (the conj mirrors can shadow
    at most k slots)."""
    from ..sparse.realify import _genuine_pairs

    if sigma is not None and abs(complex(sigma).imag) > 0:
        raise EigenexError(
            "eigs(accelerate=True) on a complex operator supports REAL "
            "sigma only (the iteration runs on the real embedding); for "
            "complex shifts use the scalar eigs_realified path"
        )
    n = acc.orig_shape[0]
    res = eigs(
        acc.matrix, min(2 * k, max(acc.n_work - 2, 1)), which=which,
        sigma=sigma, tol=tol, max_subspace=max_subspace,
        max_restarts=max_restarts, seed=seed, inner_tol=inner_tol,
        v0=_accelerated_v0(acc, v0, seed),
    )
    theta = np.asarray(res.eigenvalues, np.complex128)
    if res.eigenvectors is None:
        raise EigenexError("complexified eigs needs eigenvectors to split the embedding")
    Q = _host(res.eigenvectors).astype(np.complex128)  # (n_pad, p)
    op = acc.as_linear_operator()
    kept = _genuine_pairs(
        theta, Q, acc.restore,  # restore: q_top + i q_bot through the permutation
        # A z through the packed real embedding (embed realifies, permutes, pads)
        lambda z: acc.restore(op.matvec(acc.embed(z))), tol)
    lam_all = np.array([t[0] for t in kept], np.complex128)
    if sigma is not None:
        with np.errstate(divide="ignore", invalid="ignore"):
            keyv = 1.0 / (lam_all - complex(sigma))
    else:
        keyv = lam_all
    order = np.argsort(_which_key(keyv, which), kind="stable")[:k]
    res.eigenvalues = lam_all[order]
    res.eigenvectors = (
        np.stack([kept[i][1] for i in order], axis=1)
        if len(order)
        else np.zeros((n, 0), np.complex128)
    )
    return _maybe_refine_general(res, coo, refine, which, sigma)


def _gram_right_mv(op, x):  # G = A^H A
    return op.rmatvec(op.matvec(x))


def _gram_left_mv(op, x):  # G = A A^H
    return op.matvec(op.rmatvec(x))


def _pair_gram_right_mv(p, x):  # G = A^H A through two packed containers
    opA, opH = p
    return opH.matvec(opA.matvec(x))


def _pair_gram_left_mv(p, x):  # G = A A^H
    opA, opH = p
    return opA.matvec(opH.matvec(x))


def _gram_solver(g, k: int, dim: int, dim_pad: int, *, tol, max_subspace, max_restarts,
                 seed, vectors: bool):
    """The Hermitian solver of the Gram operator ``g`` (its k largest
    pairs): plain Lanczos when the subspace covers the ``dim`` unpadded
    coordinates, thick-restart Lanczos otherwise.  ``dim_pad`` > ``dim``
    leaves room for the padding, which a padding-safe start never enters."""
    m = min(max_subspace or max(4 * k + 16, 32), dim)
    indices = tuple(range(-k, 0))  # largest Ritz values of G
    if m >= dim:
        return LanczosEigenSolver(g, LanczosOptions(
            max_eigenvalues=k, eigenvalue_indices=indices, tolerance=tol,
            max_subspace=min(dim_pad, m + (dim_pad - dim)), seed=seed,
            compute_eigenvectors=vectors))
    return ThickRestartLanczosEigenSolver(g, ThickRestartOptions(
        max_eigenvalues=k, eigenvalue_indices=indices, tolerance=tol, max_subspace=m,
        max_restarts=max_restarts, seed=seed, compute_eigenvectors=vectors))


def _descending(res):
    """(sigma descending as a host array, the Gram eigenvectors in that
    order) of a Gram solve."""
    theta = np.maximum(np.asarray(res.eigenvalues)[::-1], 0.0)
    s = np.sqrt(theta)
    W = res.eigenvectors.flip(1) if res.eigenvectors is not None else None
    return s, W


def _safe(s: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """sigma with zeros replaced by 1, to divide by, on ``like``'s device."""
    return torch.as_tensor(np.where(s > 0, s, 1.0)).to(device=like.device, dtype=like.dtype)


@_request
@highest_f32_matmul()
def svds(
    A,
    k: int = 6,
    *,
    tol: float | None = None,
    max_subspace: int | None = None,
    max_restarts: int = 200,
    seed: int = 0,
    return_singular_vectors: bool = True,
    mesh=None,
    matvec_mode: str = "allgather",
    block_shape: tuple[int, int] | None = None,
    accelerate: bool = False,
    device=None,
):
    """Top-``k`` singular triplets of a sparse or matrix-free operator --
    the scipy.sparse.linalg.svds-style front end.

    Runs Hermitian Lanczos (plain or thick-restart) on the smaller-side
    Gram operator G = A^H A or A A^H without forming G (two matvecs an
    application; BASELINE config 4's route for any operator, cf.
    :func:`eigenex_tpu_torch.ops.sparse_svd.truncated_svd_via_lanczos`).
    Needs an operand with an adjoint: a dense matrix, a COOMatrix, or a
    LinearOperator with ``rmatvec_fn``.

    Returns ``(U (nrows, k), s (k,) descending, Vh (k, ncols))``, or just
    ``s`` when ``return_singular_vectors=False``.  ``s`` is a host array; U
    and Vh are tensors on the solve's device, host arrays on the
    accelerated route.

    accelerate: repack the operand through
    :func:`eigenex_tpu_torch.sparse.accelerate.accelerate` first -- for a
    RECTANGULAR operator the bipartite-RCM two-sided permutation and a
    general 32x128 pack, so that both Gram matvecs (A, and A^H packed at
    the same block shape) run on the general SpMV kernel; an
    :class:`~eigenex_tpu_torch.sparse.accelerate.AcceleratedOperator`
    operand takes this route implicitly.  A complex square operand rides
    the real embedding, where every sigma appears twice.
    mesh: run both Gram matvecs (A, then A^H, each a row-partitioned mesh
    operator) over a :class:`~eigenex_tpu_torch.parallel.mesh.Mesh` --
    sparse operands only; rows and columns pad independently to the mesh,
    and a multi-axis mesh is flattened (``matvec_mode``, ``block_shape`` as
    for :func:`eigsh`).
    device: as for :func:`eigsh`."""
    from ..sparse.accelerate import AcceleratedOperator

    if accelerate and not isinstance(A, AcceleratedOperator):
        from ..sparse.accelerate import accelerate as _accelerate_fn

        A = _accelerate_fn(A, device=device)
    if isinstance(A, AcceleratedOperator):
        return _svds_accelerated(
            A, k, tol=tol, max_subspace=max_subspace, max_restarts=max_restarts,
            seed=seed, return_singular_vectors=return_singular_vectors,
            mesh=mesh, matvec_mode=matvec_mode,
        )

    op = _resolve_operand(A, device)
    if mesh is not None:
        return _svds_mesh(op, k, tol=tol, max_subspace=max_subspace,
                          max_restarts=max_restarts, seed=seed,
                          return_singular_vectors=return_singular_vectors, mesh=mesh,
                          matvec_mode=matvec_mode, block_shape=block_shape)
    if not op.has_adjoint:
        raise EigenexError(
            "svds requires an operator with an adjoint (rmatvec); dense "
            "matrices, COOMatrix, and LinearOperator(rmatvec_fn=...) all "
            "provide one"
        )
    nrows, ncols = op.shape
    small = min(nrows, ncols)
    if k > small:
        raise EigenexError(f"k={k} exceeds min(shape)={small}")
    use_right = ncols <= nrows
    dim = ncols if use_right else nrows
    g = LinearOperator(_gram_right_mv if use_right else _gram_left_mv, op, (dim, dim),
                       op.dtype, op.device)
    res = _gram_solver(g, k, dim, dim, tol=tol, max_subspace=max_subspace,
                       max_restarts=max_restarts, seed=seed,
                       vectors=return_singular_vectors).compute()
    s, W = _descending(res)
    if not return_singular_vectors:
        return s
    safe = _safe(s, W)
    if use_right:
        V = W
        U = op.matmat(V) / safe[None, :]
    else:
        U = W
        V = op.H.matmat(U) / safe.conj()[None, :]
    return U, s, V.conj().T


def _svds_mesh(op, k, *, tol, max_subspace, max_restarts, seed, return_singular_vectors,
               mesh, matvec_mode, block_shape):
    """svds with both Gram matvecs over a device mesh: A and A^H padded
    independently on both sides (``pad_bsr_rect``), each a row-partitioned
    mesh operator; a multi-axis mesh is flattened (the Gram pipeline is two
    RECTANGULAR 1-D row-partitioned products)."""
    from ..parallel.distributed import mesh_operator, pad_bsr_rect

    bsr_op = _mesh_container(op, block_shape)
    if len(mesh.axis_names) >= 2:
        mesh = mesh.flattened()
    axis = mesh.axis_names[0]
    padded = pad_bsr_rect(bsr_op, mesh.shape[axis])
    padH = padded.adjoint()
    opA = mesh_operator(padded, mesh, axis_name=axis, matvec_mode=matvec_mode)
    opH = mesh_operator(padH, mesh, axis_name=axis, matvec_mode=matvec_mode)
    nrows, ncols = op.shape  # the ORIGINAL (unpadded) problem
    small = min(nrows, ncols)
    if k > small:
        raise EigenexError(f"k={k} exceeds min(shape)={small}")
    use_right = ncols <= nrows
    dim = ncols if use_right else nrows
    dim_pad = padded.shape[1] if use_right else padded.shape[0]
    g = LinearOperator(_pair_gram_right_mv if use_right else _pair_gram_left_mv, (opA, opH),
                       (dim_pad, dim_pad), opA.dtype, opA.device)
    solver = _gram_solver(g, k, dim, dim_pad, tol=tol, max_subspace=max_subspace,
                          max_restarts=max_restarts, seed=seed,
                          vectors=return_singular_vectors)
    _safe_start(solver, dim, dim_pad, g.dtype, seed, g.device)
    s, W = _descending(solver.compute())
    if not return_singular_vectors:
        return s
    safe = _safe(s, W)
    if use_right:
        V = W
        U = opA.matmat(V) / safe[None, :]
    else:
        U = W
        V = opH.matmat(U) / safe.conj()[None, :]
    return U[:nrows], s, V[:ncols].conj().T


def _svds_accelerated(acc, k, *, tol, max_subspace, max_restarts, seed,
                      return_singular_vectors, mesh=None, matvec_mode="allgather"):
    """svds on an :class:`AcceleratedOperator`: Hermitian Lanczos on the
    smaller-side Gram operator of the PACKED container (two block matvecs an
    application, A and its adjoint pack), a padding-safe start, and a
    two-sided restore: left singular vectors through the row permutation,
    right ones through the column permutation.

    ``mesh``: both Gram matvecs (A and A^H, each its own pack) run
    row-partitioned over the mesh, padded to a common lcm(bm, bn) * shards
    grid so that the two chain exactly."""
    from ..sparse.accelerate import _padding_safe_v0, dedup_embedded_pairs

    if acc.complexified and acc.symmetric:
        raise EigenexError(
            "svds on a complexified HERMITIAN operator is redundant -- its "
            "singular values are |eigenvalues|; use eigsh"
        )
    if acc.complexified and mesh is not None:
        raise EigenexError(
            "svds: a complexified accelerated operand cannot combine with "
            "mesh= (the doubled-spectrum reconstruction is host-side)"
        )
    mult = 2 if acc.complexified else 1  # sigma(A) appears twice in the embedding
    mat = acc.matrix
    if mesh is not None:
        return _svds_accelerated_mesh(acc, k, tol=tol, max_subspace=max_subspace,
                                      max_restarts=max_restarts, seed=seed,
                                      return_singular_vectors=return_singular_vectors,
                                      mesh=mesh, matvec_mode=matvec_mode)
    opA = mat.as_linear_operator()
    # A^H packed at the same block shape, so both matvecs reach the kernel
    opH = opA if acc.adjoint_matrix() is mat else acc.adjoint_matrix().as_linear_operator()
    nrows, ncols = acc.orig_shape
    small = min(nrows, ncols)
    if k > small:
        raise EigenexError(f"k={k} exceeds min(shape)={small}")
    use_right = ncols <= nrows
    dim_work = acc.n_work if use_right else acc.m_work
    dim_pad = mat.shape[1] if use_right else mat.shape[0]
    g = LinearOperator(_pair_gram_right_mv if use_right else _pair_gram_left_mv, (opA, opH),
                       (dim_pad, dim_pad), opA.dtype, opA.device)
    kk = mult * k
    solver = _gram_solver(g, kk, dim_work, dim_pad, tol=tol, max_subspace=max_subspace,
                          max_restarts=max_restarts, seed=seed,
                          vectors=return_singular_vectors or mult == 2)
    if dim_pad != dim_work:
        solver.set_initial_vector(_padding_safe_v0(dim_work, dim_pad, g.dtype, seed, g.device))
    res = solver.compute()
    s, W = _descending(res)
    if not return_singular_vectors and mult == 1:
        return s
    safe = _safe(s, W)
    if acc.complexified:
        # the real embedding M = [[B,-C],[C,B]] of a general complex A holds
        # each sigma twice (its right space spans [Re v, Im v] and
        # [-Im v, Re v]); restore() rebuilds a valid complex vector from any
        # unit member, so a dedup by value and vector overlap keeps one
        # representative a sigma (square operand: one permutation)
        V = acc.restore(W)
        U = acc.restore(opA.matmat(W) / safe[None, :])
        keep = dedup_embedded_pairs(s, V, keep_max=k)
        s, V, U = s[keep], V[:, keep], U[:, keep]
        V = V / np.maximum(np.linalg.norm(V, axis=0), 1e-300)
        U = U / np.maximum(np.linalg.norm(U, axis=0), 1e-300)
        if not return_singular_vectors:
            return s
        return U, s, np.conj(V).T
    if use_right:
        V = acc.restore_right(W)
        U = acc.restore(opA.matmat(W) / safe[None, :])
    else:
        U = acc.restore(W)
        V = acc.restore_right(opH.matmat(W) / safe[None, :])
    return U, s, np.conj(V).T


def _svds_accelerated_mesh(acc, k, *, tol, max_subspace, max_restarts, seed,
                           return_singular_vectors, mesh, matvec_mode):
    """The mesh form of :func:`_svds_accelerated` on the operand's general
    block pack (``block_matrix()``) and that pack's adjoint."""
    from ..parallel.distributed import _padding_safe_v0, mesh_operator, prepare_packed_mesh
    from ..sparse.bsr import BSRMatrix

    if acc.symmetric:
        raise EigenexError(
            "svds(mesh=) on a SYMMETRIC accelerated operand is "
            "redundant — use eigsh(acc, mesh=...); the mesh Gram "
            "pipeline consumes general packs"
        )
    mat = acc.block_matrix()
    adj = mat.kernel_adjoint()
    mesh, matvec_mode = prepare_packed_mesh(mat, mesh, matvec_mode)
    axis = mesh.axis_names[0]
    nd = mesh.shape[axis]
    # A and A^H must chain exactly under the mesh: pad BOTH sides to the
    # common lcm(bm, bn) * nd grid (A's rows and A^H's cols are the same
    # dimension tiled by different block dims)
    bm, bn = mat.block_shape
    unit = int(np.lcm(bm, bn)) * nd

    def pad_to(b, M2, N2):
        add = (M2 - b.shape[0]) // b.block_shape[0]
        data, cols = b.data, b.block_cols
        if add:
            data = torch.cat([data, data.new_zeros((add,) + tuple(data.shape[1:]))])
            cols = torch.cat([cols, cols.new_zeros((add, cols.shape[1]))])
        return BSRMatrix(data, cols, (M2, N2))

    M2 = -(-mat.shape[0] // unit) * unit
    N2 = -(-mat.shape[1] // unit) * unit
    opA = mesh_operator(pad_to(mat, M2, N2), mesh, axis_name=axis, matvec_mode=matvec_mode)
    opH = mesh_operator(pad_to(adj, N2, M2), mesh, axis_name=axis,
                        matvec_mode=matvec_mode)
    nrows, ncols = acc.orig_shape
    small = min(nrows, ncols)
    if k > small:
        raise EigenexError(f"k={k} exceeds min(shape)={small}")
    use_right = ncols <= nrows
    dim_work = acc.n_work if use_right else acc.m_work
    dim_pad = N2 if use_right else M2
    g = LinearOperator(_pair_gram_right_mv if use_right else _pair_gram_left_mv, (opA, opH),
                       (dim_pad, dim_pad), opA.dtype, opA.device)
    m = min(max_subspace or max(4 * k + 16, 32), dim_work)
    solver = ThickRestartLanczosEigenSolver(g, ThickRestartOptions(
        max_eigenvalues=k, eigenvalue_indices=tuple(range(-k, 0)), tolerance=tol,
        max_subspace=m, max_restarts=max_restarts, seed=seed,
        compute_eigenvectors=return_singular_vectors))
    if dim_pad != dim_work:
        solver.set_initial_vector(_padding_safe_v0(dim_work, dim_pad, g.dtype, seed, g.device))
    s, W = _descending(solver.compute())
    if not return_singular_vectors:
        return s
    safe = _safe(s, W)
    if use_right:
        V = acc.restore_right(W[: mat.shape[1]])
        U = acc.restore((opA.matmat(W) / safe[None, :])[: mat.shape[0]])
    else:
        U = acc.restore(W[: mat.shape[0]])
        V = acc.restore_right((opH.matmat(W) / safe[None, :])[: mat.shape[1]])
    return U, s, np.conj(V).T


def _check_true_residuals(res, op, label: str, user_tol: float | None = None):
    """Post-hoc honesty check for the shift-invert routes: measure the true
    eigenpair residuals ||A v - lambda v|| on the ORIGINAL operator.

    A silently failed inner solve makes the outer iteration converge
    cleanly to eigenpairs of the wrong operator; the residual on A is the
    only signal.  The check costs one product with the eigenvector block
    (two, real and imaginary parts, for complex vectors on a real
    operator) and turns a failure into ``converged=False`` + an ERROR
    trace entry instead of wrong numbers."""
    from ..utils.tolerance import default_tolerance
    from ..utils.trace import Severity

    if res.eigenvectors is None:
        return res
    lam = np.asarray(res.eigenvalues)
    if lam.size == 0 or not np.all(np.isfinite(lam)):
        return res
    V = torch.as_tensor(res.eigenvectors).to(op.device)
    if V.is_complex() and not op.dtype.is_complex:
        AV = (_host(op.matmat(V.real.to(op.dtype).contiguous())).astype(np.complex128)
              + 1j * _host(op.matmat(V.imag.to(op.dtype).contiguous())))
    else:
        AV = _host(op.matmat(V.to(op.dtype)))
    Vn = _host(V)
    resid = np.linalg.norm(AV - Vn * lam[None, :], axis=0) / np.maximum(
        np.linalg.norm(Vn, axis=0), 1e-300
    )
    scale = max(float(np.max(np.abs(lam))), 1.0)
    rel = float(np.max(resid)) / scale
    # honour a LOOSER user-requested tolerance: a run converged to tol=1e-3
    # must not be flagged as an inner-solve failure by the dtype floor
    threshold = max(1e-6, 100.0 * default_tolerance(op.dtype))
    if user_tol is not None:
        threshold = max(threshold, 100.0 * float(user_tol))
    res.trace.log(
        Severity.INFO, f"{label}: max true eigenpair residual {rel:.3e} (relative)"
    )
    if not np.isfinite(rel) or rel > threshold:
        res.converged = False
        res.termination = "inner_solve_failure"
        res.trace.log(
            Severity.ERROR,
            f"{label}: true residual {rel:.3e} exceeds {threshold:.1e} -- the "
            "shift-invert inner solve failed; returned eigenpairs are unreliable",
        )
    return res
