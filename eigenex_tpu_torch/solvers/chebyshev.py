"""Chebyshev-filtered subspace iteration -- interior eigenpairs without
linear solves.

Counterpart of ``eigenex_tpu/solvers/chebyshev.py``.  The reference's
only interior-targeting tool is the eigenvalue shift
(lanczos.hpp:155,390-392), which can only push one spectral end;
shift-invert needs an inner linear solve per matvec.  The Chebyshev route
replaces the solve with a POLYNOMIAL of the operator: a Jackson-damped
Chebyshev expansion of the window's indicator function is close to 1
inside the window and close to 0 outside it.

One iteration = a degree-m three-term SpMM recurrence (a Python loop of
``op.matmat`` -- the SpMM kernel, which reads every stored block once for
the whole block of vectors) + one thin QR + one small Rayleigh-Ritz; no
inner CG/GMRES, and the host sees the device once per outer round.

Spectral bounds come from Gershgorin (``estimate_eigenvalue_range``,
triplets_matrix.hpp:512-540) or a short power probe; over-estimates only
weaken the filter, never break correctness.

``mesh=`` runs every SpMM of the filter chain row-partitioned over a
device mesh (:func:`mesh_filter_operand`, block-sparse operands), with
CholeskyQR2 for the panel orthonormalisation.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core.operators import LinearOperator, aslinearoperator
from ..utils.exceptions import LanczosError
from ..utils.precision import highest_f32_matmul
from ..utils.prng import make_generator, random_matrix
from ..utils.tolerance import default_tolerance, real_dtype_of
from ..utils.trace import ConvergenceTrace, Severity
from .lanczos import LanczosResult

__all__ = [
    "ChebyshevFilterOptions",
    "ChebyshevFilterSolver",
    "chebyshev_filter_apply",
    "chebyshev_bandpass_apply",
    "eigsh_window",
    "cholesky_qr2",
    "as_filter_operator",
]


def _mapped_apply(op: LinearOperator, lo, hi, dtype):
    """V -> t(A) V with t(A) = (2A - (hi+lo) I) / (hi - lo), the affine
    map of [lo, hi] onto [-1, 1]."""
    c = (hi + lo) / 2.0
    e = (hi - lo) / 2.0

    def t_apply(V):
        return (op.matmat(V).to(dtype) - c * V) / e

    return t_apply


@torch.no_grad()
def chebyshev_filter_apply(op: LinearOperator, X: torch.Tensor, lo, hi, *, degree: int):
    """Apply the degree-``m`` Chebyshev filter p_m(A) X that damps the
    spectral interval [lo, hi] onto Chebyshev's equi-oscillation region
    and amplifies everything outside it.

    Standard three-term recurrence on the affine-mapped operator:
        T_0 = X,  T_1 = t(A)X,  T_{k+1} = 2 t(A)T_k - T_{k-1}.
    All heavy work is ``op.matmat``.
    """
    t_apply = _mapped_apply(op, lo, hi, X.dtype)
    tkm1, tk = X, t_apply(X)
    for _ in range(degree - 1):
        tkm1, tk = tk, 2.0 * t_apply(tk) - tkm1
    return tk


def _bandpass_coefficients(alpha: float, beta: float, degree: int) -> np.ndarray:
    """Jackson-damped Chebyshev expansion coefficients of the indicator
    function of [alpha, beta] in [-1, 1] (the KPM/EVSL spectrum-slicing
    filter).  With t = cos(theta):  c_0 = (theta_a - theta_b)/pi,
    c_k = 2(sin k theta_a - sin k theta_b)/(k pi);  Jackson damping
    suppresses the Gibbs oscillation so the filter is ~1 inside the
    window and decays monotonically to ~0 outside."""
    th_a = float(np.arccos(np.clip(alpha, -1.0, 1.0)))
    th_b = float(np.arccos(np.clip(beta, -1.0, 1.0)))  # th_b <= th_a
    k = np.arange(1, degree + 1)
    c = np.empty(degree + 1)
    c[0] = (th_a - th_b) / np.pi
    c[1:] = 2.0 * (np.sin(k * th_a) - np.sin(k * th_b)) / (k * np.pi)
    M = degree
    g = (
        (M - k + 1) * np.cos(np.pi * k / (M + 1))
        + np.sin(np.pi * k / (M + 1)) / np.tan(np.pi / (M + 1))
    ) / (M + 1)
    c[1:] *= g
    return c


@torch.no_grad()
def chebyshev_bandpass_apply(op: LinearOperator, X: torch.Tensor, lam_min, lam_max, coeffs,
                             *, degree: int):
    """p(A) X for the degree-``m`` bandpass polynomial with Chebyshev
    coefficients ``coeffs`` on the spectrum mapped [lam_min, lam_max] ->
    [-1, 1]: accumulate sum_k c_k T_k(t(A)) X by the three-term recurrence
    -- one ``op.matmat`` per degree.  The coefficients stay on the host:
    each enters as a Python scalar."""
    t_apply = _mapped_apply(op, lam_min, lam_max, X.dtype)
    coeffs = np.asarray(coeffs, np.float64)
    tkm1, tk = X, t_apply(X)
    acc = float(coeffs[0]) * tkm1 + float(coeffs[1]) * tk
    for k in range(2, degree + 1):
        tkm1, tk = tk, 2.0 * t_apply(tk) - tkm1
        acc = acc + float(coeffs[k]) * tk
    return acc


@dataclasses.dataclass(frozen=True)
class ChebyshevFilterOptions:
    """Knobs for :class:`ChebyshevFilterSolver`.

    degree: filter polynomial degree per outer iteration (device cost =
    degree SpMMs); higher degree = sharper filter, fewer outer
    Rayleigh-Ritz rounds.
    spectral_bounds: (min, max) estimate of the FULL spectrum; None
    derives it from ``estimate_eigenvalue_range`` when the operand
    carries one, else from a short power probe.
    """

    degree: int = 20
    tolerance: float | None = None
    max_iterations: int = 100
    seed: int = 0
    compute_eigenvectors: bool = True
    spectral_bounds: tuple[float, float] | None = None


def _qr_orthonormalize(X):
    return torch.linalg.qr(X)[0]


def as_filter_operator(A, device=None) -> LinearOperator:
    """Coerce dense / LinearOperator / sparse-container operands -- the
    containers go through ``as_linear_operator()`` so their Gershgorin
    range stays reachable via ``op._params``.  ``device`` places a host
    operand (the card unless told otherwise)."""
    if hasattr(A, "as_linear_operator"):
        return A.as_linear_operator()
    return aslinearoperator(A, device=device)


@torch.no_grad()
def cholesky_qr2(X: torch.Tensor) -> torch.Tensor:
    """Orthonormalize a tall block by TWO rounds of (shifted) Cholesky QR
    -- only (b, b) Grams and right triangular solves touch the column
    dimension, so a row-partitioned X stays row-partitioned.  The second
    round restores orthogonality to working precision for the moderate
    condition numbers a filtered block has after its previous
    orthonormalization; a tiny trace-scaled ridge keeps the first
    Cholesky from failing on near-rank-deficient blocks."""

    def one(X):
        G = X.conj().T @ X
        b = G.shape[0]
        eps = torch.finfo(X.dtype).eps
        Gr = G.real if G.is_complex() else G
        ridge = 10.0 * b * eps * (torch.trace(Gr) / b + eps)
        L = torch.linalg.cholesky(G + ridge * torch.eye(b, dtype=G.dtype, device=G.device))
        # Q = X L^{-H}: right-side triangular solve, row-local in X
        return torch.linalg.solve_triangular(L.conj().T, X, upper=True, left=False)

    return one(one(X))


def _rr_stage(op: LinearOperator, Q):
    """Rayleigh-Ritz on an orthonormal block: H = Q^H A Q (+ AQ reused
    for residuals after rotation on host)."""
    AQ = op.matmat(Q).to(Q.dtype)
    return AQ, Q.conj().T @ AQ


def _rotate_stage(Q, AQ, Y, lam):
    """X = Q Y, R = (AQ) Y - X diag(lambda), residual norms."""
    X = Q @ Y
    R = AQ @ Y - X * lam[None, :]
    return X, torch.linalg.vector_norm(R, dim=0)


def _power_probe_norm(op: LinearOperator, seed: int):
    """(Rayleigh quotient, ||A v||) after 15 power steps from a seeded
    start: a cheap over-estimate of the spectral radius."""
    v = random_matrix(make_generator(seed), 1, op.shape[0], op.dtype, device=op.device)[0]
    for _ in range(15):
        v = op.matvec(v)
        v = v / torch.linalg.vector_norm(v)
    Av = op.matvec(v)
    rq = torch.vdot(v, Av)
    return float(rq.real if rq.is_complex() else rq), float(torch.linalg.vector_norm(Av))


class ChebyshevFilterSolver:
    """``k`` eigenpairs inside the window [s_lo, s_hi] of a Hermitian
    operator by bandpass-filtered subspace iteration.

    Each outer round applies the Jackson-damped Chebyshev BANDPASS
    polynomial of the window (~1 inside, decaying to ~0 outside -- the
    EVSL/KPM spectrum-slicing filter) to the block, re-orthonormalizes,
    and Rayleigh-Ritz-rotates; in-window Ritz pairs converge at the
    ratio of the filter values just outside vs inside the window, with
    ZERO linear solves -- every heavy device op is an ``op.matmat`` SpMM.
    """

    def __init__(
        self,
        operator=None,
        window: tuple[float, float] | None = None,
        options: ChebyshevFilterOptions | None = None,
        *,
        block_size: int = 8,
        initial_block=None,
        orthonormalize=None,
    ):
        self.operator = as_filter_operator(operator) if operator is not None else None
        self.window = window
        self.options = options or ChebyshevFilterOptions()
        self.block_size = int(block_size)
        #: start block override (n, block_size) -- the accelerated route
        #: uses a padding-supported block so zero-padded rows stay invariant
        self.initial_block = initial_block
        #: orthonormalization X -> Q override; default tall-skinny QR
        self.orthonormalize = orthonormalize or _qr_orthonormalize
        self.trace = ConvergenceTrace()
        self._result: LanczosResult | None = None

    def _spectral_bounds(self, op):
        o = self.options
        if o.spectral_bounds is not None:
            return float(o.spectral_bounds[0]), float(o.spectral_bounds[1])
        est = getattr(op, "_params", None)
        if est is not None and hasattr(est, "estimate_eigenvalue_range"):
            # sparse-container operand: Gershgorin bounds for free
            # (estimateEigenvalueRange triplets_matrix.hpp:512-540)
            lo, hi = est.estimate_eigenvalue_range()
            return float(lo), float(hi)
        # short power-iteration probe: cheap, safe to over-estimate
        # (Gershgorin-grade accuracy is enough); |lambda|max <= nrm bounds
        # both ends, widened by 5% for safety
        rq, nrm = _power_probe_norm(op, o.seed + 7)
        return -1.05 * max(nrm, abs(rq)), 1.05 * max(nrm, abs(rq))

    @highest_f32_matmul()
    @torch.no_grad()
    def compute(self, operator=None) -> LanczosResult:
        if operator is not None:
            self.operator = as_filter_operator(operator)
        op = self.operator
        if op is None:
            raise LanczosError("no operator set")
        if op.shape[0] != op.shape[1]:
            raise LanczosError(f"requires a square operator, got {op.shape}")
        if self.window is None:
            raise LanczosError("no target window set")
        s_lo, s_hi = float(self.window[0]), float(self.window[1])
        if not s_lo < s_hi:
            raise LanczosError(f"window must satisfy lo < hi, got {self.window}")
        o = self.options
        b = self.block_size
        n = op.shape[0]
        if b > n:
            raise LanczosError(f"block size {b} exceeds n={n}")
        dtype = op.dtype
        dev = op.device
        rdt = real_dtype_of(dtype)
        tol = o.tolerance if o.tolerance is not None else default_tolerance(dtype)
        lam_min, lam_max = self._spectral_bounds(op)
        # margin keeps the window strictly inside the damped complement
        span = lam_max - lam_min
        eps = 1e-12 * max(abs(lam_min), abs(lam_max), 1.0)
        self.trace = ConvergenceTrace()
        t0 = time.perf_counter()

        if self.initial_block is not None:
            if tuple(self.initial_block.shape) != (n, b):
                raise LanczosError(
                    f"initial_block must be (n, block_size) = ({n}, {b}), "
                    f"got {tuple(self.initial_block.shape)}"
                )
            X = torch.as_tensor(self.initial_block).to(device=dev, dtype=dtype)
        else:
            X = random_matrix(make_generator(o.seed), b, n, dtype, device=dev).T
        lam = np.zeros(b)
        scale = max(abs(lam_min), abs(lam_max), 1.0)
        termination = None
        converged = False
        it = 0
        rn_np = None
        prev_conv = None
        if s_lo - lam_min <= eps and lam_max - s_hi <= eps:
            raise LanczosError(
                f"window [{s_lo}, {s_hi}] covers the whole estimated "
                f"spectrum [{lam_min}, {lam_max}] -- use a direct eigensolver"
            )
        # map the window into the [-1, 1] image of the (slightly widened)
        # spectral range and build the bandpass coefficients once
        lo_m, hi_m = lam_min - 0.005 * span, lam_max + 0.005 * span
        ctr, ext = (hi_m + lo_m) / 2.0, (hi_m - lo_m) / 2.0
        coeffs = _bandpass_coefficients(
            (s_lo - ctr) / ext, (s_hi - ctr) / ext, o.degree
        )

        for it in range(1, o.max_iterations + 1):
            X = chebyshev_bandpass_apply(op, X, lo_m, hi_m, coeffs, degree=o.degree)
            Q = self.orthonormalize(X)
            AQ, H = _rr_stage(op, Q)
            Hh = H.cpu().numpy().astype(np.complex128 if H.is_complex() else np.float64)
            Hh = (Hh + Hh.conj().T) / 2
            if not np.all(np.isfinite(Hh)):
                termination = "numerical_failure"
                self.trace.log(
                    Severity.ERROR,
                    f"iteration {it}: non-finite projected matrix (filter "
                    "overflow -- reduce degree or widen bounds)",
                )
                break
            theta, Y = np.linalg.eigh(Hh)
            X, rn = _rotate_stage(
                Q, AQ,
                torch.as_tensor(Y).to(device=dev, dtype=dtype),
                torch.as_tensor(theta).to(device=dev, dtype=rdt),
            )
            lam = theta
            rn_np = rn.double().cpu().numpy()
            in_win = (theta >= s_lo) & (theta <= s_hi)
            self.trace.record(
                it, theta[in_win], float(rn_np.max()), time.perf_counter() - t0
            )
            # an unconverged BUFFER direction (a mix of eigenvectors from
            # both sides of the window) has a Rayleigh quotient inside the
            # window but a residual of the order of the mixed eigenvalue
            # spread -- a GHOST, not a converging pair.  Converged pairs
            # pass the tol test; a still-converging true pair sits in the
            # ambiguous band (tol, sqrt(tol)] * scale and we keep iterating;
            # residuals far above sqrt(tol) * scale are ghosts and are excused.
            scalev = scale + np.abs(theta)
            conv_m = in_win & (rn_np <= tol * scalev)
            ambiguous = in_win & ~conv_m & (rn_np <= np.sqrt(tol) * scalev)
            cur = theta[conv_m]
            if (
                cur.size
                and not np.any(ambiguous)
                and prev_conv is not None
                and cur.size == prev_conv.size
                and np.all(np.abs(cur - prev_conv) <= tol * scale)
            ):
                termination = "converged"
                converged = True
                break
            prev_conv = cur
        else:
            termination = "max_iterations"
            self.trace.log(
                Severity.WARN, f"stopped at max_iterations={o.max_iterations}"
            )

        # final selection: in-window pairs that actually converged (the
        # residual filter drops ghosts); on max_iterations fall back to
        # the sub-sqrt(tol) set so callers still see the best-effort pairs
        if rn_np is None:
            rn_np = np.full(b, np.inf)
        scalev = scale + np.abs(lam)
        conv_m = (lam >= s_lo) & (lam <= s_hi) & (rn_np <= tol * scalev)
        if not converged and not np.any(conv_m):
            conv_m = (lam >= s_lo) & (lam <= s_hi) & (rn_np <= np.sqrt(tol) * scalev)
        sel = np.nonzero(conv_m)[0]
        if sel.size == 0:
            self.trace.log(
                Severity.WARN,
                f"no Ritz values inside [{s_lo}, {s_hi}] after {it} "
                "iterations (window may be empty of spectrum)",
            )
            converged = False
        self._result = LanczosResult(
            eigenvalues=lam[sel],
            eigenvectors=(X[:, sel.tolist()] if o.compute_eigenvectors and sel.size else None),
            iterations=it,
            converged=converged,
            termination=termination,
            trace=self.trace,
        )
        return self._result


def _padding_safe_block(orig_n, padded_n, b, dtype, seed, device):
    """Random (padded_n, b) start block that is exactly zero on the pad
    rows beyond ``orig_n``."""
    X0 = random_matrix(make_generator(seed), b, orig_n, dtype, device=device).T
    if padded_n == orig_n:
        return X0
    out = torch.zeros((padded_n, b), dtype=X0.dtype, device=device)
    out[:orig_n] = X0
    return out


def mesh_filter_operand(A, mesh, matvec_mode, spectral_bounds, seed, use_pallas=False):
    """(mesh LinearOperator, orig_n, padded_n, bounds) shared by the
    mesh-aware Chebyshev/KPM front ends: pad the container for the mesh,
    take spectral bounds from the ORIGINAL operator (its Gershgorin -- the
    padding's eigenvalue 0 is never reached by a padding-supported start
    block), and build the global-array mesh operator for the SpMM chains."""
    from ..parallel.distributed import mesh_operator, mesh_operator_2d, pad_bsr_for_mesh
    from ..sparse.bsr import BSRMatrix
    from ..sparse.sym_bsr import SymBSRMatrix

    if not isinstance(A, (BSRMatrix, SymBSRMatrix)):
        raise LanczosError(
            "mesh= requires a block-sparse operand (BSRMatrix or "
            "SymBSRMatrix) so the operator's rows can be partitioned"
        )
    orig_n = A.shape[0]
    if spectral_bounds is not None:
        bounds = (float(spectral_bounds[0]), float(spectral_bounds[1]))
    else:
        lo, hi = A.estimate_eigenvalue_range()
        bounds = (float(lo), float(hi))
    axis = mesh.axis_names[0]
    if len(mesh.axis_names) >= 2:
        # 2-axis mesh: panel-grid operator (full-storage BSR only)
        if isinstance(A, SymBSRMatrix):
            raise LanczosError(
                "2-axis meshes use the panel-grid operator, which needs "
                "full-storage BSR — convert the SymBSRMatrix, or use a "
                "1-axis mesh with matvec_mode='sym_halo'"
            )
        nrc = mesh.shape[axis] * mesh.shape[mesh.axis_names[1]]
        padded = pad_bsr_for_mesh(A, nrc)
        return mesh_operator_2d(padded, mesh), orig_n, padded.shape[0], bounds
    padded = pad_bsr_for_mesh(A, mesh.shape[axis])
    op = mesh_operator(padded, mesh, axis_name=axis, matvec_mode=matvec_mode)
    return op, orig_n, padded.shape[0], bounds


@highest_f32_matmul()
def eigsh_window(
    A,
    window: tuple[float, float],
    *,
    block_size: int = 8,
    degree: int = 20,
    tol: float | None = None,
    max_iterations: int = 100,
    spectral_bounds: tuple[float, float] | None = None,
    seed: int = 0,
    mesh=None,
    matvec_mode: str = "allgather",
    use_pallas: bool | str = False,
    device=None,
) -> LanczosResult:
    """All eigenpairs of a Hermitian operator inside ``window`` (up to
    ``block_size`` of them) by Chebyshev-filtered subspace iteration --
    the solve-free alternative to ``eigsh(sigma=...)`` for interior
    windows.  ``block_size`` should exceed the expected eigenvalue count
    in the window by a few vectors of slack.

    An :class:`~eigenex_tpu_torch.sparse.accelerate.AcceleratedOperator`
    operand runs the filter over the permuted block container with a
    padding-safe start block and restores eigenvectors to original
    coordinates (complex Hermitian included: the block is doubled on the
    real embedding and the doubled window contents deduped).  ``device``
    places a host operand (the card unless told otherwise); containers and
    operators are used where they live.

    ``mesh``: a :class:`~eigenex_tpu_torch.parallel.mesh.Mesh` runs every
    SpMM of the filter chain row-partitioned over the mesh (block-sparse
    operands; ``matvec_mode`` as in the distributed Lanczos drivers) with
    CholeskyQR2 panel orthonormalisation.  ``use_pallas`` is accepted for
    the JAX package's signature."""
    from ..sparse.accelerate import AcceleratedOperator

    options = ChebyshevFilterOptions(
        degree=degree, tolerance=tol, max_iterations=max_iterations, seed=seed,
        spectral_bounds=spectral_bounds,
    )
    if isinstance(A, AcceleratedOperator):
        return _window_on_accelerated(A, window, options, block_size, mesh, matvec_mode)
    if mesh is None:
        return ChebyshevFilterSolver(
            as_filter_operator(A, device), window, options, block_size=block_size
        ).compute()
    op, orig_n, padded_n, bounds = mesh_filter_operand(A, mesh, matvec_mode, spectral_bounds,
                                                       seed)
    X0 = _padding_safe_block(orig_n, padded_n, block_size, op.dtype, seed, op.device)
    res = ChebyshevFilterSolver(
        op, window, dataclasses.replace(options, spectral_bounds=bounds),
        block_size=block_size, initial_block=X0, orthonormalize=cholesky_qr2,
    ).compute()
    if res.eigenvectors is not None and res.eigenvectors.shape[0] != orig_n:
        res.eigenvectors = res.eigenvectors[:orig_n]
    return res


def _window_on_accelerated(acc, window, options, block_size, mesh=None,
                           matvec_mode="allgather") -> LanczosResult:
    """eigsh_window for an AcceleratedOperator: permuted-space
    filter iteration with a padding-safe start block; eigenvectors
    restored to original coordinates as a host array.  A complexified
    operand (the real embedding of a complex Hermitian operator, which
    holds every eigenvalue twice) runs a block of ``2 * block_size`` and
    keeps one pair of each doubled one (by value and vector overlap),
    normalised.

    ``spectral_bounds=None`` lets the solver derive the bounds itself.
    The pads' zero eigenvalue may fall outside them, where |T_k| grows --
    harmless: the padding-safe start block has EXACTLY zero pad
    components and the structurally-zero pad rows keep them zero through
    every filter application.

    ``mesh``: the packed container is row-partitioned over the mesh
    (sym_halo ring for SymBSR storage; multi-axis meshes flatten), with
    CholeskyQR2 panel orthonormalisation."""
    from ..sparse.accelerate import dedup_embedded_pairs

    b = (2 if acc.complexified else 1) * block_size
    dtype = acc.as_linear_operator().dtype
    operand, padded_n, kwargs = acc.block_matrix(), acc.shape[0], {}
    if mesh is not None:
        from ..parallel.distributed import prepare_packed_mesh

        mesh, matvec_mode = prepare_packed_mesh(operand, mesh, matvec_mode)
        operand, _, padded_n, bounds = mesh_filter_operand(
            operand, mesh, matvec_mode, options.spectral_bounds, options.seed)
        options = dataclasses.replace(options, spectral_bounds=bounds)
        kwargs = dict(orthonormalize=cholesky_qr2)
    X0 = _padding_safe_block(acc.n_work, padded_n, b, dtype, options.seed, acc.device)
    res = ChebyshevFilterSolver(
        operand, window, options, block_size=b, initial_block=X0, **kwargs
    ).compute()
    if res.eigenvectors is not None and res.eigenvectors.shape[0] != acc.shape[0]:
        # mesh padding rows beyond the accelerate pad
        res.eigenvectors = res.eigenvectors[: acc.shape[0]]
    lam = np.asarray(res.eigenvalues)
    vecs = acc.restore(res.eigenvectors) if res.eigenvectors is not None else None
    if acc.complexified and lam.size:
        keep = dedup_embedded_pairs(lam, vecs)
        lam = lam[keep]
        if vecs is not None:
            vecs = vecs[:, keep]
            vecs = vecs / np.maximum(np.linalg.norm(vecs, axis=0), 1e-300)
    res.eigenvalues = lam
    res.eigenvectors = vecs
    return res
