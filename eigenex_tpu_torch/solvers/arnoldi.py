"""Arnoldi basis construction for general matrix-free operators.

Counterpart of the state, the chunk and ``arnoldi_steps`` of
``eigenex_tpu/solvers/arnoldi.py`` (the reference's ``ArnoldiBase``,
arnoldi.hpp:54, with its Hessenberg-building full Gram-Schmidt loop
:312-396).  Thick-restart Lanczos
(:mod:`eigenex_tpu_torch.solvers.restart`) is built on it: the per-step
masked CGS2 against the whole basis computes exactly the projected-matrix
column needed after a restart, where the three-term recurrence does not
hold.  ``ArnoldiEigenSolver`` itself is not ported yet.

Same execution model as :mod:`eigenex_tpu_torch.solvers.lanczos`:
preallocated ``(m+1, n)`` basis and ``(m+1, m)`` Hessenberg updated in
place, device flags for breakdown and failure, one host synchronisation
per chunk.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.operators import LinearOperator
from ..ops.orthogonalize import cgs2, norm_psum, project_out
from ..utils.exceptions import ArnoldiError
from ..utils.tolerance import default_breakdown_threshold, real_dtype_of
from .lanczos import _host_flags, _start_vector

__all__ = ["ArnoldiState", "arnoldi_steps", "init_arnoldi_state"]


@dataclasses.dataclass
class ArnoldiState:
    """Carried Arnoldi state (basis + Hessenberg; cf. arnoldi.hpp:190-206).
    The chunk updates ``V`` and ``H`` in place."""

    V: torch.Tensor  # (m+1, n) orthonormal basis rows
    H: torch.Tensor  # (m+1, m) Hessenberg
    k: torch.Tensor  # () int64 completed steps
    breakdown: torch.Tensor  # () bool
    residue: torch.Tensor  # () real -- ||w|| after last orthogonalisation (arnoldi.hpp:348)
    failed: torch.Tensor  # () bool -- NaN/Inf detected (numerical failure)

    def host_flags(self) -> tuple[int, bool, bool]:
        """``(k, breakdown, failed)`` on the host, in one transfer."""
        return _host_flags(self.k, self.breakdown, self.failed)


def init_arnoldi_state(
    op: LinearOperator,
    max_subspace: int,
    v0=None,
    *,
    seed: int = 0,
    deflate=None,
    breakdown_threshold: float | None = None,
) -> ArnoldiState:
    """cf. setInitialArnoldivector arnoldi.hpp:246-275."""
    n = op.shape[1]
    m = int(max_subspace)
    dev = op.device
    rdt = real_dtype_of(op.dtype)
    v0, nrm = _start_vector(op, v0, seed, deflate, breakdown_threshold, ArnoldiError)
    V = torch.zeros((m + 1, n), dtype=op.dtype, device=dev)
    V[0] = v0
    return ArnoldiState(
        V=V,
        H=torch.zeros((m + 1, m), dtype=op.dtype, device=dev),
        k=torch.zeros((), dtype=torch.int64, device=dev),
        breakdown=torch.zeros((), dtype=torch.bool, device=dev),
        residue=torch.as_tensor(nrm, dtype=rdt, device=dev),
        failed=torch.zeros((), dtype=torch.bool, device=dev),
    )


@torch.no_grad()
def _arnoldi_chunk(
    op: LinearOperator,
    state: ArnoldiState,
    shift,
    breakdown_threshold: float,
    deflate,
    *,
    k_start: int,
    num_steps: int,
) -> ArnoldiState:
    """The hot loop of updateArnoldiSteps (arnoldi.hpp:312-396): matvec +
    shift (:369-372), deflation (:373-375), full GS Hessenberg column
    (:377-384) via masked CGS2, residue (:348,385).

    ``k_start`` and the bound on ``num_steps`` come from the caller, as
    in the Lanczos chunk: step ``j`` works on row ``k_start + j`` for as
    long as neither device flag is set, and is a no-op afterwards."""
    V, H = state.V, state.H
    k, breakdown, failed, residue_prev = state.k, state.breakdown, state.failed, state.residue
    m = H.shape[1]
    dtype = V.dtype
    rdt = residue_prev.dtype
    dev = V.device
    row_ids = torch.arange(m + 1, device=dev)
    thr = torch.as_tensor(breakdown_threshold, dtype=rdt, device=dev)
    one = torch.ones((), dtype=rdt, device=dev)
    zero = torch.zeros((), dtype=rdt, device=dev)
    has_shift = not (isinstance(shift, (int, float, complex)) and shift == 0)

    for kh in range(int(k_start), int(k_start) + int(num_steps)):
        active = torch.logical_not(breakdown | failed)
        vk = V[kh]
        w = op.matvec(vk)
        if has_shift:
            w = w + shift * vk
        if deflate is not None:
            w = project_out(deflate, w)
        w, h_col = cgs2(V, w, mask=row_ids <= kh)
        if deflate is not None:
            # re-deflate after the O(1)-coefficient projection: it
            # reintroduces a deflate component proportional to the basis'
            # accumulated deflate drift, which otherwise grows
            # geometrically (cf. arnoldi.hpp:373-375)
            w = project_out(deflate, w)
        residue = norm_psum(w).to(rdt)
        # NaN/Inf guard (cf. the reference's residue-breakdown exits,
        # arnoldi.hpp:277-288): non-finite Hessenberg column or residue
        # means the matvec overflowed -- terminate, don't iterate garbage.
        failed_now = torch.logical_not(
            torch.isfinite(residue) & torch.all(torch.isfinite(h_col))
        )
        broke = torch.logical_not(failed_now) & (residue <= thr)
        ok = torch.logical_not(broke | failed_now)
        safe = torch.where(ok, residue, one)
        # the next row is zero on breakdown/failure and never read;
        # selection keeps NaNs out
        v_next = torch.where(ok, w / safe.to(dtype), torch.zeros_like(w))
        # column k of H: projection coefficients + subdiagonal residue
        h_col[kh + 1] = torch.where(ok, residue, zero).to(dtype)
        h_col = torch.where(failed_now, torch.zeros_like(h_col), h_col)
        # in-place writes (the JAX chunk's H.at[:, k].set / V.at[k+1].set);
        # an inactive step writes back what is already there
        H[:, kh] = torch.where(active, h_col, H[:, kh])
        V[kh + 1] = torch.where(active, v_next, V[kh + 1])
        k = k + (active & torch.logical_not(failed_now)).to(k.dtype)
        breakdown = breakdown | (active & broke)
        residue_prev = torch.where(active & torch.logical_not(failed_now), residue, residue_prev)
        failed = failed | (active & failed_now)

    return ArnoldiState(V=V, H=H, k=k, breakdown=breakdown, residue=residue_prev, failed=failed)


def arnoldi_steps(
    op: LinearOperator,
    state: ArnoldiState,
    num_steps: int,
    *,
    shift=0.0,
    breakdown_threshold: float | None = None,
    deflate=None,
) -> ArnoldiState:
    """Public fixed-step basis/Hessenberg routine (the ``ArnoldiBase``
    role, arnoldi.hpp:54-443).  Updates the tensors of ``state`` in place
    and returns a state that shares them; reads ``k`` once, before the
    chunk, and runs no step past the preallocated subspace."""
    if breakdown_threshold is None:
        breakdown_threshold = default_breakdown_threshold(op.dtype)
    m = state.H.shape[1]
    k_start = int(state.k)
    num_steps = max(min(int(num_steps), m - k_start), 0)
    if deflate is not None:
        deflate = torch.as_tensor(deflate).to(device=op.device, dtype=op.dtype)
    return _arnoldi_chunk(
        op,
        state,
        shift,
        float(breakdown_threshold),
        deflate,
        k_start=k_start,
        num_steps=num_steps,
    )
