"""Blocked orthogonalisation primitives.

Counterpart of ``eigenex_tpu/ops/orthogonalize.py``: the reference's
Gram-Schmidt machinery (``schmidt_orthogonalize`` util.hpp:400-417, the
per-step selective reorthogonalisation loop of Lanczos
lanczos.hpp:411-426, the full modified-GS of Arnoldi arnoldi.hpp:380-383)
as a pair of matrix-vector products -- classical Gram-Schmidt applied
**twice** (CGS2, "twice is enough": Giraud et al.).

The port's solver chunks run CGS2 over the live rows only: step ``k``
passes ``V[:k + 1]``, a view of the preallocated basis whose row count is
a host integer, so no pass reads the rows above ``k``.  The JAX chunks
pass the whole basis with a ``mask``, because their ``k`` is traced; the
``mask=`` argument stays here for that surface and for callers outside
the solvers.

These are plain ``V.conj() @ v`` products outside any hand-written
kernel and stay ``torch.mv``.  Their f32 grade follows the process-wide
``torch.set_float32_matmul_precision``: a caller's ``"high"`` would take
them in TF32 on the card, ``"medium"`` at bf16 grade.  So every front end
and every solver's ``compute()`` runs under
:func:`eigenex_tpu_torch.utils.precision.highest_f32_matmul`, which pins
``"highest"`` for the solve and gives the caller's setting back after it,
as the JAX package pins ``precision="highest"`` on these products.  A
caller who uses these primitives outside a solver gets its own setting.

Where the JAX version takes ``axis_name`` (the same code inside
``shard_map`` with the basis row-sharded), these take ``comm``: an
:class:`~eigenex_tpu_torch.parallel.shard_map.AxisComm` whose ``psum``
completes the local partial inner products over the mesh axis.  With
``comm=None`` they compute exactly what they compute on one device.
"""

from __future__ import annotations

import torch

from ..utils.device import as_device_tensor
from ..utils.profiling import annotate

__all__ = [
    "project_coefficients",
    "project_out",
    "cgs2",
    "gram_schmidt",
    "norm_psum",
    "orthonormal_columns",
    "orthogonal_complement",
    "orthogonal_complement_debug",
]


def _psum_if(x: torch.Tensor, comm) -> torch.Tensor:
    return comm.psum(x) if comm is not None else x


def norm_psum(v: torch.Tensor, comm=None) -> torch.Tensor:
    """2-norm of a (possibly row-sharded) vector, as a 0-d tensor of the
    real dtype."""
    if v.is_complex():
        return torch.sqrt(_psum_if(torch.sum(v.real**2 + v.imag**2), comm))
    return torch.sqrt(_psum_if(torch.sum(v**2), comm))


def project_coefficients(V: torch.Tensor, v: torch.Tensor, mask=None, *,
                         comm=None) -> torch.Tensor:
    """Inner products ``c_j = <V_j, v>`` for all basis rows at once.

    V: (k, n) basis rows; v: (n,).  One matrix-vector product instead of
    k sequential dots (replaces lanczos.hpp:414-416).  ``mask`` (k,)
    zeroes the coefficients of inactive basis rows -- by selection, not
    multiplication -- for fixed-shape solver loops where only rows <= k
    are valid."""
    c = _psum_if(torch.mv(V.conj(), v), comm)
    if mask is not None:
        c = torch.where(mask, c, torch.zeros_like(c))
    return c


def project_out(V: torch.Tensor, v: torch.Tensor, mask=None, *, comm=None) -> torch.Tensor:
    """One classical-GS pass: ``v - sum_j <V_j, v> V_j``."""
    c = project_coefficients(V, v, mask, comm=comm)
    return v - c @ V


def cgs2(V: torch.Tensor, v: torch.Tensor, mask=None, *, comm=None):
    """Two classical-GS passes -- the stable blocked replacement for the
    reference's selective reorthogonalisation (lanczos.hpp:411-426) and
    Arnoldi's full MGS (arnoldi.hpp:380-383).

    Returns ``(v_orth, c)`` where ``c`` is the **total** projection
    coefficient vector (sum of both passes) -- Arnoldi consumes it as the
    Hessenberg column, Lanczos reads alpha from it.  Runs under the span
    ``eigenex.cgs2``."""
    with annotate("eigenex.cgs2"):
        c1 = project_coefficients(V, v, mask, comm=comm)
        v = v - c1 @ V
        c2 = project_coefficients(V, v, mask, comm=comm)
        v = v - c2 @ V
        return v, c1 + c2


def gram_schmidt(vectors: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Orthonormalise a stack of row vectors in order
    (cf. schmidt_orthogonalize util.hpp:400-417), as the thin QR of the
    transposed stack.  Returns the orthonormalised rows (k, n)."""
    V = torch.as_tensor(vectors)
    q, r = torch.linalg.qr(V.T)  # (n, k), (k, k)
    if normalize:
        # sign-fix so each output vector has positive real diagonal in R,
        # making the result deterministic and GS-compatible
        d = torch.diagonal(r)
        mag = d.abs()
        phase = torch.where(mag > 0, d / torch.where(mag > 0, mag, torch.ones_like(mag)),
                            torch.ones_like(d))
        q = q * phase.conj()[None, :]
    return q.T


def orthonormal_columns(A, device=None) -> torch.Tensor:
    """Orthonormal basis (columns) for the column space of A via QR.

    A tensor is factored where it lives unless ``device`` names another
    place; host data goes to ``device``, the card unless told otherwise."""
    return torch.linalg.qr(as_device_tensor(A, device)).Q


def orthogonal_complement(V, n: int | None = None, device=None) -> torch.Tensor:
    """Orthonormal basis rows spanning the orthogonal complement of the
    span of the rows of V in C^n (cf. OrthogonalSpace util.hpp:419-471).

    V: (k, n) rows.  Returns (n - k, n) orthonormal rows r with
    ``r @ V.conj().T == 0``: the trailing columns of the complete QR of
    V^H -- the batched replacement for the reference's vector-at-a-time
    projection loop (util.hpp:437-462).  ``device`` as for
    :func:`orthonormal_columns`.
    """
    V = as_device_tensor(V, device)
    k = V.shape[0]
    q = torch.linalg.qr(V.conj().T, mode="complete").Q  # (n, n)
    return torch.conj_physical(q[:, k:]).T


def orthogonal_complement_debug(V, n: int | None = None, device=None):
    """Debug twin of :func:`orthogonal_complement` (cf.
    ``OrthogonalSpaceDebug`` util.hpp:473-514): returns
    ``(complement_rows, diagnostics)`` where diagnostics is a dict of the
    invariants the debug class checked, each a 0-d tensor --

    - ``max_overlap``: max |<r_i, V_j>| (must be ~0: complement orthogonal to span V)
    - ``orthonormality``: ||R R^H - I||_max over the returned rows
    - ``completeness``: ||[Vq; R][Vq; R]^H - I||_max with Vq an orthonormal
      basis of span V -- the two spaces together fill C^n
    """
    V = as_device_tensor(V, device)
    R = orthogonal_complement(V, n)
    Vq = gram_schmidt(V)
    k = R.shape[0]
    zero = torch.zeros((), dtype=R.real.dtype, device=R.device)
    overlap = (R @ V.conj().T).abs().max() if V.numel() and k else zero
    gram = R @ R.conj().T
    eye_k = torch.eye(k, dtype=gram.dtype, device=gram.device)
    orth = (gram - eye_k).abs().max() if k else zero
    full = torch.cat([Vq, R], dim=0)
    gf = full @ full.conj().T
    comp = (gf - torch.eye(gf.shape[0], dtype=gf.dtype, device=gf.device)).abs().max()
    return R, {
        "max_overlap": overlap,
        "orthonormality": orth,
        "completeness": comp,
    }
