"""The tail of one Arnoldi step in one launch on the card.

After the step's product, its CGS2 projection (the coefficients ``c`` of
``V[:kh + 1]``) and the norm of what is left (``residue``), the Arnoldi
chunk (:func:`~eigenex_tpu_torch.solvers.arnoldi._arnoldi_chunk_body`)
decides the step: a non-finite column or residue fails it, a residue at or
under the breakdown threshold breaks it down, an inactive step (one after a
breakdown or a failure) writes nothing; otherwise ``H[:, kh]`` takes the
column and ``V[kh + 1]`` the normalised row.  :func:`step_tail_plain` is
that tail in torch ops, about 40 launches a step on the card;
:func:`step_tail` takes CUDA tensors of a real f32 or f64 basis to the
kernel of ``csrc/arnoldi_step.cu``, one launch, with the same arithmetic
(bit-equal), and everything else to the plain version.  The kernel replaces
no Pallas kernel: XLA fuses the same tail inside the JAX package's jitted
chunk.

The step's new flags come back as new 0-d tensors, as from the plain
version; ``V`` and ``H`` are written in place.  The kernel is built and
loaded at its first launch (``cuda_spmv.build_kernels``); importing this
module builds nothing.  Its launches are not among the SpMV launch counts:
the chunk counts its fused steps as ``arnoldi.fused_steps``.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..utils.exceptions import EigenexError
from .cuda_spmv import _check_launch, _on_device, build_kernels

__all__ = ["fused", "step_tail", "step_tail_plain"]

#: basis dtype -> the ``dtype`` code of the C entry
_DTYPES = {torch.float32: 0, torch.float64: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_lock = threading.Lock()
_fn = None


def fused(V: torch.Tensor) -> bool:
    """Whether the steps of a chunk on basis ``V`` take the kernel."""
    return V.is_cuda and V.dtype in _DTYPES


def step_tail_plain(V, H, c, w, residue, threshold: float, kh: int, k, breakdown,
                    residue_prev, failed):
    """The step's tail in torch ops: writes ``H[:, kh]`` and ``V[kh + 1]``
    where the step is active, and returns its new ``(k, breakdown,
    residue_prev, failed)``.  ``threshold`` is the breakdown threshold."""
    m = H.shape[1]
    dtype = V.dtype
    rdt, dev = residue.dtype, residue.device
    thr = torch.full((), threshold, dtype=rdt, device=dev)
    one = torch.ones((), dtype=rdt, device=dev)
    zero = torch.zeros((), dtype=rdt, device=dev)
    active = torch.logical_not(breakdown | failed)
    # NaN/Inf guard (cf. the reference's residue-breakdown exits,
    # arnoldi.hpp:277-288): non-finite Hessenberg column or residue
    # means the matvec overflowed -- terminate, don't iterate garbage.
    failed_now = torch.logical_not(
        torch.isfinite(residue) & torch.all(torch.isfinite(c))
    )
    broke = torch.logical_not(failed_now) & (residue <= thr)
    ok = torch.logical_not(broke | failed_now)
    safe = torch.where(ok, residue, one)
    # the next row is zero on breakdown/failure and never read;
    # selection keeps NaNs out
    v_next = torch.where(ok, w / safe.to(dtype), torch.zeros_like(w))
    # column k of H: the kh + 1 projection coefficients, the
    # subdiagonal residue, zeros below
    h_col = torch.nn.functional.pad(c, (0, m - kh))
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
    return k, breakdown, residue_prev, failed


def step_tail(V, H, c, w, residue, threshold: float, kh: int, k, breakdown, residue_prev,
              failed):
    """:func:`step_tail_plain`, one launch of the kernel where
    :func:`fused` holds for ``V``."""
    if not fused(V):
        return step_tail_plain(V, H, c, w, residue, threshold, kh, k, breakdown, residue_prev,
                               failed)
    m = H.shape[1]
    n = V.shape[1]
    if V.stride(1) != 1 or H.stride(1) != 1 or not (c.is_contiguous() and w.is_contiguous()):
        raise EigenexError("arnoldi_step: V, H, c and w need contiguous rows")
    if not (c.dtype == w.dtype == residue.dtype == residue_prev.dtype == H.dtype == V.dtype):
        raise EigenexError("arnoldi_step: the step's tensors differ in dtype")
    k_out = torch.empty_like(k)
    breakdown_out = torch.empty_like(breakdown)
    residue_out = torch.empty_like(residue_prev)
    failed_out = torch.empty_like(failed)
    with _on_device(V.device) as stream:
        code = _entry()(
            w.data_ptr(), c.data_ptr(), residue.data_ptr(), V[kh + 1].data_ptr(),
            H[0, kh:].data_ptr(), H.stride(0), k.data_ptr(), breakdown.data_ptr(),
            residue_prev.data_ptr(), failed.data_ptr(), k_out.data_ptr(),
            breakdown_out.data_ptr(), residue_out.data_ptr(), failed_out.data_ptr(),
            n, kh, m, float(threshold), _DTYPES[V.dtype], stream,
        )
    _check_launch("arnoldi_step", code)
    return k_out, breakdown_out, residue_out, failed_out


def _entry():
    """The C entry point, built and loaded at the first launch."""
    global _fn
    if _fn is None:
        with _lock:
            if _fn is None:
                lib = ctypes.CDLL(str(build_kernels(["arnoldi_step"])["arnoldi_step"]))
                fn = lib.eigenex_arnoldi_step
                # w, c, residue, v_next, h, ldh, k, breakdown, residue_prev, failed, their
                # four outputs, n, kh, m, threshold, dtype, stream
                fn.argtypes = [_P] * 5 + [_I] + [_P] * 8 + [_I, _I, _I, ctypes.c_double, _I, _P]
                fn.restype = ctypes.c_int
                _fn = fn
    return _fn
