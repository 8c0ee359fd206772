"""Matrix-free linear operators with a composition algebra.

Counterpart of ``eigenex_tpu/core/operators.py`` on torch tensors.

- The universal operator type of the reference is the raw callable
  ``MatMulFunction = std::function<void(const Scalar*, Scalar*)>``
  (lanczos.hpp:116, arnoldi.hpp:65, vector_map.hpp:43).  Here it is
  :class:`LinearOperator`: a function ``matvec(params, x) -> y`` paired
  with the object it closes over, plus the shape, dtype and device of
  the vectors it acts on.
- ``VectorMap``'s algebra -- ``(f+g)(x)=f(x)+g(x)``, ``(f*g)(x)=f(g(x))``,
  scalar multiples with zero short-circuit (vector_map.hpp:33-34,
  77-146, 192-263) -- maps to ``+``, ``@``/``*`` and scalar ``*`` below,
  with the dimension checks of ``setFromComposition``
  (vector_map.hpp:100-146).
- The eigenvalue shift (lanczos.hpp:155,390-392) is :meth:`LinearOperator.shifted`.

Where no ``rmatvec_fn`` was given, :meth:`LinearOperator.rmatvec` derives
the adjoint from the matvec by reverse-mode autograd, as the JAX package
does with ``jax.vjp``: on the card the block kernels' products are
autograd Functions whose backward is a launch of the same kernel
(:mod:`eigenex_tpu_torch.ops.cuda_spmv`), and on the CPU their plain
versions are torch ops.  The solvers run under ``torch.no_grad``; the
derivation enables grad for itself only.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.exceptions import OperatorError
from ..utils.tolerance import as_torch_dtype

__all__ = ["LinearOperator", "aslinearoperator", "identity_operator"]


def pullback(fn, cotangent: torch.Tensor, shape, dtype) -> torch.Tensor:
    """A^H ``cotangent`` for a linear ``fn`` (A v = ``fn(v)`` for v of
    ``shape`` and ``dtype``): the vector-Jacobian product at a zero leaf of
    this function's own, with ``cotangent`` as the output's gradient.

    PyTorch's backward of y = A v already returns A^H g for complex A, so
    unlike the JAX package's ``jax.vjp`` (which gives A^T and is wrapped in
    conjugates there) nothing is conjugated here.  ``torch.autograd.grad`` is
    used rather than ``torch.func.vjp`` because it differentiates any
    ``torch.autograd.Function`` as it is, the kernels' included.  Grad is
    enabled around the forward only, so the call works inside the solvers'
    ``no_grad``; the backward runs on the calling thread (not the autograd
    engine's device thread, which costs two thread hand-offs a call).  The
    result carries no graph, ``cotangent`` is left as it was, and the graph
    is freed on return.  Raises :class:`OperatorError` when the output does
    not depend on the input in autograd's graph (a product taken outside
    torch, e.g. through numpy): such an operator needs ``rmatvec_fn=``.
    """
    zero = torch.zeros(shape, dtype=dtype, device=cotangent.device, requires_grad=True)
    with torch.enable_grad():
        y = fn(zero)
    if not (isinstance(y, torch.Tensor) and y.requires_grad):
        raise OperatorError(
            "cannot derive the adjoint: the matvec's output does not depend on its "
            "input in autograd's graph (a product outside torch?); pass rmatvec_fn="
        )
    with torch.autograd.set_multithreading_enabled(False):
        (adj,) = torch.autograd.grad(y, zero, grad_outputs=cotangent.to(y.dtype))
    return adj


class LinearOperator:
    """A matrix-free linear operator ``y = A @ x``.

    Parameters
    ----------
    matvec_fn : callable ``(params, x) -> y``.
    params : whatever ``matvec_fn`` closes over (a container, a tensor,
        a tuple of operators, or None).
    shape : (m, n) -- output/input dimensions.
    dtype : torch dtype of the vectors the operator takes and returns.
    device : where those vectors live; ``None`` means the CUDA device,
        as for every constructor of the package.
    rmatvec_fn : optional ``(params, x) -> A^H @ x`` (adjoint).
    matmat_fn : optional fused ``(params, X) -> A @ X`` for (n, k) blocks.
    capturable : whether ``matvec`` may be captured into a CUDA graph: a
        product of torch ops and kernel launches on fixed tensors, with no
        host synchronisation and no host-side state a replay would skip
        (:mod:`eigenex_tpu_torch.solvers.chunk_graph`).  False unless the
        constructor says so; the block containers on CUDA say so.
    """

    def __init__(
        self,
        matvec_fn: Callable[[Any, torch.Tensor], torch.Tensor],
        params: Any,
        shape: tuple[int, int],
        dtype,
        device=None,
        rmatvec_fn: Callable | None = None,
        matmat_fn: Callable | None = None,
        capturable: bool = False,
    ):
        self._matvec_fn = matvec_fn
        self._params = params
        self.shape = (int(shape[0]), int(shape[1]))
        self.dtype = as_torch_dtype(dtype)
        self.device = resolve_device(device)
        self._rmatvec_fn = rmatvec_fn
        self._matmat_fn = matmat_fn
        self.capturable = bool(capturable)

    # -- application -----------------------------------------------------
    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self._matvec_fn(self._params, x)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.matvec(x)

    def rmatvec(self, x: torch.Tensor) -> torch.Tensor:
        """Adjoint action A^H @ x.

        Without an explicit ``rmatvec_fn`` the adjoint is derived from the
        (linear) ``matvec`` by reverse-mode autograd (:func:`pullback`).
        Cost: one forward application of the matvec plus one backward.  The
        reference's ``jit`` drops the unused forward; eager PyTorch cannot.
        """
        if self._rmatvec_fn is not None:
            return self._rmatvec_fn(self._params, x)
        return pullback(lambda v: self._matvec_fn(self._params, v), torch.as_tensor(x),
                        (self.shape[1],), self.dtype)

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        """Apply to an (n, k) block of column vectors."""
        if self._matmat_fn is not None:
            return self._matmat_fn(self._params, X)
        return torch.stack([self.matvec(X[:, j]) for j in range(X.shape[1])], dim=1)

    @property
    def has_adjoint(self) -> bool:
        """Whether an explicit ``rmatvec_fn`` was given; a derived adjoint
        does not count (``svds`` requires an explicit one)."""
        return self._rmatvec_fn is not None

    @property
    def H(self) -> "LinearOperator":
        """The adjoint operator (cf. TripletsMatrix::adjoint
        triplets_matrix.hpp:406); uses the derived adjoint when no
        explicit ``rmatvec_fn`` was given."""
        if self._rmatvec_fn is None:
            return LinearOperator(
                lambda op, v: op.rmatvec(v),
                self,
                (self.shape[1], self.shape[0]),
                self.dtype,
                self.device,
                rmatvec_fn=lambda op, v: op.matvec(v),
            )
        return LinearOperator(
            self._rmatvec_fn,
            self._params,
            (self.shape[1], self.shape[0]),
            self.dtype,
            self.device,
            rmatvec_fn=self._matvec_fn,
        )

    # -- algebra (cf. vector_map.hpp:226-289) ----------------------------
    def _coerce(self, other) -> "LinearOperator":
        return aslinearoperator(other, device=self.device)

    def __add__(self, other) -> "LinearOperator":
        other = self._coerce(other)
        if self.shape != other.shape:
            raise OperatorError(f"shape mismatch in operator sum: {self.shape} vs {other.shape}")
        return LinearOperator(
            _add_matvec,
            (self, other),
            self.shape,
            torch.promote_types(self.dtype, other.dtype),
            self.device,
            rmatvec_fn=_add_rmatvec if (self.has_adjoint and other.has_adjoint) else None,
        )

    def __sub__(self, other) -> "LinearOperator":
        return self + (-1.0) * self._coerce(other)

    def __neg__(self) -> "LinearOperator":
        return (-1.0) * self

    def __matmul__(self, other):
        """Composition: ``(A @ B)(x) = A(B(x))`` with the dimension check
        of setFromComposition (vector_map.hpp:100-146); ``A @ x`` on a
        1-D tensor applies the operator."""
        if isinstance(other, torch.Tensor) and other.ndim == 1:
            return self.matvec(other)
        other = self._coerce(other)
        if self.shape[1] != other.shape[0]:
            raise OperatorError(
                f"composition dim mismatch: {self.shape} cannot follow {other.shape}"
            )
        return LinearOperator(
            _compose_matvec,
            (self, other),
            (self.shape[0], other.shape[1]),
            torch.promote_types(self.dtype, other.dtype),
            self.device,
            rmatvec_fn=_compose_rmatvec if (self.has_adjoint and other.has_adjoint) else None,
        )

    def __mul__(self, c):
        """Scalar multiple, with the zero short-circuit of
        vector_map.hpp:192-203; ``A * B`` on operators composes, matching
        the reference's ``f*g`` (vector_map.hpp:33-34)."""
        if isinstance(c, LinearOperator):
            return self @ c
        return self.scaled(c)

    def __rmul__(self, c) -> "LinearOperator":
        return self.scaled(c)

    def scaled(self, c) -> "LinearOperator":
        if isinstance(c, (int, float, complex)) and c == 0:
            # zero short-circuit: drop the inner operator entirely
            # (cf. VectorMap::scalarMultiple vector_map.hpp:192-203)
            return LinearOperator(
                _zero_matvec, None, self.shape, self.dtype, self.device,
                rmatvec_fn=_zero_matvec,
            )
        return LinearOperator(
            _scale_matvec,
            (self, c),
            self.shape,
            self.dtype,
            self.device,
            rmatvec_fn=_scale_rmatvec if self.has_adjoint else None,
        )

    def shifted(self, sigma) -> "LinearOperator":
        """``A + sigma * I`` -- the eigenvalue shift the Krylov solvers
        apply per matvec (cf. lanczos.hpp:390-392)."""
        if self.shape[0] != self.shape[1]:
            raise OperatorError("shift requires a square operator")
        return LinearOperator(
            _shift_matvec,
            (self, sigma),
            self.shape,
            self.dtype,
            self.device,
            rmatvec_fn=_shift_rmatvec if self.has_adjoint else None,
        )


def _add_matvec(params, x):
    a, b = params
    return a.matvec(x) + b.matvec(x)


def _add_rmatvec(params, x):
    a, b = params
    return a.rmatvec(x) + b.rmatvec(x)


def _compose_matvec(params, x):
    a, b = params
    return a.matvec(b.matvec(x))


def _compose_rmatvec(params, x):
    a, b = params
    return b.rmatvec(a.rmatvec(x))


def _zero_matvec(_, x):
    return torch.zeros_like(x)


def _conj(c):
    return c.conjugate() if isinstance(c, complex) else c


def _scale_matvec(params, x):
    a, c = params
    return c * a.matvec(x)


def _scale_rmatvec(params, x):
    a, c = params
    return _conj(c) * a.rmatvec(x)


def _shift_matvec(params, x):
    a, s = params
    return a.matvec(x) + s * x


def _shift_rmatvec(params, x):
    a, s = params
    return a.rmatvec(x) + _conj(s) * x


def _dense_matvec(m, x):
    return m @ x


def _dense_rmatvec(m, x):
    return m.conj().T @ x


def _dense_matmat(m, X):
    return m @ X


def aslinearoperator(a, shape=None, dtype=None, device=None) -> LinearOperator:
    """Coerce a dense matrix, a callable or a LinearOperator into a
    LinearOperator (cf. VectorMap::setFromMatrix vector_map.hpp:153-163
    and setFromFunction :65-75).

    A tensor stays on its device unless ``device`` says otherwise; a
    numpy array or nested list goes to ``device`` (the card by default).
    """
    if isinstance(a, LinearOperator):
        return a
    if hasattr(a, "as_linear_operator"):
        return a.as_linear_operator()
    if callable(a):
        if shape is None or dtype is None:
            raise OperatorError("wrapping a callable requires explicit shape and dtype")
        return LinearOperator(lambda _, x: a(x), None, shape, dtype, resolve_device(device))
    if isinstance(a, torch.Tensor):
        m = a if device is None else a.to(device)
    else:
        m = torch.as_tensor(np.asarray(a)).to(resolve_device(device))
    if m.ndim != 2:
        raise OperatorError(f"expected a 2-D matrix, got shape {tuple(m.shape)}")
    return LinearOperator(
        _dense_matvec, m, tuple(m.shape), m.dtype, m.device,
        rmatvec_fn=_dense_rmatvec, matmat_fn=_dense_matmat,
    )


def _id_matvec(_, x):
    return x


def identity_operator(n: int, dtype=torch.float32, device=None) -> LinearOperator:
    return LinearOperator(
        _id_matvec, None, (n, n), dtype, resolve_device(device), rmatvec_fn=_id_matvec
    )
