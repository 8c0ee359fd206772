"""String-labeled einsum / contraction DSL.

Counterpart of ``eigenex_tpu/ops/einsum.py`` (the reference's
include/cmpt/eigen_ex/einsum.hpp): the fluent
``contract(A, B).from_(iiA, iiB).to(iiR)`` fast path (:357-520), the
general ``einsum(A[, B]).from_(...).to(...)`` DSL (:550-741) supporting
traces, diagonals and contractions on one or two tensors, and the label
validity rules (:186-214, :791-849).

Every case compiles to one ``torch.einsum`` on the operands' device:
NumPy einsum semantics are a superset of the reference DSL (a label
repeated within an operand is a diagonal, a label absent from the output
is summed, shared labels contract).  Labels are arbitrary strings,
mapped to einsum letters internally.  The product runs at "highest" f32
matmul precision whatever the caller has set
(:func:`~eigenex_tpu_torch.utils.precision.highest_f32_matmul`).

``from`` is a Python keyword, so the method is ``from_`` (alias ``From``).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..utils.device import as_device_tensor
from ..utils.exceptions import EinsumError
from ..utils.precision import highest_f32_matmul

__all__ = ["einsum", "contract", "einsum_labels", "build_subscripts"]

_LETTERS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"


def build_subscripts(
    in_labels: Sequence[Sequence[str]], out_labels: Sequence[str]
) -> str:
    """Map arbitrary string labels to an einsum subscripts string."""
    mapping: dict[str, str] = {}

    def letter(lab: str) -> str:
        if lab not in mapping:
            if len(mapping) >= len(_LETTERS):
                raise EinsumError("too many distinct labels (>52)")
            mapping[lab] = _LETTERS[len(mapping)]
        return mapping[lab]

    ins = ["".join(letter(l) for l in labs) for labs in in_labels]
    out = "".join(letter(l) for l in out_labels)
    # validity: every output label must appear in some input
    in_set = {l for labs in in_labels for l in labs}
    for l in out_labels:
        if l not in in_set:
            raise EinsumError(f"output label {l!r} not present in inputs")
    if len(set(out_labels)) != len(tuple(out_labels)):
        raise EinsumError(f"repeated output label in {tuple(out_labels)}")
    return ",".join(ins) + "->" + out


def _validate_dims(tensors, in_labels):
    """Repeated labels must span equal dims (cf. einsum.hpp:791-849)."""
    dim_of: dict[str, int] = {}
    for t, labs in zip(tensors, in_labels):
        if t.ndim != len(labs):
            raise EinsumError(
                f"tensor of rank {t.ndim} given {len(labs)} labels {tuple(labs)}"
            )
        for d, l in zip(t.shape, labs):
            if l in dim_of and dim_of[l] != d:
                raise EinsumError(
                    f"label {l!r} spans unequal dims {dim_of[l]} and {d}"
                )
            dim_of[l] = d


def _operands(tensors, device=None) -> list[torch.Tensor]:
    """The operands as tensors of one dtype: tensors stay where they live
    (``device`` moves them); host arrays join the tensors' device, or go
    to ``device`` when no operand is a tensor."""
    if device is None:
        device = next((t.device for t in tensors if isinstance(t, torch.Tensor)), None)
    out = [as_device_tensor(t, device) for t in tensors]
    dtype = out[0].dtype
    for t in out[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return [t.to(dtype) for t in out]


@highest_f32_matmul()
def einsum_labels(tensors, in_labels, out_labels, device=None) -> torch.Tensor:
    """Functional core: einsum with string-label lists."""
    tensors = _operands(tensors, device)
    _validate_dims(tensors, in_labels)
    subs = build_subscripts(in_labels, out_labels)
    return torch.einsum(subs, *tensors)


class _From:
    """Stage after ``.from_`` -- call ``.to`` to compute
    (cf. FromImpl einsum.hpp:627-655)."""

    def __init__(self, tensors, in_labels, device):
        self._tensors = tensors
        self._in_labels = in_labels
        self._device = device

    def to(self, out_labels: Sequence[str]) -> torch.Tensor:
        return einsum_labels(self._tensors, self._in_labels, tuple(out_labels), self._device)


class _Einsum:
    """Entry object of ``einsum(...)`` (cf. EinsumImpl einsum.hpp:665-728)."""

    def __init__(self, tensors, device):
        self._tensors = tensors
        self._device = device

    def from_(self, *in_labels) -> _From:
        if len(in_labels) != len(self._tensors):
            raise EinsumError(
                f"{len(self._tensors)} tensors but {len(in_labels)} label lists"
            )
        return _From(self._tensors, tuple(tuple(l) for l in in_labels), self._device)

    # alias, since `from` is reserved in Python
    From = from_


def einsum(*tensors, device=None):
    """``einsum(A).from_(["i","i"]).to(["i"])`` -- diagonals, traces,
    contractions on 1 or 2 (or more) tensors
    (cf. factories einsum.hpp:731-741).  BlockTensor operands dispatch to
    the block-sparse implementation (cf. the BlockTensor ToImpl
    specializations block_tensor.hpp:2458,2717).  Tensor operands are
    used where they live; host arrays go to ``device`` (the card unless
    told otherwise) when no operand is a tensor."""
    from ..block.block_tensor import BlockTensor, block_einsum_entry

    if any(isinstance(t, BlockTensor) for t in tensors):
        return block_einsum_entry(tensors)
    return _Einsum(tensors, device)


class _ContractFrom:
    def __init__(self, a, b, labels_a, labels_b, device):
        self._a, self._b = a, b
        self._la, self._lb = labels_a, labels_b
        self._device = device

    def to(self, out_labels) -> torch.Tensor:
        # fast-path validity: each label count must be 0 or 2 overall for a
        # pure contraction (einsum.hpp:186-214); standard einsum validity is
        # required instead -- strictly more general, same results where both
        # are defined
        return einsum_labels((self._a, self._b), (self._la, self._lb), tuple(out_labels),
                             self._device)


class _Contract:
    def __init__(self, a, b, device):
        self._a, self._b = a, b
        self._device = device

    def from_(self, labels_a, labels_b) -> _ContractFrom:
        return _ContractFrom(self._a, self._b, tuple(labels_a), tuple(labels_b), self._device)

    From = from_


def contract(a, b, device=None) -> _Contract:
    """``contract(A, B).from_({"i","j"}, {"j","k"}).to({"i","k"})`` -- the
    two-tensor pure-contraction fast path (einsum.hpp:357-520); the same
    single ``torch.einsum`` as :func:`einsum`, so this is sugar."""
    from ..block.block_tensor import BlockTensor

    if isinstance(a, BlockTensor) or isinstance(b, BlockTensor):
        raise EinsumError("use BlockTensor.contract or einsum() for block tensors")
    return _Contract(a, b, device)
